"""Output encoding: frames → PNG / MP4 / WAV, and WAV input (port of
``apex_studio_tpu/utils/media.py``: counterpart of utils/ffmpeg.py +
save_audio_video.py in the reference; OpenCV replaces the ffmpeg binary)."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Sequence

import numpy as np

logger = logging.getLogger("apex.media")


def save_image(frame: np.ndarray, path: Path) -> Path:
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(frame).save(path)
    return path


def save_video(frames: Sequence[np.ndarray], path: Path, fps: float = 16.0) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        import cv2

        h, w = frames[0].shape[:2]
        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        writer = cv2.VideoWriter(str(path), fourcc, fps, (w, h))
        if not writer.isOpened():
            raise RuntimeError("cv2 VideoWriter failed to open")
        for f in frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
        return path
    except Exception:
        logger.exception("cv2 mp4 encode failed; falling back to imageio")
        import imageio

        imageio.mimsave(str(path), list(frames), fps=fps)
        return path


def editor_optimize_mp4(
    path: Path,
    audio_source: Path | str | None = None,
    fps: float = 16.0,
) -> Path:
    """Editor-optimize an mp4 in place: +faststart (moov up front so the
    editor can scrub before full download) and dense keyframes, muxing audio
    from ``audio_source`` when given — counterpart of the reference's output
    post-steps (``api/ray_tasks.py:410`` re-encode, ``:2947`` audio mux).

    No-op (with a log) when the ffmpeg binary is unavailable.
    """
    import shutil
    import subprocess
    import tempfile

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        logger.info("ffmpeg not available; skipping mp4 editor-optimize")
        return path
    path = Path(path)
    tmp = Path(tempfile.mkstemp(suffix=".mp4", dir=str(path.parent))[1])
    cmd = [ffmpeg, "-y", "-i", str(path)]
    if audio_source is not None and Path(str(audio_source)).exists():
        cmd += ["-i", str(audio_source), "-map", "0:v:0", "-map", "1:a:0?",
                "-c:a", "aac", "-shortest"]
    cmd += [
        "-c:v", "libx264", "-preset", "veryfast", "-crf", "18",
        "-pix_fmt", "yuv420p",
        "-g", str(max(int(round(fps)), 1)),  # a keyframe every second
        "-movflags", "+faststart",
        str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=600)
        tmp.replace(path)
    except Exception:
        logger.exception("mp4 editor-optimize failed; keeping original encode")
        tmp.unlink(missing_ok=True)
    return path


def save_wav(waveform, path, sample_rate: int = 24000):
    """(C, N) float waveform in [-1, 1] → 16-bit PCM wav (stdlib only)."""
    import wave

    arr = np.asarray(waveform, np.float32)
    if arr.ndim == 1:
        arr = arr[None]
    pcm = np.clip(arr, -1.0, 1.0).T  # (N, C)
    pcm = (pcm * 32767.0).astype("<i2")
    path = Path(path)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.tobytes())
    return path


def load_audio(source, sampling_rate: int = 16000) -> "np.ndarray":
    """Load mono audio as float32 [-1, 1] at ``sampling_rate``.

    Accepts a 1-D array (passthrough, assumed already at the target rate), or
    a .wav path/bytes (stdlib ``wave``; 16/32-bit PCM), resampled with linear
    interpolation. Counterpart of the reference's ``_load_audio``
    (engine/base_engine.py) without the librosa dependency.
    """
    import io as _io
    import wave as _wave

    if isinstance(source, np.ndarray):
        return np.asarray(source, np.float32).reshape(-1)
    if isinstance(source, (list, tuple)):
        return np.asarray(source, np.float32).reshape(-1)
    fh = _io.BytesIO(source) if isinstance(source, bytes) else str(source)
    with _wave.open(fh, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        ch = w.getnchannels()
        raw = w.readframes(n)
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[width]
    arr = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    arr /= float(np.iinfo(dtype).max)
    if ch > 1:
        arr = arr.reshape(-1, ch).mean(axis=1)
    if rate != sampling_rate and arr.size:
        t_out = np.linspace(0.0, arr.size - 1.0,
                            int(round(arr.size * sampling_rate / rate)))
        arr = np.interp(t_out, np.arange(arr.size), arr).astype(np.float32)
    return arr
