"""Engine job execution (port of ``apex_studio_tpu/server/runner.py``,
counterpart of ray_tasks._run_engine_from_manifest_impl, reference
ray_tasks.py:2677): manifest → warm engine → run → outputs + previews.

Departures: ``device`` goes to every ``UniversalEngine`` built here (``None``
is the card; ``resolve_device`` raises without one; tests pass ``"cpu"``).
With ``APEX_STEP_TRACE=1`` the engine's acquisition from the warm pool (a
build on a miss) is traced as ``engine.acquire`` beside JAX's ``engine.run``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from apex_studio_tpu_torch.server.jobs import Job, JobCancelled
from apex_studio_tpu_torch.server.warm_pool import make_pool_key, warm_pool
from apex_studio_tpu_torch.server.ws import ws_manager
from apex_studio_tpu_torch.utils.defaults import get_results_path
from apex_studio_tpu_torch.utils.media import save_image, save_video
from apex_studio_tpu_torch.utils.profiling import step_trace

logger = logging.getLogger("apex.runner")

Device = Optional[Union[str, torch.device]]


def engine_results_dir() -> Path:
    d = get_results_path() / "engine_results"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _merge_inputs(config: Dict[str, Any], inputs: Dict[str, Any]) -> Dict[str, Any]:
    merged = dict((config.get("defaults") or {}).get("run") or {})
    merged.update({k: v for k, v in (inputs or {}).items() if v is not None})
    return merged


def persist_run_config(out_dir: Path, **payload: Any) -> Path:
    path = out_dir / "model_inputs.json"
    try:
        path.write_text(json.dumps(payload, indent=2, default=str))
    except OSError:
        logger.exception("failed to persist run config")
    return path


def replay_run(run_dir: Path, device: Device = None, **overrides: Any):
    """Re-execute a persisted run (the reference's captured-run fixture
    pattern, tests/engine/test_model.py): load model_inputs.json and run the
    engine with the same manifest + inputs on ``device``."""
    from apex_studio_tpu_torch.engine import UniversalEngine

    cfg = json.loads((Path(run_dir) / "model_inputs.json").read_text())
    engine = UniversalEngine(
        cfg["manifest_path"], selected_components=cfg.get("selected_components") or {},
        device=device,
    )
    inputs = _merge_inputs(engine.config, cfg.get("inputs") or {})
    inputs.update(overrides)
    inputs.setdefault("render_on_step", False)
    return engine, engine.run(**inputs)


def run_engine_job(
    job: Job,
    manifest_path: str,
    inputs: Dict[str, Any],
    selected_components: Optional[Dict[str, Any]] = None,
    folder_uuid: Optional[str] = None,
    device: Device = None,
) -> Dict[str, Any]:
    from apex_studio_tpu_torch.engine import UniversalEngine

    job_id = job.job_id
    ws_manager.send_update(job_id, 0.0, "Preparing engine", {"status": "processing"})

    def progress(p, message, metadata):
        if job.cancel_event.is_set():
            raise JobCancelled(job_id)
        ws_manager.send_update(job_id, p, message, metadata)

    pool_key = make_pool_key(manifest_path, selected_components or {})
    with step_trace("engine.acquire", {"job_id": job_id}):
        engine = warm_pool.acquire(
            pool_key,
            lambda: UniversalEngine(manifest_path, selected_components=selected_components,
                                    device=device),
        )

    out_dir = engine_results_dir() / (folder_uuid or job_id)
    out_dir.mkdir(parents=True, exist_ok=True)
    preview_index = {"n": 0}

    def render_preview(frames: List[np.ndarray], step: int) -> None:
        idx = preview_index["n"]
        preview_index["n"] += 1
        p = out_dir / f"preview_{idx:04d}.png"
        save_image(frames[0], p)
        rel = p.relative_to(engine_results_dir())
        ws_manager.send_update(
            job_id,
            None,
            f"Preview at step {step}",
            {
                "status": "preview",
                "preview_path": str(p),
                "preview_url": f"/files/engine_results/{rel}",
                "type": "image",
                "index": idx,
            },
        )

    kwargs = _merge_inputs(engine.config, inputs)
    kwargs.setdefault("render_on_step", True)
    kwargs["render_on_step_callback"] = render_preview
    kwargs["progress_callback"] = progress

    # Persist the run config next to the outputs — every run is a replayable
    # golden fixture (reference _persist_run_config, ray_tasks.py:792).
    persist_run_config(
        out_dir,
        manifest_path=manifest_path,
        inputs=inputs,
        selected_components=selected_components or {},
        job_id=job_id,
    )

    started = time.time()
    try:
        with step_trace("engine.run", {"job_id": job_id}):
            result = engine.run(**kwargs)
            if isinstance(result, torch.Tensor):  # return_latents: the host copy ends the card's work
                result = result.detach().float().cpu().numpy()
    except JobCancelled:
        ws_manager.send_update(job_id, None, "Job canceled", {"status": "canceled"})
        raise
    except Exception as e:
        ws_manager.send_update(
            job_id,
            None,
            f"Engine error: {e}",
            {"status": "error", "stage": "engine_run", "error_type": type(e).__name__,
             "error": str(e)},
        )
        raise
    finally:
        warm_pool.release(pool_key, engine)

    # Persist outputs.
    result_path: Optional[Path] = None
    out_type = "image"
    generated_audio = None
    if (isinstance(result, tuple) and len(result) == 3
            and isinstance(result[0], list)):
        # (frames, waveform, sample_rate) — audio-video engines (ltx2)
        frames_out, waveform, sr = result
        from apex_studio_tpu_torch.utils.media import save_wav

        generated_audio = save_wav(waveform, out_dir / "audio.wav", sr)
        result = frames_out
    if isinstance(result, list) and result and isinstance(result[0], np.ndarray):
        if len(result) == 1:
            result_path = save_image(result[0], out_dir / "output.png")
        else:
            out_type = "video"
            fps = float(kwargs.get("fps", 16.0))
            result_path = save_video(result, out_dir / "output.mp4", fps=fps)
            # Editor-optimize (+faststart, dense keyframes) and mux audio from
            # the source inputs when present (reference ray_tasks.py:410,2947).
            from apex_studio_tpu_torch.utils.media import editor_optimize_mp4

            audio_src = (str(generated_audio) if generated_audio
                         else inputs.get("audio") or inputs.get("video"))
            if os.environ.get("APEX_DISABLE_MP4_OPTIMIZE", "0") not in ("1", "true"):
                editor_optimize_mp4(result_path, audio_source=audio_src, fps=fps)
    elif result is not None:
        result_path = out_dir / "latents.npy"
        np.save(result_path, np.asarray(result))
        out_type = "latents"

    job.result_path = str(result_path) if result_path else None
    rel = result_path.relative_to(engine_results_dir()) if result_path else None
    ws_manager.send_update(
        job_id,
        1.0,
        "Complete",
        {
            "status": "complete",
            "result_path": job.result_path,
            "preview_url": f"/files/engine_results/{rel}" if rel else None,
            "type": out_type,
            "duration_s": round(time.time() - started, 2),
        },
    )
    return {"result_path": job.result_path, "type": out_type}
