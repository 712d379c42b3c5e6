"""HunyuanVideo Avatar engine: an audio-driven talking portrait (port of
``apex_studio_tpu/engine/hunyuanvideo_avatar.py``).

- the reference image, Lanczos-resized, repeated over one window's frames
  and VAE-encoded as ``ref_latents``;
- Whisper feature windows a pixel frame ([F, 10, 5, 384]: every encoder
  state stacked, four zero frames in front); the port has no Whisper
  encoder, so the features are zeros, which is what JAX computes where the
  manifest's ``audio_encoder`` has no files. Where files exist the port
  raises: the JAX engine loads them through ``transformers`` and, should
  that fail, logs and uses zeros;
- the clip padded to whole 32-latent-frame segments and denoised as windows
  of ``frame_per_batch`` latent frames whose start rolls by ``shift_offset``
  each step; each window's Euler update is summed per frame and divided by
  the frame's count (``counter``);
- dynamic guidance: the scale anneals linearly over the steps, and from
  step 10 on the negative branch takes the positive prompt (its audio stays
  zero);
- ``face_mask``, ``motion_exp`` and ``motion_pose`` pass to the DiT.

The text encoders load and encode first and are released before the
denoise, as the port's HunyuanVideo engines do.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import select_variant
from apex_studio_tpu_torch.engine.hunyuanvideo import HunyuanVideoShared
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.hunyuanvideo_avatar")


def encode_avatar_audio(num_frames: int, seq_len: int = 10, blocks: int = 5, channels: int = 384) -> np.ndarray:
    """The Whisper feature windows [F, seq_len, blocks, channels] without a
    Whisper encoder: zeros (the zero-initialised audio adapters of a
    published checkpoint then add nothing)."""
    return np.zeros((num_frames, seq_len, blocks, channels), np.float32)


@register_engine("hunyuanvideo", "avatar")
class HunyuanAvatarEngine(HunyuanVideoShared):
    def whisper_files(self):
        """The manifest's ``audio_encoder`` files on disk, or None."""
        spec = self.component_specs.get("audio_encoder")
        if spec is None or not spec.get("model_path"):
            return None
        variant = select_variant(spec.get("model_path"), None)
        return self._resolve_path(variant.get("path")) if variant else None

    def audio_features(self, audio: Any, num_frames: int) -> np.ndarray:
        """[F, seq_len, blocks, channels] in the DiT's geometry: a precomputed
        array as given, else the Whisper windows (zeros without its files)."""
        cfg = self.transformer.cfg
        want = (cfg.audio_seq_len, cfg.audio_blocks, cfg.audio_channels)
        if isinstance(audio, np.ndarray) and audio.ndim == 4:
            feats = audio.astype(np.float32)[:num_frames]
            if tuple(feats.shape[1:]) != want:
                raise ValueError(f"audio features of {feats.shape[1:]}; the DiT takes {want}")
        else:
            path = self.whisper_files() if audio is not None else None
            if path is not None:
                raise NotImplementedError(f"a Whisper encoder at {path}: the port has no Whisper encoder; "
                                          "pass the feature windows as an array")
            feats = encode_avatar_audio(num_frames, *want)
        if feats.shape[0] < num_frames:
            feats = np.concatenate([feats, np.zeros((num_frames - feats.shape[0], *want), np.float32)])
        return feats

    @torch.inference_mode()
    def run(
        self,
        image: Any = None,
        audio: Any = None,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: int = 512,
        width: int = 512,
        duration: Optional[float] = None,
        fps: float = 25.0,
        num_frames: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 3.5,
        dynamic_guidance_start: float = 3.5,
        dynamic_guidance_end: float = 6.5,
        frame_per_batch: int = 33,
        shift_offset: int = 10,
        face_mask: Any = None,
        motion_exp: Optional[List[float]] = None,
        motion_pose: Optional[List[float]] = None,
        seed: Optional[int] = None,
        shift: Optional[float] = None,
        return_latents: bool = False,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting Avatar pipeline")
        if image is None:
            raise ValueError("avatar requires a reference image")
        self.load_components()
        cfg_t, vae_cfg = self.transformer.cfg, self.vae.cfg
        s_scale, t_scale, p = vae_cfg.spatial_scale, vae_cfg.temporal_scale, cfg_t.patch_size
        height -= height % (s_scale * p)
        width -= width % (s_scale * p)
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        num_frames = max(1, num_frames - (num_frames - 1) % t_scale)
        audio_feats = self.audio_features(audio, num_frames)

        text, text_mask = self._encode_llama(prompt or "")
        pooled = self._encode_clip_pooled(prompt or "")
        use_cfg = negative_prompt is not None
        ntext, ntext_mask = self._encode_llama(negative_prompt or "") if use_cfg else (text, text_mask)
        npooled = self._encode_clip_pooled(negative_prompt or "") if use_cfg else pooled
        self.maybe_release_text_encoders()
        safe_emit_progress(progress_callback, 0.15, "Prompts encoded")

        resized = cv2.resize(self.load_image_input(image), (width, height), interpolation=cv2.INTER_LANCZOS4)
        frame = torch.from_numpy(resized.astype(np.float32) / 127.5 - 1.0).permute(2, 0, 1)[None, :, None]

        lat_h, lat_w = height // s_scale, width // s_scale
        n_pixel_audio = audio_feats.shape[0]
        # the clip padded to whole 32-latent-frame segments
        infer_length = (n_pixel_audio // (32 * t_scale) + 1) * 32 + 1
        video_px = n_pixel_audio // t_scale * t_scale + 1
        video_length = (video_px - 1) // t_scale + 1  # latent frames kept
        fpb = min(frame_per_batch, infer_length)
        if infer_length == fpb or video_length == fpb:
            infer_length, shift_offset = fpb, 0

        ref_lat = self.encode_video_latents(frame.expand(-1, -1, fpb * t_scale - (t_scale - 1), -1, -1)).float()
        pad_audio = (n_pixel_audio // 128 + 1) * 128 + 4 - n_pixel_audio
        audio_all = np.concatenate([audio_feats, np.zeros((pad_audio, *audio_feats.shape[1:]), np.float32)])

        dev = self.device
        fm = (torch.from_numpy(np.asarray(face_mask, np.float32)) if face_mask is not None
              else torch.ones(1, 1, 1, lat_h, lat_w))
        if fm.ndim == 2:
            fm = fm[None, None, None]
        fm = fm.to(dev)
        me = torch.tensor([motion_exp or [30.0] * 4], dtype=torch.float32, device=dev)
        mp = torch.tensor([motion_pose or [25.0] * 4], dtype=torch.float32, device=dev)
        fps_vec = torch.tensor([float(fps)], dtype=torch.float32, device=dev)

        latents_all = self.get_latents((1, vae_cfg.latent_channels, infer_length, lat_h, lat_w), seed=seed)
        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps,
                                   **({"shift": shift} if shift is not None else {}))
        sigmas = np.asarray(self.scheduler.sigmas, np.float64)
        tf = self.transformer
        rlat = ref_lat.to(tf.dtype)

        def forward(x, t_vec, txt, tmask, pl, aud):
            return tf(x.to(tf.dtype), t_vec, txt, tmask, pooled=pl, ref_latents=rlat, audio=aud, face_mask=fm,
                      motion_exp=me, motion_pose=mp, fps=fps_vec).float()

        cb = make_mapped_progress(progress_callback, 0.25, 0.9)
        roll, n_audio = 0, audio_all.shape[0]
        for i, t in enumerate(np.asarray(ts, np.float64)):
            pred = torch.zeros_like(latents_all)
            counter = np.zeros((infer_length,), np.float32)
            if i < 10:
                g = (1 - i / len(ts)) * (guidance_scale - 2) + 2
            else:
                g = (1 - i / len(ts)) * (dynamic_guidance_end - dynamic_guidance_start) + dynamic_guidance_start
            # from step 10 on the negative branch takes the positive prompt
            txt_n, tm_n, pl_n = (text, text_mask, pooled) if i >= 10 else (ntext, ntext_mask, npooled)
            t_vec = torch.full((1,), float(t), dtype=torch.float32, device=dev)
            dt = float(np.float32(sigmas[i + 1]) - np.float32(sigmas[i]))
            for index_start in range(0, infer_length, fpb):
                start = index_start - roll
                idx = np.array([ii % infer_length for ii in range(start, start + fpb)])
                aidx = np.array([min(ii % n_audio, n_audio - 1) for ii in range(start * 4, (start + fpb) * 4 - 3)])
                x_win = latents_all[:, :, torch.from_numpy(idx).to(dev)]
                aud = torch.from_numpy(audio_all[aidx])[None].to(dev)
                v = forward(x_win, t_vec, text, text_mask, pooled, aud)
                if use_cfg:
                    v_n = forward(x_win, t_vec, txt_n, tm_n, pl_n, torch.zeros_like(aud))
                    v = v_n + float(np.float32(g)) * (v - v_n)
                pred[:, :, torch.from_numpy(idx).to(dev)] += x_win + dt * v
                counter[idx] += 1
            latents_all = pred / torch.from_numpy(counter).to(dev)[None, None, :, None, None]
            roll = (roll + shift_offset) % fpb
            safe_emit_progress(cb, (i + 1) / len(ts), f"Denoising step {i + 1}/{len(ts)}")

        safe_emit_progress(progress_callback, 0.9, "Denoising complete")
        x = latents_all[:, :, :video_length]
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self.decode_latents(x)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames
