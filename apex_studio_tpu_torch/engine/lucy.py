"""Lucy Edit (port of ``apex_studio_tpu/engine/lucy.py``): instruction-driven
video editing on the Wan 2.2 5B (ti2v) backbone. The whole source video is
VAE-encoded and concatenated along channels with the noise at every step (no
mask, no CLIP branch); UMT5 conditioning, the Wan flow samplers, CFG in f32
and the optional expert switch at ``boundary_ratio`` as in the Wan i2v
engine. Lucy-Edit-Dev's DiT takes 96 channels (48 noise + 48 source) and
returns 48, on the Wan 2.2 VAE (z 48, 16× in space).

Departure: a DiT whose output channels differ from the noise channels the
VAE leaves (``in_channels − z``) raises a ``ValueError`` before it runs;
``lucy-edit-dev.yml`` names the Wan 2.1 VAE (z 16) beside the 96-channel
DiT, on which the JAX engine fails in the scheduler step (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.engine.wan import WanShared, _is_path, _pixels, _resized
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress


@register_engine("lucy", "edit")
class LucyEditEngine(WanShared):
    @torch.inference_mode()
    def run(
        self,
        video: Any = None,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: int = 480,
        width: int = 832,
        num_frames: Optional[int] = None,
        duration: Optional[float] = None,
        fps: int = 24,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        guidance_scale_2: Optional[float] = None,
        boundary_ratio: Optional[float] = None,
        seed: Optional[int] = None,
        shift: Optional[float] = None,
        return_latents: bool = False,
        render_on_step: bool = False,
        render_on_step_callback: Optional[Callable] = None,
        render_on_step_interval: int = 3,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting edit pipeline")
        self.load_components(return_latents=False)
        if video is None:
            raise ValueError("lucy edit requires an input video")
        z_dim = self.vae.cfg.z_dim
        noise_c = self.transformer.cfg.in_channels - z_dim
        if noise_c != self.transformer.cfg.out_channels:
            raise ValueError(f"the DiT takes {self.transformer.cfg.in_channels} input channels and returns "
                             f"{self.transformer.cfg.out_channels}, but the VAE's {z_dim} latent channels leave "
                             f"{noise_c} for the noise: the manifest names another VAE than the DiT's (Lucy-Edit-Dev "
                             f"is 48 + 48 channels on the Wan 2.2 VAE)")
        if _is_path(video):
            from apex_studio_tpu_torch.preprocess.base import load_frames

            video = load_frames(video, max_frames=num_frames)
        frames_in = [self.load_image_input(np.asarray(f)) for f in video]
        s_scale, t_scale = self.vae.cfg.spatial_scale, self.vae.cfg.temporal_scale
        _, ph, pw = self.transformer.cfg.patch_size
        height -= height % (s_scale * ph)
        width -= width % (s_scale * pw)
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1 if duration else len(frames_in)
        num_frames = min(num_frames, len(frames_in))
        num_frames = max(1, num_frames - (num_frames - 1) % t_scale)
        condition = self.encode_video_latents(_pixels(_resized(frames_in[:num_frames], width, height,
                                                               cv2.INTER_LANCZOS4)))
        safe_emit_progress(progress_callback, 0.25, "Source video encoded")

        context = self.encode_prompt(prompt or "")
        use_cfg = guidance_scale > 1.0
        neg_context = self.encode_prompt(negative_prompt or "") if use_cfg else None
        lat_t, lat_h, lat_w = condition.shape[-3:]
        x = self.get_latents((1, noise_c, lat_t, lat_h, lat_w), seed=seed)
        safe_emit_progress(progress_callback, 0.3, "Initialized latent noise")

        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps,
                                   **({"shift": shift} if shift is not None else {}))
        boundary_timestep = self._boundary(boundary_ratio)
        if boundary_timestep is not None and self.transformer_2 is None:
            self._load_transformer_2()
        denoise_cb = make_mapped_progress(progress_callback, 0.35, 0.9)
        if len(ts) <= 8:
            render_on_step = False
        for i, t in enumerate(ts):
            transformer, g = self._expert(t, boundary_timestep, guidance_scale, guidance_scale_2)
            t_vec = torch.full((1,), float(t), dtype=torch.float32, device=self.device)
            v = self._apply(torch.cat([x, condition], dim=1), transformer, t_vec, context, neg_context,
                            float(np.float32(g)), use_cfg and g > 1.0, None)
            (x,) = self.scheduler.step(v, float(t), x)
            self._after_step(x, i, len(ts), render_on_step, render_on_step_callback, render_on_step_interval,
                             denoise_cb)

        safe_emit_progress(progress_callback, 0.9, "Denoising complete")
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self.decode_latents(x)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames
