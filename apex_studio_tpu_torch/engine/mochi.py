"""Mochi-1 t2v engine, port of ``apex_studio_tpu/engine/mochi.py``.

- T5-XXL prompt features (256 tokens), the padded rows zeroed, with the
  attention mask forwarded to the DiT (the pooled caption needs it)
- the linear-quadratic sigma grid (threshold noise 0.025, n entries) on the
  flow-match Euler sampler
- CFG; the DiT predicts the NEGATED flow velocity, so the sign flips before
  the scheduler step
- latents [B, 12, (frames − 1)/6 + 1, H/8, W/8]: the causal 1 + 6k frame rule
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.schedulers.rectified_flow import linear_quadratic_schedule
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.mochi")


@register_engine("mochi", "t2v")
class MochiT2VEngine(BaseEngine):
    def load_components(self) -> None:
        self.load_missing("text_encoder", "transformer", "vae", "scheduler")

    def encode_prompt(self, prompt: str, max_sequence_length: int = 256):
        hidden, mask = self.text_encoder.encode([prompt], max_sequence_length=max_sequence_length,
                                                use_chat_template=False)
        mask = mask.float()
        return torch.where(mask[..., None].bool(), hidden.float(), torch.zeros((), device=hidden.device)), mask

    def decode_latents(self, z: torch.Tensor) -> List[np.ndarray]:
        video = self.vae.decode(z.float())
        b, c, t, h, w = video.shape
        return self.tensor_to_frames(video.transpose(1, 2).reshape(b * t, c, h, w))

    @torch.inference_mode()
    def run(self, prompt: Optional[str] = None, negative_prompt: Optional[str] = None, height: int = 480,
            width: int = 848, num_frames: int = 85, num_inference_steps: int = 64, guidance_scale: float = 4.5,
            threshold_noise: float = 0.025, seed: Optional[int] = None, latents: Optional[np.ndarray] = None,
            return_latents: bool = False, render_on_step: bool = False,
            render_on_step_callback: Optional[Callable] = None, render_on_step_interval: int = 3,
            progress_callback: Optional[Callable] = None, max_sequence_length: int = 256, **_: Any):
        safe_emit_progress(progress_callback, 0.0, "Starting t2v pipeline")
        self.load_components()

        vae_cfg = self.vae.cfg
        s_scale, t_scale = vae_cfg.spatial_scale, vae_cfg.temporal_scale
        tf = self.transformer
        p = tf.cfg.patch_size
        height -= height % (s_scale * p)
        width -= width % (s_scale * p)
        num_frames = max(1, num_frames - (num_frames - 1) % t_scale)
        lat_t = (num_frames - 1) // t_scale + 1
        lat_h, lat_w = height // s_scale, width // s_scale

        context, mask = self.encode_prompt(prompt or "", max_sequence_length)
        use_cfg = guidance_scale > 1.0
        neg_context = neg_mask = None
        if use_cfg:
            neg_context, neg_mask = self.encode_prompt(negative_prompt or "", max_sequence_length)
        safe_emit_progress(progress_callback, 0.2, "Prompts ready")

        x = self.get_latents((1, tf.cfg.in_channels, lat_t, lat_h, lat_w), seed=seed, latents=latents)
        sigmas = linear_quadratic_schedule(num_inference_steps, threshold_noise)
        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps, sigmas=list(sigmas))
        safe_emit_progress(progress_callback, 0.35, "Noise + timesteps ready")

        denoise_cb = make_mapped_progress(progress_callback, 0.35, 0.9)
        if len(ts) <= 8:
            render_on_step = False
        for i, t in enumerate(ts):
            t_vec = torch.full((1,), float(t), dtype=torch.float32, device=x.device)
            x_in = x.to(tf.dtype)
            v = tf(x_in, t_vec, context, encoder_attention_mask=mask)
            if use_cfg:
                v_neg = tf(x_in, t_vec, neg_context, encoder_attention_mask=neg_mask).float()
                v = v_neg + guidance_scale * (v.float() - v_neg)
            # the DiT predicts the negated velocity: flip it before the Euler step
            (x,) = self.scheduler.step(-v.float(), float(t), x)
            if (render_on_step and render_on_step_callback is not None and (i + 1) % render_on_step_interval == 0
                    and i + 1 < len(ts)):
                try:
                    render_on_step_callback(self.preview_frames(x, self.decode_latents), i)
                except Exception:
                    logger.exception("preview callback failed")
            if denoise_cb is not None:
                denoise_cb(min((i + 1) / len(ts), 1.0), f"Denoising step {i + 1}/{len(ts)}")

        safe_emit_progress(progress_callback, 0.9, "Denoising complete")
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self.decode_latents(x)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames
