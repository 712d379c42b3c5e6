"""Bria FIBO text/image-to-image engine (port of ``apex_studio_tpu/engine/fibo.py``).

Prompts are structured JSON captions; a plain prompt rides through as it
is. The default negative prompt derives from the caption's ``style_medium``.
The SmolLM-class text encoder (``stack_layers``) gives every hidden layer:
``cat(layer[-1], layer[-2])`` is the base text stream and the layers feed
the DiT's per-block caption projections. Flow-match Euler with dynamic shift
and CFG over unpacked latent tokens, combined in the DiT's output dtype as
the JAX step does. The ``image`` input is accepted and unused, as in JAX.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Callable, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine, dynamic_shift_mu
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.fibo")


def default_negative_prompt(structured: dict) -> str:
    """Photographs get an anti-illustration negative."""
    style = str(structured.get("style_medium", "")).lower()
    if style in ("photograph", "photography", "photo"):
        return "{'style_medium':'digital illustration','artistic_style':'non-realistic'}"
    return ""


@register_engine("fibo", "ti2i", "t2i")
class FiboTI2IEngine(BaseEngine):
    def encode_prompt(self, prompt: str, max_sequence_length: int = 2048):
        """→ (embeds [1, L, 2·d], the layers [1, L, d] each, mask [1, L])."""
        self.load_missing("text_encoder")
        stacked, mask = self.text_encoder.encode([prompt or ""], max_sequence_length=max_sequence_length,
                                                 use_chat_template=False)
        d = self.transformer.cfg.text_encoder_dim
        layers = list(stacked.split(d, dim=-1))
        embeds = torch.cat([layers[-1], layers[-2] if len(layers) >= 2 else layers[-1]], dim=-1)
        return embeds, layers, mask

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        structured_prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        image: Optional[Any] = None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 30,
        guidance_scale: float = 5.0,
        seed: Optional[int] = None,
        max_sequence_length: int = 2048,
        return_latents: bool = False,
        progress_callback: Optional[Callable] = None,
        offload: bool = True,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting FIBO pipeline")
        self.load_missing("transformer", "vae", "scheduler")
        prompt = structured_prompt or prompt or ""
        structured: dict = {}
        try:
            structured = json.loads(prompt)
        except (TypeError, ValueError):
            pass  # a plain text prompt rides through unchanged
        if not negative_prompt:
            negative_prompt = default_negative_prompt(structured)

        embeds, layers, mask = self.encode_prompt(prompt, max_sequence_length)
        use_cfg = guidance_scale > 1.0
        neg = self.encode_prompt(negative_prompt or "", max_sequence_length) if use_cfg else None
        safe_emit_progress(progress_callback, 0.3, "Prompt encoded")

        tf = self.transformer
        s_scale = getattr(self.vae.cfg, "spatial_scale", None) or 16
        lat_h, lat_w = height // s_scale, width // s_scale
        z_dim = tf.cfg.in_channels
        noise = self.get_latents((1, z_dim, lat_h, lat_w), seed=seed)
        # no patch packing: [B, C, h, w] → [B, h·w, C]
        x = noise.reshape(1, z_dim, lat_h * lat_w).transpose(1, 2).contiguous()
        sigmas = np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps)
        self.scheduler.set_timesteps(num_inference_steps, mu=dynamic_shift_mu(self.scheduler, lat_h * lat_w),
                                     sigmas=sigmas.tolist())
        ts = np.asarray(self.scheduler.timesteps, np.float64)

        cb = make_mapped_progress(progress_callback, 0.35, 0.9)
        for i, t in enumerate(ts):
            t_b = torch.full((1,), float(t), dtype=torch.float32, device=self.device)
            v = tf(x, embeds, layers, t_b, text_mask=mask, grid_hw=(lat_h, lat_w))
            if use_cfg:
                v_neg = tf(x, neg[0], neg[1], t_b, text_mask=neg[2], grid_hw=(lat_h, lat_w))
                v = v_neg + guidance_scale * (v - v_neg)
            x = self.scheduler.step(v.float(), float(t), x)[0]
            safe_emit_progress(cb, (i + 1) / len(ts), f"step {i + 1}/{len(ts)}")

        z = x.transpose(1, 2).reshape(1, z_dim, lat_h, lat_w)
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return z
        frames = self.tensor_to_frames(self.vae.decode(z.float()))
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames
