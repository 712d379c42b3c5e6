"""Chroma text-to-image engine (port of ``apex_studio_tpu/engine/chroma.py``).

- T5-XXL prompt embeddings with their attention mask; true CFG against an
  encoded negative prompt (Chroma has no embedded guidance)
- the text mask masks padded text inside every attention of the DiT
- Flux geometry: 2×2 packed latents, zeroed text ids, dynamic-shift
  flow-match Euler from the image sequence length, ``t/1000`` into the model
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine, dynamic_shift_mu
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.chroma")


@register_engine("chroma", "t2i")
class ChromaT2IEngine(BaseEngine):
    def _encode(self, prompt: str, max_length: int = 512):
        hidden, mask = self.text_encoder.encode([prompt], max_sequence_length=max_length, use_chat_template=False)
        return hidden.float(), mask

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 30,
        guidance_scale: float = 3.0,
        use_cfg_guidance: bool = True,
        num_images: int = 1,
        seed: Optional[int] = None,
        latents: Optional[np.ndarray] = None,
        sigmas: Optional[List[float]] = None,
        timesteps: Optional[List[float]] = None,
        max_sequence_length: int = 512,
        return_latents: bool = False,
        render_on_step: bool = False,
        render_on_step_callback: Optional[Callable] = None,
        render_on_step_interval: int = 3,
        progress_callback: Optional[Callable] = None,
        offload: bool = True,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting t2i pipeline")
        # the VAE defines the latent geometry: it always loads
        self.load_missing("text_encoder", "transformer", "vae", "scheduler")
        safe_emit_progress(progress_callback, 0.05, "Components ready")

        txt, txt_mask = self._encode(prompt or "", max_sequence_length)
        do_cfg = use_cfg_guidance and negative_prompt is not None
        neg_txt = neg_mask = None
        if do_cfg:
            neg_txt, neg_mask = self._encode(negative_prompt or "", max_sequence_length)
        safe_emit_progress(progress_callback, 0.2, "Prompts ready")

        tf = self.transformer
        lat_scale = self.vae.cfg.spatial_scale
        height -= height % (lat_scale * 2)
        width -= width % (lat_scale * 2)
        lat_h, lat_w = height // lat_scale, width // lat_scale
        b = num_images
        noise = self.get_latents((b, tf.cfg.out_channels // 4, lat_h, lat_w), seed=seed, latents=latents)
        x = tf.pack_latents(noise.float()).contiguous()
        safe_emit_progress(progress_callback, 0.3, "Initialized latent noise")

        if sigmas is None:
            sigmas = np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps)
        ts, num_inference_steps = self.get_timesteps(self.scheduler, num_inference_steps, timesteps=timesteps,
                                                     sigmas=sigmas, mu=dynamic_shift_mu(self.scheduler, x.shape[1]))
        self.scheduler.set_begin_index(0)
        safe_emit_progress(progress_callback, 0.4, "Timesteps computed")

        grid, ropes = (lat_h // 2, lat_w // 2), {}

        def fwd(x_in, seq, mask, t_vec):
            n = seq.shape[1]
            if n not in ropes:  # one table a text length, built once a request
                ropes[n] = tf.rope_tables(n, *grid, device=self.device)
            return tf(x_in, seq, t_vec, attention_mask=mask, rope=ropes[n]).float()

        denoise_cb = make_mapped_progress(progress_callback, 0.4, 0.9)
        for i, t in enumerate(ts):
            t_vec = torch.full((b,), float(t) / 1000.0, dtype=torch.float32, device=self.device)
            x_in = x.to(tf.dtype)
            v = fwd(x_in, txt, txt_mask, t_vec)
            if do_cfg:
                v_neg = fwd(x_in, neg_txt, neg_mask, t_vec)
                v = v_neg + guidance_scale * (v - v_neg)
            (x,) = self.scheduler.step(v, float(t), x)
            if (render_on_step and render_on_step_callback is not None and num_inference_steps > 8
                    and (i + 1) % render_on_step_interval == 0 and i + 1 < len(ts)):
                try:
                    render_on_step_callback(self._decode_frames(x, lat_h, lat_w), i)
                except Exception:
                    logger.exception("preview callback failed")
            if denoise_cb is not None:
                denoise_cb(min((i + 1) / len(ts), 1.0), f"Denoising step {i + 1}/{len(ts)}")

        safe_emit_progress(progress_callback, 0.9, "Denoising complete")
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self._decode_frames(x, lat_h, lat_w)
        safe_emit_progress(progress_callback, 1.0, "Completed t2i pipeline")
        return frames

    def _decode_frames(self, packed: torch.Tensor, lat_h: int, lat_w: int) -> List[np.ndarray]:
        z = self.transformer.unpack_latents(packed, lat_h, lat_w)
        return self.tensor_to_frames(self.vae.decode(z.float()))
