"""Ovis-Image text-to-image engine (port of ``apex_studio_tpu/engine/ovis.py``).

The Ovis2.5 MLLM (Qwen3) encodes the prompt through its chat template behind
a describe-the-image system prefix; the first 28 template tokens are cropped
and padded positions zeroed. Latents are Flux-packed 2×2 with a
dynamic-shift flow-match schedule; CFG runs when ``guidance_scale > 1`` and
is combined in the DiT's output dtype, as the JAX step does. The model takes
``t/1000`` and diagonal text RoPE ids.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine, dynamic_shift_mu
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.ovis")

_SYSTEM_PROMPT = ("Describe the image by detailing the color, quantity, text, shape, size, texture, spatial "
                  "relationships of the objects and background: ")
_CROP_START = 28


@register_engine("ovis", "t2i")
class OvisT2IEngine(BaseEngine):
    def encode_prompt(self, prompt: str, max_sequence_length: int = 256) -> torch.Tensor:
        self.load_missing("text_encoder")
        hidden, mask = self.text_encoder.encode([_SYSTEM_PROMPT + prompt],
                                                max_sequence_length=max_sequence_length + _CROP_START,
                                                use_chat_template=True)
        return (hidden * mask[..., None])[:, _CROP_START:]

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = "",
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        seed: Optional[int] = None,
        sigmas: Optional[List[float]] = None,
        max_sequence_length: int = 256,
        return_latents: bool = False,
        render_on_step: bool = False,
        render_on_step_callback: Optional[Callable] = None,
        render_on_step_interval: int = 3,
        progress_callback: Optional[Callable] = None,
        offload: bool = True,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting Ovis t2i")
        self.load_missing("transformer", "vae", "scheduler")
        context = self.encode_prompt(prompt or "", max_sequence_length)
        use_cfg = guidance_scale > 1.0
        neg_context = self.encode_prompt(negative_prompt or "", max_sequence_length) if use_cfg else context
        safe_emit_progress(progress_callback, 0.2, "Prompt encoded")

        tf = self.transformer
        s_scale = 2 ** (len(self.vae.cfg.block_out_channels) - 1)
        lat_h = 2 * (height // (s_scale * 2))
        lat_w = 2 * (width // (s_scale * 2))
        noise = self.get_latents((1, tf.cfg.in_channels // 4, lat_h, lat_w), seed=seed)
        x = tf.pack_latents(noise.float()).contiguous()
        grid_hw = (lat_h // 2, lat_w // 2)
        self.scheduler.set_timesteps(num_inference_steps, mu=dynamic_shift_mu(self.scheduler, x.shape[1]),
                                     sigmas=sigmas)
        ts = np.asarray(self.scheduler.timesteps, np.float64)

        cb = make_mapped_progress(progress_callback, 0.25, 0.9)
        for i, t in enumerate(ts):
            t_model = torch.full((1,), float(t), dtype=torch.float32, device=self.device) / 1000.0
            v = tf(x, context, t_model, grid_hw=grid_hw)
            if use_cfg:
                neg = tf(x, neg_context, t_model, grid_hw=grid_hw)
                v = neg + guidance_scale * (v - neg)
            x = self.scheduler.step(v.float(), float(t), x)[0]
            if (render_on_step and render_on_step_callback is not None
                    and (i + 1) % render_on_step_interval == 0 and i + 1 < len(ts)):
                try:
                    render_on_step_callback(self._decode(x, lat_h, lat_w), i)
                except Exception:
                    logger.exception("preview callback failed")
            safe_emit_progress(cb, (i + 1) / len(ts), f"step {i + 1}/{len(ts)}")

        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self._decode(x, lat_h, lat_w)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames

    def _decode(self, packed: torch.Tensor, lat_h: int, lat_w: int) -> List[np.ndarray]:
        z = self.transformer.unpack_latents(packed.float(), lat_h, lat_w)
        return self.tensor_to_frames(self.vae.decode(z))
