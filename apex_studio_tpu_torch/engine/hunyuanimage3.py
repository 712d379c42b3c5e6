"""HunyuanImage 3.0 text-to-image engine, port of
``apex_studio_tpu/engine/hunyuanimage3.py``.

The causal multimodal MoE backbone denoises the image latent tokens behind
the tokenized prompt; flow-match Euler with CFG against the negative prompt
(two forwards a step); the family's DC-AE VAE decodes (a T = 1 latent, the
last of its reconstructed frames). The text component carries only the
tokenizer: the backbone is the language model. The prompt and the negative
prompt are padded to ``max_sequence_length`` with id 0 and the padding is
attended causally, as in JAX (ROADMAP Queue 3).

Residency: at the published widths (32 layers, 64 experts of 3072 and a
shared one, hidden 4096) the backbone holds about 8.0e10 parameters.
Synthetic ``int4`` holds every Linear of 2²⁰ elements or more (the experts,
the shared MLPs, the attention projections) as packed int4 through
``Linear._w4``, about 41 GB; bf16 (160 GB) or int8 (80 GB) do not fit one
card. The base engine's fit check (``BaseEngine._check_fits``) reckons each
component's bytes at the residency it is about to be built with and raises
with that need before building it; this engine keeps ``HEADROOM_BYTES``
free beside each.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.hunyuanimage3")

# bytes kept free beside the backbone for the VAE, the activations of a CFG
# step at 1024² and the allocator
HEADROOM_BYTES = 12 << 30


@register_engine("hunyuanimage3", "t2i")
class HunyuanImage3T2IEngine(BaseEngine):
    resident_headroom_bytes = HEADROOM_BYTES

    def load_components(self) -> None:
        from apex_studio_tpu_torch.text_encoder import TextEncoder

        if self.text_encoder is None:
            spec = self._spec_for_type("text_encoder") or {"type": "text_encoder"}
            self.text_encoder = TextEncoder(self, spec)
        self.load_missing("transformer", "vae", "scheduler")

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        seed: Optional[int] = None,
        max_sequence_length: int = 128,
        timesteps: Optional[List[float]] = None,
        return_latents: bool = False,
        progress_callback: Optional[Callable] = None,
        offload: bool = True,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting HunyuanImage3 t2i")
        self.load_components()
        ids, _ = self.text_encoder.tokenize([prompt or ""], max_sequence_length)
        nids, _ = self.text_encoder.tokenize([negative_prompt or ""], max_sequence_length)
        ids = torch.from_numpy(ids).long().to(self.device)
        nids = torch.from_numpy(nids).long().to(self.device)
        safe_emit_progress(progress_callback, 0.1, "Prompt tokenized")

        s_scale = getattr(self.vae.cfg, "spatial_scale", None) or 2 ** (
            len(getattr(self.vae.cfg, "block_out_channels", (0,) * 4)) - 1)
        tf = self.transformer
        x = self.get_latents((1, tf.cfg.img_in_channels, height // s_scale, width // s_scale), seed=seed)
        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps, timesteps=timesteps)
        do_cfg = guidance_scale > 1.0
        cb = make_mapped_progress(progress_callback, 0.15, 0.9)
        for i, t in enumerate(np.asarray(ts, np.float64)):
            t_b = torch.full((1,), float(t), dtype=torch.float32, device=self.device)
            xin = x.to(tf.dtype)
            v = tf(xin, t_b, ids)
            if do_cfg:
                neg = tf(xin, t_b, nids)
                v = neg + guidance_scale * (v - neg)
            out = self.scheduler.step(v.float(), float(t), x)
            x = out[0] if isinstance(out, tuple) else out
            safe_emit_progress(cb, (i + 1) / len(ts), f"step {i + 1}/{len(ts)}")

        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self.tensor_to_frames(self.decode_latents(x))
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames

    def decode_latents(self, x: torch.Tensor) -> torch.Tensor:
        """The VAE's decode of the final latents, in f32."""
        return self.vae.decode(x.float())

