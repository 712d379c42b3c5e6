"""HunyuanImage 2.1 text-to-image engine (port of
``apex_studio_tpu/engine/hunyuanimage.py``), for the base and the distilled
manifests.

- Qwen2.5-VL prompt embeddings through the describe-the-image template, the
  34 template tokens dropped, ``hidden_states[-3]``; a byT5 glyph branch fed
  with the quoted spans of the prompt (zeros and an empty mask without any)
- flow-match Euler on a linear sigma ladder
- the base model: CFG with the adaptive projected guidance mix (APG); the
  distilled one: an embedded ``distilled_guidance_scale`` (× 1000) and the
  meanflow ``timestep_r`` (the next step's timestep, 0 at the last)
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine
from apex_studio_tpu_torch.engine.hunyuanvideo15 import extract_glyph_text
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.hunyuanimage")

_TEMPLATE = ("<|im_start|>system\nDescribe the image by detailing the color, shape, size, texture, quantity, "
             "text, spatial relationships of the objects and background:<|im_end|>\n"
             "<|im_start|>user\n{}<|im_end|>")
_DROP_IDX = 34


def apg_mix(pred_cond: torch.Tensor, pred_uncond: torch.Tensor, guidance_scale: float, eta: float = 0.0,
            norm_threshold: float = 10.0) -> torch.Tensor:
    """Adaptive projected guidance: the CFG delta, its norm clamped to
    ``norm_threshold``, keeps mostly its part orthogonal to the conditional
    prediction (``eta`` weighs the parallel part)."""
    diff = pred_cond - pred_uncond
    flat = diff.reshape(diff.shape[0], -1)
    if norm_threshold and norm_threshold > 0:
        norm = torch.linalg.vector_norm(flat, dim=-1, keepdim=True)
        flat = flat * torch.clamp(norm_threshold / norm.clamp_min(1e-6), max=1.0)
    cond_flat = pred_cond.reshape(diff.shape[0], -1)
    unit = cond_flat / torch.linalg.vector_norm(cond_flat, dim=-1, keepdim=True).clamp_min(1e-6)
    parallel = (flat * unit).sum(-1, keepdim=True) * unit
    flat = parallel * eta + (flat - parallel)
    return pred_cond + (guidance_scale - 1.0) * flat.reshape(diff.shape)


@register_engine("hunyuanimage", "t2i")
class HunyuanImageT2IEngine(BaseEngine):
    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.text_encoder_2 = None

    def load_text_encoders(self) -> None:
        from apex_studio_tpu_torch.text_encoder import TextEncoder

        te_specs = [s for s in self.component_specs.values() if s.get("type") == "text_encoder"]
        mllm = next((s for s in te_specs if "Qwen" in (s.get("base") or "")), None)
        byt5 = next((s for s in te_specs if "T5" in (s.get("base") or "")), None)
        if self.text_encoder is None and mllm is not None:
            self.text_encoder = TextEncoder(self, mllm)
        if self.text_encoder_2 is None and byt5 is not None:
            self.text_encoder_2 = TextEncoder(self, byt5)

    def _encode_mllm(self, prompt: str, max_length: int = 1000):
        te = self.text_encoder
        ids, mask = te.tokenize([_TEMPLATE.format(prompt)], max_length + _DROP_IDX)
        mask_t = torch.from_numpy(mask).to(self.device)
        hidden = te._ensure_model()(torch.from_numpy(ids).long().to(self.device), attention_mask=mask_t,
                                    num_hidden_layers_to_skip=2)
        return hidden[:, _DROP_IDX:], mask_t[:, _DROP_IDX:]

    def _encode_byt5(self, prompt: str, max_length: int = 128):
        glyph = extract_glyph_text(prompt)
        dim = self.transformer.cfg.text_embed_2_dim
        if dim is None:
            return None, None
        if glyph is None or self.text_encoder_2 is None:
            return (torch.zeros((1, max_length, dim), dtype=torch.float32, device=self.device),
                    torch.zeros((1, max_length), dtype=torch.int32, device=self.device))
        return self.text_encoder_2.encode([f'Text "{glyph}". '], max_sequence_length=max_length,
                                          use_chat_template=False)

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: int = 2048,
        width: int = 2048,
        num_inference_steps: int = 50,
        guidance_scale: float = 3.5,
        distilled_guidance_scale: Optional[float] = 3.25,
        apg_eta: float = 0.0,
        apg_norm_threshold: float = 10.0,
        use_apg: bool = True,
        seed: Optional[int] = None,
        sigmas: Optional[List[float]] = None,
        return_latents: bool = False,
        render_on_step: bool = False,
        render_on_step_callback: Optional[Callable] = None,
        render_on_step_interval: int = 3,
        progress_callback: Optional[Callable] = None,
        offload: bool = True,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting HunyuanImage t2i")
        self.load_text_encoders()
        self.load_missing("transformer", "vae", "scheduler")
        tf = self.transformer
        cfg_t = tf.cfg

        pos = (*self._encode_mllm(prompt or ""), *self._encode_byt5(prompt or ""))
        use_cfg = guidance_scale > 1.0 and not cfg_t.guidance_embeds
        neg = (*self._encode_mllm(negative_prompt or ""), *self._encode_byt5(negative_prompt or "")) if use_cfg \
            else None
        safe_emit_progress(progress_callback, 0.2, "Prompts encoded")

        s_scale = self.vae.cfg.spatial_scale
        ph, pw = cfg_t.patch_size
        height -= height % (s_scale * ph)
        width -= width % (s_scale * pw)
        x = self.get_latents((1, cfg_t.in_channels, height // s_scale, width // s_scale), seed=seed)
        sig = np.linspace(1.0, 0.0, num_inference_steps + 1) if sigmas is None else np.asarray(list(sigmas) + [0.0])
        ts = sig[:-1] * 1000.0

        def full(value: float) -> torch.Tensor:
            return torch.full((1,), value, dtype=torch.float32, device=self.device)

        guidance = None
        if cfg_t.guidance_embeds and distilled_guidance_scale is not None:
            guidance = full(float(distilled_guidance_scale) * 1000.0)
        cb = make_mapped_progress(progress_callback, 0.25, 0.9)
        for i, t in enumerate(ts):
            t_r = None
            if cfg_t.use_meanflow:
                t_r = full(float(ts[i + 1])) if i + 1 < len(ts) else full(0.0)
            xd, t_b = x.to(tf.dtype), full(float(t))
            v = tf(xd, t_b, *pos, guidance=guidance, t_r=t_r).float()
            if use_cfg:
                v_neg = tf(xd, t_b, *neg, guidance=guidance, t_r=t_r).float()
                v = (apg_mix(v, v_neg, guidance_scale, apg_eta, apg_norm_threshold) if use_apg
                     else v_neg + guidance_scale * (v - v_neg))
            x = x + float(sig[i + 1] - sig[i]) * v
            if (render_on_step and render_on_step_callback is not None
                    and (i + 1) % render_on_step_interval == 0 and i + 1 < len(ts)):
                try:
                    render_on_step_callback(self._decode(x), i)
                except Exception:
                    logger.exception("preview callback failed")
            safe_emit_progress(cb, (i + 1) / len(ts), f"step {i + 1}/{len(ts)}")

        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self._decode(x)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames

    def _decode(self, x: torch.Tensor) -> List[np.ndarray]:
        return self.tensor_to_frames(self.vae.decode(x.float()))
