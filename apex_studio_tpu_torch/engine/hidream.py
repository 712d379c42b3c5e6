"""HiDream-I1 engines, t2i and edit (port of ``apex_studio_tpu/engine/hidream.py``).

Four text encoders picked by base and name: the pooled CLIP-L and CLIP-G
vectors concatenated into the time conditioning, T5 sequence tokens, and
Llama-3.1 hidden states from the ``stack_layers`` output split back into one
layer a block; the MoE MMDiT; flow-match Euler with CFG combined in the DiT's
output dtype. ``edit`` starts from the noised VAE encode of the input image
at the step ``image_strength`` implies.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.hidream")


@register_engine("hidream", "t2i", "edit")
class HiDreamT2IEngine(BaseEngine):
    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.text_encoders: dict = {}

    def load_components(self, return_latents: bool = False) -> None:
        from apex_studio_tpu_torch.text_encoder import TextEncoder

        te_specs = [s for s in self.component_specs.values() if s.get("type") == "text_encoder"]

        def pick(pred, label):
            s = next((s for s in te_specs if pred(s.get("base") or "", s.get("name") or "")), None)
            if s is None:
                raise KeyError(f"hidream manifest needs a {label} text_encoder")
            return s

        if not self.text_encoders:
            self.text_encoders = {
                "clip_l": TextEncoder(self, pick(lambda b, n: "CLIP" in b and "2" not in n, "CLIP-L")),
                "clip_g": TextEncoder(self, pick(lambda b, n: "CLIP" in b and "2" in n, "CLIP-G")),
                "t5": TextEncoder(self, pick(lambda b, n: "T5" in b, "T5")),
                "llama": TextEncoder(self, pick(lambda b, n: "Llama" in b or "llama" in b, "Llama")),
            }
        self.load_missing("transformer", "vae", "scheduler")

    def _clip_pooled(self, te, prompt: str) -> torch.Tensor:
        """The CLIP tower's pooled vector, without ``text_projection`` (as in
        JAX: neither CLIP module applies it)."""
        ids, mask = te.tokenize([prompt], 77)
        _, pooled = te._ensure_model()(torch.from_numpy(ids).long().to(self.device),
                                       attention_mask=torch.from_numpy(mask).to(self.device))
        return pooled

    def encode_prompt(self, prompt: str, max_sequence_length: int = 128):
        """→ (T5 tokens, one Llama layer a block, pooled CLIP-L ‖ CLIP-G)."""
        pooled = torch.cat([self._clip_pooled(self.text_encoders["clip_l"], prompt),
                            self._clip_pooled(self.text_encoders["clip_g"], prompt)], dim=-1)
        t5_seq, _ = self.text_encoders["t5"].encode([prompt], max_sequence_length=max_sequence_length,
                                                    use_chat_template=False)
        stacked, _ = self.text_encoders["llama"].encode([prompt], max_sequence_length=max_sequence_length)
        n_layers = len(self.transformer.cfg.llama_layers)
        d = self.transformer.cfg.caption_dim
        # stack_layers concatenates the chosen layers along the features; a
        # single layer is shared by every block
        llama = list(stacked.split(d, dim=-1)) if stacked.shape[-1] == n_layers * d else [stacked] * n_layers
        return t5_seq, llama, pooled

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        image: Optional[Any] = None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        seed: Optional[int] = None,
        timesteps: Optional[List[float]] = None,
        image_strength: float = 0.75,
        return_latents: bool = False,
        progress_callback: Optional[Callable] = None,
        offload: bool = True,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting HiDream pipeline")
        self.load_components(return_latents)
        t5, llama, pooled = self.encode_prompt(prompt or "")
        nt5, nllama, npooled = self.encode_prompt(negative_prompt or "")
        safe_emit_progress(progress_callback, 0.2, "Prompts encoded")

        tf = self.transformer
        s_scale = 2 ** (len(getattr(self.vae.cfg, "block_out_channels", (0,) * 4)) - 1)
        lat_h, lat_w = height // s_scale, width // s_scale
        x = self.get_latents((1, tf.cfg.in_channels, lat_h, lat_w), seed=seed)
        self.scheduler.set_timesteps(
            num_inference_steps, image_seq_len=(lat_h // tf.cfg.patch_size) * (lat_w // tf.cfg.patch_size))
        ts = np.asarray(self.scheduler.timesteps, np.float64)

        if image is not None:  # edit: start from the noised input image
            import cv2

            arr = cv2.resize(self.load_image_input(image), (width, height), interpolation=cv2.INTER_AREA)
            px = torch.from_numpy(np.ascontiguousarray(arr, np.float32).transpose(2, 0, 1)[None]) / 127.5 - 1.0
            z0 = self.vae.encode(px.to(self.device))
            ts = ts[int(len(ts) * (1.0 - image_strength)):]
            sigma0 = float(ts[0]) / 1000.0
            x = sigma0 * x + (1.0 - sigma0) * z0.float()
            self.scheduler.timesteps = ts.astype(np.float32)
            self.scheduler.sigmas = np.concatenate([ts / 1000.0, [0.0]])

        do_cfg = guidance_scale > 1.0
        cb = make_mapped_progress(progress_callback, 0.25, 0.9)
        for i, t in enumerate(ts):
            t_b = torch.full((1,), float(t), dtype=torch.float32, device=self.device)
            x_in = x.to(tf.dtype)
            v = tf(x_in, t_b, t5, llama, pooled)
            if do_cfg:
                neg = tf(x_in, t_b, nt5, nllama, npooled)
                v = neg + guidance_scale * (v - neg)
            x = self.scheduler.step(v.float(), float(t), x)[0]
            safe_emit_progress(cb, (i + 1) / len(ts), f"step {i + 1}/{len(ts)}")

        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self.tensor_to_frames(self.vae.decode(x.float()))
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames
