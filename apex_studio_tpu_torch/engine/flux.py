"""Flux text-to-image engine (port of ``FluxT2IEngine`` in
``apex_studio_tpu/engine/flux.py``): CLIP pooled + T5 sequence conditioning,
packed 2×2 latents, dynamic shift from the image sequence length, embedded
guidance for dev models, optional true CFG, and one Euler step per denoise
step. Seeded noise is drawn at the unpacked latent shape, then packed.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine
from apex_studio_tpu_torch.engine.fused import build_euler_step, cfg_combine
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.schedulers.base import compute_dynamic_shift_mu
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.flux")


@register_engine("flux", "t2i")
class FluxT2IEngine(BaseEngine):
    """text_encoder = CLIP-L (pooled), text_encoder_2 = T5-XXL (sequence)."""

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.text_encoder_2 = None

    def load_text_encoders(self) -> None:
        from apex_studio_tpu_torch.text_encoder import TextEncoder

        te_specs = [s for s in self.component_specs.values() if s.get("type") == "text_encoder"]
        clip_spec = next((s for s in te_specs if "CLIP" in (s.get("base") or "")), None)
        t5_spec = next((s for s in te_specs if "T5" in (s.get("base") or "")), None)
        if clip_spec is None or t5_spec is None:
            raise KeyError("flux manifest requires CLIP and T5 text_encoder components")
        if self.text_encoder is None:
            self.text_encoder = TextEncoder(self, clip_spec)
        if self.text_encoder_2 is None:
            self.text_encoder_2 = TextEncoder(self, t5_spec)

    def encode_prompt(self, prompt: str, prompt_2: Optional[str], max_sequence_length: int):
        """→ (pooled [1, 768], t5_seq [1, L, 4096])."""
        self.load_text_encoders()
        clip = self.text_encoder
        ids, mask = clip.tokenize([prompt], 77)
        model = clip._ensure_model()
        _, pooled = model(torch.from_numpy(ids).long().to(self.device),
                          attention_mask=torch.from_numpy(mask).to(self.device))
        # T5 goes through the disk-cached TextEncoder.encode so a repeat
        # prompt never rebuilds the 4.7B encoder after release_text_encoders.
        seq, _ = self.text_encoder_2.encode([prompt_2 or prompt], max_sequence_length,
                                            use_chat_template=False)
        return pooled, seq

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        prompt_2: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        negative_prompt_2: Optional[str] = None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 30,
        guidance_scale: float = 3.5,
        true_cfg_scale: float = 1.0,
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
        if self.vae is None:
            self.load_component_by_type("vae")
        if self.scheduler is None:
            self.load_component_by_type("scheduler")

        use_cfg = true_cfg_scale > 1.0 and negative_prompt is not None

        # Encode before the transformer loads: the T5 and the DiT never need
        # to be resident together.
        safe_emit_progress(progress_callback, 0.02, "Encoding prompts")
        pooled, seq = self.encode_prompt(prompt or "", prompt_2, max_sequence_length)
        neg_pooled = neg_seq = None
        if use_cfg:
            neg_pooled, neg_seq = self.encode_prompt(negative_prompt or "", negative_prompt_2,
                                                     max_sequence_length)
        if offload:
            # only the T5: CLIP is small and its pooled output is not disk-cached
            self.maybe_release_text_encoders(names=("text_encoder_2",))
        safe_emit_progress(progress_callback, 0.20, "Encoded prompts")

        if self.transformer is None:
            self.load_component_by_type("transformer")

        tf = self.transformer
        cfg_t = tf.cfg
        lat_scale = self.vae.cfg.spatial_scale
        height = height - height % (lat_scale * 2)
        width = width - width % (lat_scale * 2)
        lat_c = cfg_t.out_channels // 4
        lat_h, lat_w = height // lat_scale, width // lat_scale
        b = num_images

        noise = self.get_latents((b, lat_c, lat_h, lat_w), seed=seed, latents=latents)
        x = tf.pack_latents(noise.float()).contiguous()
        safe_emit_progress(progress_callback, 0.38, "Initialized latent noise")

        image_seq_len = x.shape[1]
        if sigmas is None:
            sigmas = np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps)
        sc = self.scheduler.config
        mu = compute_dynamic_shift_mu(
            image_seq_len,
            sc.get("base_image_seq_len", 256),
            sc.get("max_image_seq_len", 4096),
            sc.get("base_shift", 0.5),
            sc.get("max_shift", 1.15),
        )
        ts, num_inference_steps = self.get_timesteps(
            self.scheduler, num_inference_steps, timesteps=timesteps, sigmas=sigmas, mu=mu)
        self.scheduler.set_begin_index(0)
        safe_emit_progress(progress_callback, 0.48, "Timesteps computed")

        guidance = (torch.full((b,), guidance_scale, dtype=torch.float32, device=self.device)
                    if cfg_t.guidance_embeds else None)
        grid = (lat_h // 2, lat_w // 2)
        rope = tf.rope_tables(seq.shape[1], *grid, device=self.device)

        def apply(x, t_vec, seq, pooled, n_seq, n_pooled):
            x_in = x.to(tf.dtype)
            v = tf(x_in, seq, pooled, t_vec, guidance, grid_hw=grid, rope=rope)
            if use_cfg:
                v_neg = tf(x_in, n_seq, n_pooled, t_vec, guidance, grid_hw=grid, rope=rope)
                return cfg_combine(v, v_neg, true_cfg_scale)
            return v

        step = build_euler_step(apply)
        denoise_cb = make_mapped_progress(progress_callback, 0.50, 0.90)
        for i, t in enumerate(ts):
            t_vec = torch.full((b,), float(t) / 1000.0, dtype=torch.float32, device=self.device)
            x = step(x, float(self.scheduler.sigmas[i]), float(self.scheduler.sigmas[i + 1]),
                     t_vec, seq, pooled, neg_seq, neg_pooled)
            if (render_on_step and render_on_step_callback is not None
                    and num_inference_steps > 8 and (i + 1) % render_on_step_interval == 0
                    and i + 1 < len(ts)):
                try:
                    render_on_step_callback(self._decode_frames(x, lat_h, lat_w), i)
                except Exception:
                    logger.exception("preview callback failed")
            if denoise_cb is not None:
                denoise_cb(min((i + 1) / len(ts), 1.0), f"Denoising step {i + 1}/{len(ts)}")

        safe_emit_progress(progress_callback, 0.90, "Denoising complete")
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x

        frames = self._decode_frames(x, lat_h, lat_w)
        safe_emit_progress(progress_callback, 1.0, "Completed t2i pipeline")
        return frames

    def _decode_frames(self, packed: torch.Tensor, lat_h: int, lat_w: int) -> List[np.ndarray]:
        z = self.transformer.unpack_latents(packed, lat_h, lat_w)
        return self.tensor_to_frames(self.vae.decode(z.float()))
