"""ZImage engines (port of ``apex_studio_tpu/engine/zimage.py``): text-to-image
and control/inpaint.

- prompt → Qwen3 chat template → ``hidden_states[-2]``; the real tokens are
  packed into a 32-multiple caption bucket, each stream its own
- resolution snapped to the VAE scale × patch grid, seeded f32 latents from
  the CPU generator (the seed contract)
- dynamic-shift flow-match Euler timesteps from the image sequence length
- the DiT takes ``t = (1000 − σt)/1000`` and its output is negated
- CFG is pos-anchored (pos + g·(pos − neg)) with an optional norm clamp that
  only shrinks and a time truncation; cond and uncond run as separate
  forwards, each with its own caption bucket
- a denoise step is forward, CFG and the Euler update in one step function
  (engine/fused.py); previews only above 8 steps; the VAE decodes f32 latents
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine, dynamic_shift_mu
from apex_studio_tpu_torch.engine.fused import build_euler_step
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.zimage")

SEQ_MULTI_OF = 32


def _bucket(n: int) -> int:
    return max(SEQ_MULTI_OF, ((n + SEQ_MULTI_OF - 1) // SEQ_MULTI_OF) * SEQ_MULTI_OF)


def cfg_norm_clamp(pos: torch.Tensor, pred: torch.Tensor, ratio: float) -> torch.Tensor:
    """Scale each sample of ``pred`` down so that its norm stays within
    ``ratio`` times the norm of ``pos`` (never up); ``ratio`` 0 turns it off."""
    b = pos.shape[0]
    pos_n = torch.linalg.vector_norm(pos.reshape(b, -1), dim=-1)
    new_n = torch.linalg.vector_norm(pred.reshape(b, -1), dim=-1)
    max_n = pos_n * ratio
    shrink = torch.where((ratio > 0) & (new_n > max_n), max_n / new_n.clamp_min(1e-12),
                         torch.ones_like(new_n))
    return pred * shrink[:, None, None, None]


@register_engine("zimage", "t2i")
class ZImageT2IEngine(BaseEngine):
    def _encode_single(self, prompt: str, max_sequence_length: int):
        """→ (embeds f32 [1, bucket, D], mask bool [1, bucket]): the real
        tokens first, the rest of the 32-multiple bucket zero."""
        hidden, mask = self.text_encoder.encode([prompt], max_sequence_length=max_sequence_length)
        real = mask[0].bool()
        true_len = int(real.sum())
        bucket = _bucket(true_len)
        emb = torch.zeros(1, bucket, hidden.shape[-1], dtype=torch.float32, device=self.device)
        emb[0, :true_len] = hidden[0][real].float()
        m = torch.zeros(1, bucket, dtype=torch.bool, device=self.device)
        m[0, :true_len] = True
        return emb, m

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        cfg_normalization: float = 0.0,
        cfg_truncation: float = 1.0,
        num_images_per_prompt: int = 1,
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
        control_context: Optional[torch.Tensor] = None,
        control_context_scale: float = 0.75,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting text-to-image pipeline")
        height = height or 1024
        width = width or 1024

        if self.text_encoder is None:
            self.load_component_by_type("text_encoder")
        # The VAE defines the latent geometry: it loads even for return_latents runs.
        if self.vae is None:
            self.load_component_by_type("vae")
        if self.transformer is None:
            self.load_component_by_type("transformer")
        if self.scheduler is None:
            self.load_component_by_type("scheduler")
        safe_emit_progress(progress_callback, 0.05, "Components ready")

        lat_scale = self.vae.cfg.spatial_scale
        height -= height % (lat_scale * 2)
        width -= width % (lat_scale * 2)
        do_cfg = guidance_scale > 1.0

        cap, cap_mask = self._encode_single(prompt or "", max_sequence_length)
        neg_cap = neg_mask = None
        if do_cfg:
            neg_cap, neg_mask = self._encode_single(negative_prompt or "", max_sequence_length)
        safe_emit_progress(progress_callback, 0.18, "Prompts ready")

        tf = self.transformer
        cfg_t = tf.cfg
        lat_h, lat_w = height // lat_scale, width // lat_scale
        b = num_images_per_prompt
        lats = self.get_latents((b, cfg_t.in_channels, lat_h, lat_w), seed=seed, latents=latents)
        safe_emit_progress(progress_callback, 0.32, "Initialized latent noise")

        image_seq_len = (lat_h // cfg_t.patch_size) * (lat_w // cfg_t.patch_size)
        mu = dynamic_shift_mu(self.scheduler, image_seq_len)
        ts, num_inference_steps = self.get_timesteps(
            self.scheduler, num_inference_steps, timesteps=timesteps, sigmas=sigmas, mu=mu)
        safe_emit_progress(progress_callback, 0.40, "Timesteps computed; starting denoise")
        denoise_cb = make_mapped_progress(progress_callback, 0.40, 0.92)

        ckw = ({} if control_context is None else
               {"control_context": control_context.to(device=self.device, dtype=tf.dtype),
                "control_context_scale": float(control_context_scale)})
        norm_ratio = float(cfg_normalization or 0.0)

        def velocity(x, t_vec, g, cap, cap_mask, neg_cap, neg_mask):
            x_in = x.to(tf.dtype)[:, :, None]
            pos = tf(x_in, t_vec, cap, cap_mask, **ckw)[:, :, 0].float()
            if neg_cap is None:
                return -pos
            neg = tf(x_in, t_vec, neg_cap, neg_mask, **ckw)[:, :, 0].float()
            g32 = float(np.float32(g))
            return -cfg_norm_clamp(pos, pos + g32 * (pos - neg), float(np.float32(norm_ratio)))

        step = build_euler_step(velocity)
        for i, t in enumerate(ts):
            t_model = (1000.0 - float(t)) / 1000.0
            g = guidance_scale
            if do_cfg and cfg_truncation is not None and float(cfg_truncation) <= 1.0:
                if t_model > float(cfg_truncation):
                    g = 0.0
            apply_cfg = do_cfg and g > 0
            t_vec = torch.full((b,), t_model, dtype=torch.float32, device=self.device)
            lats = step(lats, float(self.scheduler.sigmas[i]), float(self.scheduler.sigmas[i + 1]),
                        t_vec, g, cap, cap_mask, neg_cap if apply_cfg else None, neg_mask)

            if (render_on_step and render_on_step_callback is not None and num_inference_steps > 8
                    and (i + 1) % render_on_step_interval == 0 and i + 1 < len(ts)):
                try:
                    render_on_step_callback(self._decode_frames(lats), i)
                except Exception:
                    logger.exception("preview callback failed")
            if denoise_cb is not None:
                denoise_cb(min((i + 1) / len(ts), 1.0), f"Denoising step {i + 1}/{len(ts)}")

        safe_emit_progress(progress_callback, 0.92, "Denoising complete")
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return lats
        frames = self._decode_frames(lats)
        safe_emit_progress(progress_callback, 1.0, "Completed text-to-image pipeline")
        return frames

    def _decode_frames(self, lats: torch.Tensor) -> List[np.ndarray]:
        return self.tensor_to_frames(self.vae.decode(lats.float()))


@register_engine("zimage", "control")
class ZImageControlEngine(ZImageT2IEngine):
    """Z-Image control/inpaint: [control latents (16) ‖ inverted mask (1) ‖
    inpaint latents (16)] = 33 channels of control context for the
    ControlNet-style branch of ``zimage.control``."""

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        control_image: Optional[Any] = None,
        image: Optional[Any] = None,
        mask_image: Optional[Any] = None,
        control_context_scale: float = 0.75,
        height: Optional[int] = None,
        width: Optional[int] = None,
        **kwargs: Any,
    ):
        import cv2

        if self.vae is None:
            self.load_component_by_type("vae")
        if self.transformer is None:
            self.load_component_by_type("transformer")
        height = height or 1024
        width = width or 1024
        lat_scale = self.vae.cfg.spatial_scale
        height -= height % (lat_scale * 2)
        width -= width % (lat_scale * 2)
        lat_h, lat_w = height // lat_scale, width // lat_scale
        nl = self.transformer.cfg.in_channels

        def encode_image(arr):
            px = cv2.resize(np.asarray(arr), (width, height), interpolation=cv2.INTER_AREA)
            px = (px.astype(np.float32) / 127.5 - 1.0).transpose(2, 0, 1)
            return self.encode_video_latents(px[None])  # the 2-D AutoencoderKL: [B, 3, H, W]

        # mask: 1 = the region to regenerate (all of it by default)
        if mask_image is not None:
            m = cv2.resize(np.asarray(self.load_image_input(mask_image))[..., 0], (width, height),
                           interpolation=cv2.INTER_NEAREST)
            mask = (m.astype(np.float32) / 255.0)[None, None]
        else:
            mask = np.ones((1, 1, height, width), np.float32)

        if image is not None:
            arr = np.asarray(self.load_image_input(image)).astype(np.float32)
            arr = cv2.resize(arr, (width, height), interpolation=cv2.INTER_AREA)
            keep = (cv2.resize(mask[0, 0], (width, height), interpolation=cv2.INTER_NEAREST) < 0.5)[..., None]
            inpaint_lat = encode_image((arr * keep).astype(np.uint8))
        else:
            inpaint_lat = torch.zeros(1, nl, lat_h, lat_w, dtype=torch.float32, device=self.device)
        if control_image is not None:
            control_lat = encode_image(self.load_image_input(control_image))
        else:
            control_lat = torch.zeros_like(inpaint_lat)

        # the inverted mask at latent resolution, nearest
        mask_lat = cv2.resize(1.0 - mask[0, 0], (lat_w, lat_h), interpolation=cv2.INTER_NEAREST)
        mask_lat = torch.from_numpy(np.ascontiguousarray(mask_lat))[None, None].to(self.device)
        cc = torch.cat([control_lat.float(), mask_lat.float(), inpaint_lat.float()], dim=1)[:, :, None]
        return super().run(prompt=prompt, height=height, width=width,
                           control_context=cc.to(self.transformer.dtype),
                           control_context_scale=control_context_scale, **kwargs)
