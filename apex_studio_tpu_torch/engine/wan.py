"""Wan engines (port of ``apex_studio_tpu/engine/wan.py``): text-to-video,
text-to-image and image-to-video, Wan 2.1 and the Wan 2.2 A14B dual-expert
pair. The other Wan model types (v2v, causal, VACE, Fun, Recam, Holocine, …)
are not ported.

- UMT5 features of 512 tokens with the padding zeroed, no cross-attention
  mask (Wan's conditioning convention); encoded before the DiT loads and the
  encoder released after (t2v, t2i), disk-cached per prompt
- latents [1, C, (frames−1)/4+1, H/8, W/8], f32 from the seed contract
- FlowUniPC with the manifest's shift; CFG ``v_neg + g·(v − v_neg)`` in f32
- Wan 2.2 A14B: the high-noise expert runs while ``t ≥ boundary_ratio·1000``,
  the low-noise expert (``transformer_2``) after, with ``guidance_scale_2``;
  both stay resident
- a denoise step is the forward(s), CFG and the scheduler's update in one
  step function (engine/fused.py): UniPC through its linear plan, Euler
  schedulers through (σ, σ'), any other through ``scheduler.step``; EasyCache
  step skipping with ``easy_cache_thresh > 0``
- the Wan VAE decodes whole up to 48 × 48 latent pixels, above that in tiles
  of 32 (models/vaes/tiling.py); previews only above 8 steps
- i2v: the condition channels are a 4-channel temporal mask of the first
  frame and a VAE encode of (image ‖ zero frames), 20 channels beside the 16
  of noise; the scheduler steps on the host, as in the JAX engine. The
  CLIP-vision branch of Wan 2.1 I2V is not ported (the A14B manifest has no
  image encoder)
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine
from apex_studio_tpu_torch.engine.fused import build_euler_step, build_unipc_step, cfg_combine, init_unipc_carry
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.ops.easycache import EasyCacheState, cached_step, init_state
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.wan")

_LOW_NOISE = ("transformer_2", "low_noise_transformer")


@dataclasses.dataclass
class _EasyCache:
    """EasyCache's per-request state: one stream for the prompt, one for the
    negative prompt, and whether this step must compute."""

    thresh: float
    pos: EasyCacheState
    neg: EasyCacheState
    force: bool = False


class WanShared(BaseEngine):
    # latent grids over 48 × 48 pixels decode in tiles of 32 latent pixels
    VAE_TILE = 32
    VAE_TILE_THRESHOLD = 48 * 48

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.transformer_2 = None  # the low-noise expert (Wan 2.2 A14B)

    # -- components -------------------------------------------------------------

    def _load_transformer_2(self):
        for name, spec in self.component_specs.items():
            if spec.get("type") == "transformer" and name in _LOW_NOISE:
                self.transformer_2 = self._load_transformer(spec)
                return self.transformer_2
        return None

    def _primary_transformer_spec(self) -> Optional[Dict[str, Any]]:
        for name, spec in self.component_specs.items():
            if spec.get("type") == "transformer" and name not in (*_LOW_NOISE, "audio_transformer"):
                return spec
        return None

    def load_components(self, return_latents: bool) -> None:
        if self.text_encoder is None:
            self.load_component_by_type("text_encoder")
        if self.transformer is None:
            self.transformer = self._load_transformer(self._primary_transformer_spec())
        # the VAE defines the latent geometry: it loads even for return_latents runs
        if self.vae is None:
            self.load_component_by_type("vae")
        if self.scheduler is None:
            self.load_component_by_type("scheduler")

    # -- conditioning ---------------------------------------------------------------

    def encode_prompt(self, prompt: str, max_sequence_length: int = 512) -> torch.Tensor:
        """UMT5 features [1, L, 4096] with the padding rows zeroed."""
        hidden, mask = self.text_encoder.encode(
            [prompt], max_sequence_length=max_sequence_length, use_chat_template=False)
        return torch.where(mask[..., None].bool(), hidden, 0.0)

    # -- denoise core -----------------------------------------------------------------

    def _expert(self, t: float, boundary_timestep: Optional[float], guidance_scale: float,
                guidance_scale_2: Optional[float]):
        """(transformer, guidance) for timestep ``t``: the low-noise expert
        below the boundary when it is loaded, else the primary one."""
        if boundary_timestep is not None and float(t) < boundary_timestep and self.transformer_2 is not None:
            return self.transformer_2, guidance_scale_2 if guidance_scale_2 is not None else guidance_scale
        return self.transformer, guidance_scale

    @staticmethod
    def _apply(x, transformer, t_vec, ctx, neg_ctx, g, use_cfg, ec: Optional[_EasyCache]):
        """The post-CFG f32 velocity at ``x``; with EasyCache (``ec``), each
        stream's forward may be skipped and its state is updated."""
        x_in = x.to(transformer.dtype)
        if ec is not None:
            v, ec.pos = cached_step(lambda xi: transformer(xi, t_vec, ctx), x_in, ec.pos, ec.thresh, ec.force)
            if use_cfg:
                v_neg, ec.neg = cached_step(lambda xi: transformer(xi, t_vec, neg_ctx), x_in, ec.neg, ec.thresh,
                                            ec.force)
                v = cfg_combine(v, v_neg, g)
            return v
        v = transformer(x_in, t_vec, ctx).float()
        if use_cfg:
            v = cfg_combine(v, transformer(x_in, t_vec, neg_ctx), g)
        return v

    @torch.inference_mode()
    def denoise(
        self,
        latents: torch.Tensor,
        ts: np.ndarray,
        context: torch.Tensor,
        neg_context: Optional[torch.Tensor],
        guidance_scale: float,
        guidance_scale_2: Optional[float],
        boundary_timestep: Optional[float],
        render_cb: Optional[Callable],
        render_interval: int,
        render_on_step: bool,
        progress_cb: Optional[Callable],
        easy_cache_thresh: float = 0.0,
        easy_cache_ret_steps: int = 10,
    ) -> torch.Tensor:
        use_cfg = guidance_scale > 1.0 and neg_context is not None
        if len(ts) <= 8:
            render_on_step = False
        if boundary_timestep is not None and self.transformer_2 is None:
            self._load_transformer_2()

        # the scheduler family picks the step: UniPC through its linear plan,
        # the Euler family through (sigma, sigma_next), any other on the host
        if hasattr(self.scheduler, "fused_plan"):
            plan = self.scheduler.fused_plan()
            step = build_unipc_step(self._apply, self.scheduler.solver_order)
            hist, last = init_unipc_carry(latents, self.scheduler.solver_order)
        elif hasattr(self.scheduler, "step_at"):
            plan, step = None, build_euler_step(self._apply)
        else:
            plan = step = None
        easycache = None
        if easy_cache_thresh > 0.0:
            easycache = _EasyCache(easy_cache_thresh, init_state(latents, latents), init_state(latents, latents))
        neg_in = neg_context if neg_context is not None else context

        x = latents
        for i, t in enumerate(ts):
            transformer, g = self._expert(t, boundary_timestep, guidance_scale, guidance_scale_2)
            t_vec = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
            if easycache is not None:
                easycache.force = i < easy_cache_ret_steps or i >= len(ts) - 1
            cond = (transformer, t_vec, context, neg_in, float(np.float32(g)), use_cfg and g > 1.0, easycache)
            if step is None:
                (x,) = self.scheduler.step(self._apply(x, *cond), float(t), x)
            elif plan is not None:
                p = plan[i]
                x = step(x, hist, last, p["sigma"], p["use_corrector"], p["corr_w"], p["pred_w"], *cond)
            else:
                x = step(x, float(self.scheduler.sigmas[i]), float(self.scheduler.sigmas[i + 1]), *cond)
            self._after_step(x, i, len(ts), render_on_step, render_cb, render_interval, progress_cb)
        return x

    def _after_step(self, x, i, n, render_on_step, render_cb, render_interval, progress_cb) -> None:
        if render_on_step and render_cb is not None and (i + 1) % render_interval == 0 and i + 1 < n:
            try:
                render_cb(self.preview_frames(x, self.decode_latents), i)
            except Exception:
                logger.exception("preview callback failed")
        if progress_cb is not None:
            progress_cb(min((i + 1) / n, 1.0), f"Denoising step {i + 1}/{n}")

    def decode_latents(self, z: torch.Tensor) -> List[np.ndarray]:
        return self.decode_video_frames(z, self.VAE_TILE, self.VAE_TILE_THRESHOLD)

    def _geometry(self, height: int, width: int, num_frames: int):
        """Sizes snapped to the VAE's and the patch's multiples, frames to
        4k + 1: (height, width, num_frames, lat_t, lat_h, lat_w)."""
        vae_cfg = self.vae.cfg if self.vae is not None else None
        s_scale = vae_cfg.spatial_scale if vae_cfg else 8
        t_scale = vae_cfg.temporal_scale if vae_cfg else 4
        _, ph, pw = self.transformer.cfg.patch_size
        height -= height % (s_scale * ph)
        width -= width % (s_scale * pw)
        num_frames = max(1, num_frames - (num_frames - 1) % t_scale)
        return height, width, num_frames, (num_frames - 1) // t_scale + 1, height // s_scale, width // s_scale

    def _boundary(self, boundary_ratio: Optional[float]) -> Optional[float]:
        if boundary_ratio is None:
            return None
        return boundary_ratio * getattr(self.scheduler, "num_train_timesteps", 1000)

    @torch.inference_mode()
    def _run_video(
        self,
        prompt: Optional[str],
        negative_prompt: Optional[str],
        height: int,
        width: int,
        num_frames: int,
        num_inference_steps: int,
        guidance_scale: float,
        guidance_scale_2: Optional[float],
        boundary_ratio: Optional[float],
        seed: Optional[int],
        latents: Optional[np.ndarray],
        shift: Optional[float],
        timesteps: Optional[List[float]],
        return_latents: bool,
        render_on_step: bool,
        render_on_step_callback: Optional[Callable],
        render_on_step_interval: int,
        progress_callback: Optional[Callable],
        max_sequence_length: int = 512,
        easy_cache_thresh: float = 0.0,
        easy_cache_ret_steps: int = 10,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting pipeline")
        # encode before the 14B DiT loads: UMT5-XXL and the DiT never share the card
        if self.text_encoder is None:
            self.load_component_by_type("text_encoder")
        context = self.encode_prompt(prompt or "", max_sequence_length)
        use_cfg = guidance_scale > 1.0
        neg_context = self.encode_prompt(negative_prompt or "", max_sequence_length) if use_cfg else None
        self.maybe_release_text_encoders()
        safe_emit_progress(progress_callback, 0.05, "Prompts ready")

        self.load_components(return_latents)
        safe_emit_progress(progress_callback, 0.18, "Components ready")

        height, width, num_frames, lat_t, lat_h, lat_w = self._geometry(height, width, num_frames)
        x = self.get_latents((1, self.transformer.cfg.in_channels, lat_t, lat_h, lat_w), seed=seed,
                             latents=latents)
        safe_emit_progress(progress_callback, 0.3, "Initialized latent noise")

        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps, timesteps=timesteps,
                                   **({"shift": shift} if shift is not None else {}))
        safe_emit_progress(progress_callback, 0.4, "Timesteps computed; starting denoise")

        x = self.denoise(
            x, ts, context, neg_context, guidance_scale, guidance_scale_2, self._boundary(boundary_ratio),
            render_on_step_callback, render_on_step_interval, render_on_step,
            make_mapped_progress(progress_callback, 0.4, 0.9),
            easy_cache_thresh=easy_cache_thresh, easy_cache_ret_steps=easy_cache_ret_steps,
        )
        safe_emit_progress(progress_callback, 0.9, "Denoising complete")
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self.decode_latents(x)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames


@register_engine("wan", "t2v")
class WanT2VEngine(WanShared):
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: int = 480,
        width: int = 832,
        duration: Optional[float] = None,
        fps: int = 16,
        num_frames: Optional[int] = None,
        num_inference_steps: int = 30,
        guidance_scale: float = 5.0,
        guidance_scale_2: Optional[float] = None,
        boundary_ratio: Optional[float] = None,
        seed: Optional[int] = None,
        latents: Optional[np.ndarray] = None,
        shift: Optional[float] = None,
        timesteps: Optional[List[float]] = None,
        return_latents: bool = False,
        render_on_step: bool = False,
        render_on_step_callback: Optional[Callable] = None,
        render_on_step_interval: int = 3,
        progress_callback: Optional[Callable] = None,
        easy_cache_thresh: float = 0.0,
        easy_cache_ret_steps: int = 10,
        **_: Any,
    ):
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        return self._run_video(
            prompt, negative_prompt, height, width, num_frames, num_inference_steps,
            guidance_scale, guidance_scale_2, boundary_ratio, seed, latents, shift,
            timesteps, return_latents, render_on_step, render_on_step_callback,
            render_on_step_interval, progress_callback,
            easy_cache_thresh=easy_cache_thresh, easy_cache_ret_steps=easy_cache_ret_steps,
        )


@register_engine("wan", "t2i")
class WanT2IEngine(WanShared):
    """A single-frame t2v as an image (the Wan 2.2 A14B text-to-image manifest)."""

    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 30,
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
        return self._run_video(
            prompt, negative_prompt, height, width, 1, num_inference_steps,
            guidance_scale, guidance_scale_2, boundary_ratio, seed, None, shift,
            None, return_latents, render_on_step, render_on_step_callback,
            render_on_step_interval, progress_callback,
        )


@register_engine("wan", "i2v")
class WanI2VEngine(WanShared):
    """Image-to-video: the first frame's latent and a frame mask as condition
    channels beside the noise (the published Wan I2V packing: condition =
    [4-channel temporal first-frame mask | VAE encode of (image ‖ zero frames)])."""

    @torch.inference_mode()
    def build_condition(self, image: np.ndarray, num_frames: int, height: int, width: int) -> torch.Tensor:
        """→ [1, 4 + z, T_lat, h, w] f32 condition channels."""
        import cv2

        t_scale = self.vae.cfg.temporal_scale
        lat_t = (num_frames - 1) // t_scale + 1
        resized = cv2.resize(image, (width, height), interpolation=cv2.INTER_LANCZOS4)
        first = torch.from_numpy((resized.astype(np.float32) / 127.5 - 1.0).transpose(2, 0, 1).copy())
        video = torch.cat([first[None, :, None], torch.zeros(1, 3, num_frames - 1, height, width)], dim=2)
        latent_condition = self.vae.encode(video.to(self.device)).float()

        lat_h, lat_w = latent_condition.shape[-2:]
        # the pixel frames' validity, packed t_scale to one into channels
        mask = np.zeros((1, 1, num_frames, lat_h, lat_w), np.float32)
        mask[:, :, 0] = 1.0
        first_rep = np.repeat(mask[:, :, :1], t_scale, axis=2)
        mask = np.concatenate([first_rep, mask[:, :, 1:]], axis=2)
        mask = mask.reshape(1, lat_t, t_scale, lat_h, lat_w).transpose(0, 2, 1, 3, 4)
        return torch.cat([torch.from_numpy(mask.copy()).to(self.device), latent_condition], dim=1)

    @torch.inference_mode()
    def run(
        self,
        image: Any = None,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: int = 480,
        width: int = 832,
        duration: Optional[float] = None,
        fps: int = 16,
        num_frames: Optional[int] = None,
        num_inference_steps: int = 30,
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
        safe_emit_progress(progress_callback, 0.0, "Starting i2v pipeline")
        self.load_components(return_latents=False)  # i2v always needs the VAE
        if image is None:
            raise ValueError("i2v requires an input image")
        if self.transformer.cfg.image_dim is not None:
            raise NotImplementedError("this transformer takes CLIP-vision image features (Wan 2.1 I2V); "
                                      "the CLIP-vision image encoder is not ported")
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        height, width, num_frames, lat_t, lat_h, lat_w = self._geometry(height, width, num_frames)

        context = self.encode_prompt(prompt or "")
        use_cfg = guidance_scale > 1.0
        neg_context = self.encode_prompt(negative_prompt or "") if use_cfg else None

        condition = self.build_condition(self.load_image_input(image), num_frames, height, width)
        safe_emit_progress(progress_callback, 0.25, "Image conditioning ready")

        noise_c = self.transformer.cfg.in_channels - condition.shape[1]
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
            x_in = torch.cat([x, condition], dim=1)
            v = self._apply(x_in, transformer, t_vec, context, neg_context, float(np.float32(g)),
                            use_cfg and g > 1.0, None)
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
