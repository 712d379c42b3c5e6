"""Wan engines (port of ``apex_studio_tpu/engine/wan.py``): text-to-video,
text-to-image and image-to-video (Wan 2.1 with its CLIP-vision branch and
the Wan 2.2 A14B dual-expert pair), and the editing and long-video engines:
first–last frame, inpaint, video-to-video, VACE and Fun-VACE, Phantom,
Fun-Control, Fun, Stable Video Infinity, the block-causal Self-Forcing
engine, and the audio-driven engines on wav2vec2: HuMo (text + audio +
reference images, its windows driving the DiT's per-frame audio
cross-attention), S2V (chunk-autoregressive speech-to-video with a motion
buffer) and MultiTalk / InfiniteTalk (one or two speakers, L-RoPE routing).
The other Wan model types (Recam, Holocine, ATI, Animate, …) are not ported.

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
  of noise, and, where the DiT has ``image_dim`` (Wan 2.1), the CLIP-vision
  encoder's penultimate states as the image cross-attention's keys; the
  scheduler steps on the host, as in the JAX engine. fflf, inp and svi are
  i2v with other conditions
- VACE, Phantom, Fun, Fun-Control: one DiT (no expert switch, as in JAX),
  CFG in the DiT's dtype and the scheduler stepped on the host
- causal: blocks of latent frames denoised in turn against the DiT's K/V
  cache (models/transformers/wan.py ``WanCausalTransformer3DModel``), each
  block a few x0-renoise steps, then committed to the cache once more at
  ``context_noise``
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
from apex_studio_tpu_torch.utils.jax_resize import nearest_index
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


# -- conditioning helpers ------------------------------------------------------------------


def _pixels(frames: List[np.ndarray]) -> torch.Tensor:
    """HWC uint8 frames → [1, 3, T, H, W] f32 in [-1, 1]."""
    video = np.stack(frames).astype(np.float32) / 127.5 - 1.0  # [T, H, W, 3]
    return torch.from_numpy(np.ascontiguousarray(video.transpose(3, 0, 1, 2)))[None]


def _resized(frames, width: int, height: int, interpolation) -> List[np.ndarray]:
    import cv2

    return [cv2.resize(np.asarray(f), (width, height), interpolation=interpolation) for f in frames]


def _as_list(items) -> List[Any]:
    if items is None:
        return []
    return list(items) if isinstance(items, (list, tuple)) else [items]


def _is_path(x: Any) -> bool:
    return isinstance(x, (str, bytes)) or hasattr(x, "__fspath__")


def _packed_frame_mask(valid: np.ndarray, t_scale: int) -> np.ndarray:
    """Per-pixel-frame validity [1, 1, F, h, w] → [1, t_scale, T_lat, h, w]:
    the first frame repeated ``t_scale`` times, then ``t_scale`` frames a
    latent frame, packed into channels (the Wan I2V condition mask)."""
    _, _, _, h, w = valid.shape
    packed = np.concatenate([np.repeat(valid[:, :, :1], t_scale, axis=2), valid[:, :, 1:]], axis=2)
    lat_t = packed.shape[2] // t_scale
    return np.ascontiguousarray(packed.reshape(1, lat_t, t_scale, h, w).transpose(0, 2, 1, 3, 4))


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
    def _apply(x, transformer, t_vec, ctx, neg_ctx, g, use_cfg, ec: Optional[_EasyCache], ctx_img=None):
        """The post-CFG f32 velocity at ``x``; with EasyCache (``ec``), each
        stream's forward may be skipped and its state is updated. ``ctx_img``:
        CLIP-vision features for a DiT with an image branch."""
        x_in = x.to(transformer.dtype)

        def fwd(xi, c):
            return transformer(xi, t_vec, c, context_image=ctx_img)

        if ec is not None:
            v, ec.pos = cached_step(lambda xi: fwd(xi, ctx), x_in, ec.pos, ec.thresh, ec.force)
            if use_cfg:
                v_neg, ec.neg = cached_step(lambda xi: fwd(xi, neg_ctx), x_in, ec.neg, ec.thresh, ec.force)
                v = cfg_combine(v, v_neg, g)
            return v
        v = fwd(x_in, ctx).float()
        if use_cfg:
            v = cfg_combine(v, fwd(x_in, neg_ctx), g)
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
    [4-channel temporal first-frame mask | VAE encode of (image ‖ zero frames)]),
    and for a DiT with ``image_dim`` (Wan 2.1) the CLIP-vision features of
    the image (the manifest's ``image_encoder`` helper)."""

    @torch.inference_mode()
    def encode_image_clip(self, image: np.ndarray) -> torch.Tensor:
        """[1, 257, 1280]: the CLIP-vision encoder's penultimate hidden states."""
        from apex_studio_tpu_torch.models.text_encoders.clip_vision import preprocess_clip_image

        encoder = self.load_helper("image_encoder")
        pixels = torch.from_numpy(preprocess_clip_image(image, size=encoder.cfg.image_size)).to(self.device)
        return encoder(pixels, penultimate=True)

    @torch.inference_mode()
    def build_condition(self, image: np.ndarray, num_frames: int, height: int, width: int) -> torch.Tensor:
        """→ [1, 4 + z, T_lat, h, w] f32 condition channels."""
        import cv2

        first = _pixels(_resized([image], width, height, cv2.INTER_LANCZOS4))
        video = torch.cat([first, torch.zeros(1, 3, num_frames - 1, height, width)], dim=2)
        latent_condition = self.vae.encode(video.to(self.device)).float()
        lat_h, lat_w = latent_condition.shape[-2:]
        valid = np.zeros((1, 1, num_frames, lat_h, lat_w), np.float32)
        valid[:, :, 0] = 1.0
        mask = torch.from_numpy(_packed_frame_mask(valid, self.vae.cfg.temporal_scale)).to(self.device)
        return torch.cat([mask, latent_condition], dim=1)

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
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        height, width, num_frames, lat_t, lat_h, lat_w = self._geometry(height, width, num_frames)

        context = self.encode_prompt(prompt or "")
        use_cfg = guidance_scale > 1.0
        neg_context = self.encode_prompt(negative_prompt or "") if use_cfg else None

        image = self.load_image_input(image)
        clip_feats = self.encode_image_clip(image) if self.transformer.cfg.image_dim is not None else None
        condition = self.build_condition(image, num_frames, height, width)
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
                            use_cfg and g > 1.0, None, clip_feats)
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


@register_engine("wan", "v2v")
class WanV2VEngine(WanShared):
    """Video-to-video: the input video's latents corrupted to ``strength`` on
    the rectified-flow path (``scheduler.add_noise`` at the tail's first
    timestep), then the schedule's tail denoised through ``denoise``; as in
    JAX, the fused step's plan (and Euler's sigmas) are read from index 0 over
    that tail (ROADMAP Queue 3)."""

    @torch.inference_mode()
    def run(
        self,
        video: Any = None,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: int = 480,
        width: int = 832,
        num_frames: Optional[int] = None,
        strength: float = 0.7,
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
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting v2v pipeline")
        self.load_components(return_latents=False)
        if video is None:
            raise ValueError("v2v requires an input video")
        if _is_path(video):
            from apex_studio_tpu_torch.preprocess.base import load_frames

            video = load_frames(video, max_frames=num_frames)
        frames_in = [np.asarray(f) for f in video]
        height, width, _, _, _, _ = self._geometry(height, width, 1)
        t_scale = self.vae.cfg.temporal_scale
        n = len(frames_in)
        frames_in = frames_in[:max(1, n - (n - 1) % t_scale)]
        source = self.encode_video_latents(_pixels(_resized(frames_in, width, height, cv2.INTER_LANCZOS4)))
        safe_emit_progress(progress_callback, 0.2, "Encoded source video")

        context = self.encode_prompt(prompt or "")
        use_cfg = guidance_scale > 1.0
        neg_context = self.encode_prompt(negative_prompt or "") if use_cfg else None

        ts_full, _ = self.get_timesteps(self.scheduler, num_inference_steps,
                                        **({"shift": shift} if shift is not None else {}))
        # the schedule's tail: start denoising from sigma ≈ strength
        start = min(int(round(num_inference_steps * (1.0 - strength))), len(ts_full) - 1)
        ts = ts_full[start:]
        self.scheduler.set_begin_index(start)
        noise = self.get_latents(tuple(source.shape), seed=seed)
        x = self.scheduler.add_noise(source.float(), noise, ts[0])
        safe_emit_progress(progress_callback, 0.35, "Corrupted source; starting denoise")

        x = self.denoise(x, ts, context, neg_context, guidance_scale, guidance_scale_2,
                         self._boundary(boundary_ratio), render_on_step_callback, render_on_step_interval,
                         render_on_step, make_mapped_progress(progress_callback, 0.35, 0.9))
        safe_emit_progress(progress_callback, 0.9, "Denoising complete")
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self.decode_latents(x)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames


@register_engine("wan", "fflf")
class WanFFLFEngine(WanI2VEngine):
    """First–last-frame interpolation: i2v conditioning where both endpoint
    frames are valid (condition = [temporal mask with the first and last
    frames set | VAE of (first, zeros, last)]) and the CLIP branch, where the
    DiT has one, sees both endpoints' features concatenated (Sk 514)."""

    _fflf_last: Optional[np.ndarray] = None

    def run(self, image: Any = None, last_image: Any = None, **kwargs: Any):
        if image is None or last_image is None:
            raise ValueError("fflf requires both `image` (first frame) and `last_image`")
        self._fflf_last = self.load_image_input(last_image if _is_path(last_image) else np.asarray(last_image))
        try:
            return super().run(image=image, **kwargs)
        finally:
            self._fflf_last = None

    @torch.inference_mode()
    def build_condition(self, image: np.ndarray, num_frames: int, height: int, width: int) -> torch.Tensor:
        import cv2

        t_scale = self.vae.cfg.temporal_scale
        first, last = _pixels(_resized([image, self._fflf_last], width, height, cv2.INTER_LANCZOS4)).unbind(2)
        video = torch.cat([first[:, :, None], torch.zeros(1, 3, num_frames - 2, height, width),
                           last[:, :, None]], dim=2)
        latent_condition = self.encode_video_latents(video)
        lat_h, lat_w = latent_condition.shape[-2:]
        valid = np.zeros((1, 1, num_frames, lat_h, lat_w), np.float32)
        valid[:, :, 0] = valid[:, :, -1] = 1.0
        mask = torch.from_numpy(_packed_frame_mask(valid, t_scale)).to(self.device)
        return torch.cat([mask, latent_condition], dim=1)

    def encode_image_clip(self, image: np.ndarray) -> torch.Tensor:
        return torch.cat([super().encode_image_clip(image), super().encode_image_clip(self._fflf_last)], dim=1)


@register_engine("wan", "inp")
class WanInpaintEngine(WanI2VEngine):
    """Video inpainting: condition = [the known region's validity (1 − mask),
    area-resized to the latent grid and packed as the i2v temporal mask | VAE
    of the video with the region to regenerate zeroed]. Mask: 1 = regenerate,
    0 = keep; one mask serves every frame. The i2v denoise loop (the CLIP
    branch of the first frame where the DiT has one)."""

    _inp_frames: Optional[List[np.ndarray]] = None
    _inp_masks: Optional[List[np.ndarray]] = None

    def run(self, video: Any = None, mask: Any = None, image: Any = None, **kwargs: Any):
        from apex_studio_tpu_torch.preprocess.base import load_frames

        if video is None:
            raise ValueError("inp requires an input video")
        if mask is None:
            raise ValueError("inp requires a mask (image or video)")
        if _is_path(video):
            video = load_frames(video)
        self._inp_frames = [self.load_image_input(np.asarray(f)) for f in video]
        if _is_path(mask):
            mask = load_frames(mask)
        if isinstance(mask, np.ndarray) and mask.ndim in (2, 3):
            mask = [mask]
        self._inp_masks = [np.asarray(m) for m in mask]
        kwargs.setdefault("num_frames", len(self._inp_frames))
        try:
            return super().run(image=self._inp_frames[0], **kwargs)
        finally:
            self._inp_frames = self._inp_masks = None

    def encode_image_clip(self, image: np.ndarray) -> torch.Tensor:
        return super().encode_image_clip(self._inp_frames[0])

    def _mask_at(self, i: int, height: int, width: int) -> np.ndarray:
        """[H, W] f32 in {0, 1}, 1 = inpaint."""
        import cv2

        m = self._inp_masks[min(i, len(self._inp_masks) - 1)]
        if m.ndim == 3:
            m = m[..., 0]
        m = cv2.resize(m.astype(np.float32), (width, height), interpolation=cv2.INTER_NEAREST)
        return (m > 127).astype(np.float32) if m.max() > 1.0 else (m > 0.5).astype(np.float32)

    @torch.inference_mode()
    def build_condition(self, image: np.ndarray, num_frames: int, height: int, width: int) -> torch.Tensor:
        import cv2

        t_scale = self.vae.cfg.temporal_scale
        frames = self._inp_frames[:num_frames]
        frames += [frames[-1]] * (num_frames - len(frames))
        masks = np.stack([self._mask_at(i, height, width) for i in range(num_frames)])
        # the region to regenerate zeroed
        video = _pixels(_resized(frames, width, height, cv2.INTER_LANCZOS4)) * torch.from_numpy(1.0 - masks)[None, None]
        latent_condition = self.encode_video_latents(video)
        lat_h, lat_w = latent_condition.shape[-2:]
        valid = np.stack([cv2.resize(v, (lat_w, lat_h), interpolation=cv2.INTER_AREA) for v in 1.0 - masks])
        packed = _packed_frame_mask(valid[None, None].astype(np.float32), t_scale)
        return torch.cat([torch.from_numpy(packed).to(self.device), latent_condition], dim=1)


@register_engine("wan", "svi")
class WanSVIEngine(WanI2VEngine):
    """Stable Video Infinity: a long video as chained i2v segments, each
    anchored on the frame ``num_motion_frame`` from the end of the previous
    one, consecutive segments cross-faded linearly over
    ``num_overlap_frames`` frames, each with its own prompt (``prompts``)
    and seed ``seed + segment``."""

    def run(
        self,
        image: Any = None,
        prompt: Optional[Any] = None,
        prompts: Optional[List[str]] = None,
        negative_prompt: Optional[str] = None,
        height: int = 480,
        width: int = 832,
        duration: Any = 10.0,
        fps: int = 16,
        num_frames: Optional[int] = None,
        num_frames_per_segment: int = 81,
        num_inference_steps: int = 30,
        guidance_scale: float = 5.0,
        seed: Optional[int] = None,
        num_overlap_frames: int = 4,
        num_motion_frame: int = 4,
        return_latents: bool = False,
        progress_callback: Optional[Callable] = None,
        **kwargs: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting SVI pipeline")
        if num_frames is None:
            num_frames = int(round(float(duration) * fps)) + 1
        seg_prompts = list(prompts) if prompts else [prompt or ""]
        # frames gained a segment after the first shrink by the blended overlap
        step = max(1, num_frames_per_segment - num_overlap_frames)
        n_segments = max(len(seg_prompts), 1 + max(0, int(np.ceil((num_frames - num_frames_per_segment) / step))))
        seg_prompts += [seg_prompts[-1]] * (n_segments - len(seg_prompts))

        all_frames: List[np.ndarray] = []
        anchor = image
        for si in range(n_segments):
            cb = make_mapped_progress(progress_callback, 0.05 + 0.9 * si / n_segments,
                                      0.05 + 0.9 * (si + 1) / n_segments)
            seg = super().run(image=anchor, prompt=seg_prompts[si], negative_prompt=negative_prompt,
                              height=height, width=width, num_frames=num_frames_per_segment,
                              num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
                              seed=None if seed is None else seed + si, progress_callback=cb, **kwargs)
            if si == 0:
                all_frames.extend(seg)
            else:
                k = min(num_overlap_frames, len(all_frames), len(seg))
                for j in range(k):
                    w_new = (j + 1) / (k + 1)
                    mixed = (1 - w_new) * all_frames[-k + j].astype(np.float32) + w_new * seg[j].astype(np.float32)
                    all_frames[-k + j] = np.clip(mixed + 0.5, 0, 255).astype(np.uint8)
                all_frames.extend(seg[k:])
            anchor = seg[-max(1, num_motion_frame)]
        safe_emit_progress(progress_callback, 1.0, "SVI pipeline complete")
        return all_frames[:num_frames]


class _HostLoop(WanShared):
    """The engines that step one DiT on the host (VACE, Phantom, Fun):
    geometry, prompts and the loop, CFG in the DiT's dtype as in JAX."""

    def _lat_geometry(self, height: int, width: int, num_frames: Optional[int], duration: Optional[float],
                      fps: int):
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        t_scale, s_scale = self.vae.cfg.temporal_scale, self.vae.cfg.spatial_scale
        num_frames = max(1, num_frames - (num_frames - 1) % t_scale)
        return num_frames, (num_frames - 1) // t_scale + 1, height // s_scale, width // s_scale

    def _encode_images(self, images, height: int, width: int) -> List[torch.Tensor]:
        """Each image area-resized to the request's size and VAE-encoded:
        [1, z, 1, h, w] each."""
        import cv2

        arrs = [cv2.resize(self.load_image_input(im), (width, height), interpolation=cv2.INTER_AREA)
                for im in images]
        return [self.encode_video_latents(_pixels([a])) for a in arrs]

    def _control_video(self, media, num_frames: int, height: int, width: int) -> List[np.ndarray]:
        """Frames area-resized, the last repeated up to ``num_frames``."""
        import cv2

        from apex_studio_tpu_torch.preprocess.base import load_frames

        frames = _resized(load_frames(media) if isinstance(media, str) else list(media), width, height,
                          cv2.INTER_AREA)
        frames += [frames[-1]] * (num_frames - len(frames))
        return frames[:num_frames]

    def _host_loop(self, x, ts, forward, guidance_scale: float, context, neg_context, progress_callback):
        """``forward(x, t, ctx) -> v`` in the DiT's dtype; CFG in that dtype,
        ``scheduler.step`` on the f32 latents."""
        dt = self.transformer.dtype
        ctx, nctx = context.to(dt), neg_context.to(dt)
        cb = make_mapped_progress(progress_callback, 0.4, 0.9)
        for i, t in enumerate(np.asarray(ts, np.float64)):
            t_b = torch.full((1,), float(t), dtype=torch.float32, device=self.device)
            x_in = x.to(dt)
            v = forward(x_in, t_b, ctx)
            if guidance_scale > 1.0:
                neg = forward(x_in, t_b, nctx)
                v = neg + guidance_scale * (v - neg)
            (x,) = self.scheduler.step(v.float(), float(t), x)
            safe_emit_progress(cb, (i + 1) / len(ts), f"Denoising step {i + 1}/{len(ts)}")
        return x

    def _finish(self, x, progress_callback, return_latents: bool):
        safe_emit_progress(progress_callback, 0.9, "Denoising complete")
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self.decode_latents(x)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames


@register_engine("wan", "vace")
class WanVaceEngine(_HostLoop):
    """VACE all-in-one video editing: a control video (optionally masked)
    and reference images condition the DiT's VACE branch.

    The control is [inactive | reactive] VAE latents of the video outside and
    inside the mask plus the mask's 8 × 8 space-to-depth (64 channels) at the
    latent frame rate: 96 channels. Each reference image's latents, zero-padded
    to 32 channels, are prepended in time (the mask gets zero frames there); the
    noise has those frames too, and they are dropped before the decode."""

    def _space_to_depth_mask(self, mask_f: np.ndarray, lat_f: int, lat_h: int, lat_w: int) -> torch.Tensor:
        """Mask frames (F, H, W) in {0, 1} → (s², lat_f, lat_h, lat_w), frames
        taken by the index rule of ``jax.image.resize(..., "nearest")``:
        ⌊f32((i + 0.5)·F) / f32(lat_f)⌋."""
        f = mask_f.shape[0]
        s = self.vae.cfg.spatial_scale
        m = mask_f.reshape(f, lat_h, s, lat_w, s).transpose(2, 4, 0, 1, 3).reshape(s * s, f, lat_h, lat_w)
        if f != lat_f:
            m = m[:, nearest_index(f, lat_f)]
        return torch.from_numpy(np.ascontiguousarray(m, dtype=np.float32))

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        video: Optional[Any] = None,
        mask: Optional[Any] = None,
        reference_images: Optional[Any] = None,
        conditioning_scale: Any = 1.0,
        height: int = 480,
        width: int = 832,
        duration: Optional[float] = None,
        num_frames: Optional[int] = None,
        fps: int = 16,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        seed: Optional[int] = None,
        timesteps: Optional[List[float]] = None,
        return_latents: bool = False,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting VACE pipeline")
        self.load_components(return_latents)
        num_frames, lat_f, lat_h, lat_w = self._lat_geometry(height, width, num_frames, duration, fps)
        context = self.encode_prompt(prompt or "")
        neg_context = self.encode_prompt(negative_prompt or "")
        safe_emit_progress(progress_callback, 0.15, "Prompts encoded")

        # -- the control video and its mask
        if video is not None:
            vid = _pixels(self._control_video(video, num_frames, height, width))
        else:
            vid = torch.zeros(1, 3, num_frames, height, width)
        if mask is not None:
            m = np.stack([np.asarray(fr).mean(axis=-1) for fr in self._control_video(mask, num_frames, height, width)])
            mask_f = (m > 127.5).astype(np.float32)  # (F, H, W)
        else:
            mask_f = np.ones((num_frames, height, width), np.float32)
        mgrid = torch.from_numpy(mask_f)[None, None]
        if video is not None and mask is not None:
            vid = vid * (1 - mgrid)  # the masked pixels to mid-grey (0 in [-1, 1])
        inactive = self.encode_video_latents(vid * (1 - mgrid))
        reactive = self.encode_video_latents(vid * mgrid)
        control = torch.cat([inactive, reactive], dim=1)  # [1, 2z, f, h, w]
        safe_emit_progress(progress_callback, 0.3, "Control video encoded")

        # -- reference images, prepended in time
        refs = _as_list(reference_images)
        for rz in reversed(self._encode_images(refs, height, width)):
            control = torch.cat([torch.cat([rz, torch.zeros_like(rz)], dim=1), control], dim=2)
        m64 = self._space_to_depth_mask(mask_f, lat_f, lat_h, lat_w)[None].to(self.device)
        m64 = torch.cat([m64.new_zeros(1, m64.shape[1], len(refs), lat_h, lat_w), m64], dim=2)
        control = torch.cat([control, m64], dim=1)  # [1, 96, f + refs, h, w]

        n_vace = len(self.transformer.cfg.vace_layers)
        if isinstance(conditioning_scale, (int, float)):
            scales = torch.full((n_vace,), float(conditioning_scale), dtype=torch.float32, device=self.device)
        else:
            scales = torch.as_tensor(np.asarray(conditioning_scale, np.float32), device=self.device)

        x = self.get_latents((1, self.transformer.cfg.in_channels, lat_f + len(refs), lat_h, lat_w), seed=seed)
        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps, timesteps=timesteps)
        safe_emit_progress(progress_callback, 0.4, "Latents ready; denoising")
        ctl = control.to(self.transformer.dtype)
        x = self._host_loop(x, ts, lambda xi, t, c: self.transformer(xi, t, c, control=ctl, control_scale=scales),
                            guidance_scale, context, neg_context, progress_callback)
        if return_latents:
            return self._finish(x, progress_callback, True)
        return self._finish(x[:, :, len(refs):], progress_callback, False)


@register_engine("wan", "fun_vace")
class WanFunVaceEngine(WanVaceEngine):
    """Fun-VACE: VACE driven by Fun-style inputs. Start / end images become a
    sparse control video whose mask keeps those frames; a control video
    rides the VACE channels unmasked; subject references are VACE's
    reference images. ``high_noise_guidance_scale`` replaces the guidance; as
    in JAX, ``boundary_ratio`` is accepted and one DiT runs every step."""

    def run(
        self,
        start_image: Any = None,
        end_image: Any = None,
        control_video: Any = None,
        subject_ref_images: Any = None,
        video: Any = None,
        mask_video: Any = None,
        num_frames: Optional[int] = None,
        duration: Optional[float] = None,
        fps: int = 16,
        height: int = 480,
        width: int = 832,
        boundary_ratio: Optional[float] = None,
        high_noise_guidance_scale: Optional[float] = None,
        low_noise_guidance_scale: Optional[float] = None,
        guidance_scale: float = 6.0,
        **kwargs: Any,
    ):
        import cv2

        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        t_scale = 4 if self.vae is None else self.vae.cfg.temporal_scale
        num_frames = max(1, num_frames - (num_frames - 1) % t_scale)
        if video is None and control_video is not None:
            video, mask_video = control_video, None
        elif video is None and (start_image is not None or end_image is not None):
            # a sparse keyframe video; the mask keeps the known frames
            frames = [np.zeros((height, width, 3), np.uint8) for _ in range(num_frames)]
            mframes = [np.full((height, width, 3), 255, np.uint8) for _ in range(num_frames)]
            for i, im in ((0, start_image), (-1, end_image)):
                if im is not None:
                    frames[i] = cv2.resize(self.load_image_input(im), (width, height), interpolation=cv2.INTER_AREA)
                    mframes[i][:] = 0
            video, mask_video = frames, mframes
        g = high_noise_guidance_scale if high_noise_guidance_scale is not None else guidance_scale
        kwargs.setdefault("reference_images", subject_ref_images)
        return super().run(video=video, mask=mask_video, num_frames=num_frames, fps=fps, height=height,
                           width=width, guidance_scale=g, **kwargs)


@register_engine("wan", "phantom")
class WanPhantomEngine(_HostLoop):
    """Subject-consistent generation: the subject reference images' latents
    ride along as tokens appended in time (``WanFunTransformer3DModel``)."""

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        subject_reference_images: Optional[Any] = None,
        height: int = 480,
        width: int = 832,
        duration: Optional[float] = None,
        num_frames: Optional[int] = None,
        fps: int = 16,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        seed: Optional[int] = None,
        timesteps: Optional[List[float]] = None,
        return_latents: bool = False,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting Phantom pipeline")
        self.load_components(return_latents)
        num_frames, lat_f, lat_h, lat_w = self._lat_geometry(height, width, num_frames, duration, fps)
        context = self.encode_prompt(prompt or "")
        neg_context = self.encode_prompt(negative_prompt or "")
        refs = _as_list(subject_reference_images)
        subject_ref = torch.cat(self._encode_images(refs, height, width), dim=2) if refs else None
        safe_emit_progress(progress_callback, 0.25, "Conditioning ready")
        x = self.get_latents((1, self.transformer.cfg.in_channels, lat_f, lat_h, lat_w), seed=seed)
        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps, timesteps=timesteps)
        ref = None if subject_ref is None else subject_ref.to(self.transformer.dtype)
        x = self._host_loop(x, ts, lambda xi, t, c: self.transformer(xi, t, c, subject_ref=ref),
                            guidance_scale, context, neg_context, progress_callback)
        return self._finish(x, progress_callback, return_latents)


@register_engine("wan", "fun_control")
class WanFunControlEngine(_HostLoop):
    """Fun-Control: a control video (a pose or depth render) VAE-encoded and
    concatenated in channels after the noise every step (the noise takes the
    DiT's ``in_channels`` less the control's); an optional reference image
    rides as subject tokens."""

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        control_video: Optional[Any] = None,
        video: Optional[Any] = None,
        ref_image: Optional[Any] = None,
        height: int = 480,
        width: int = 832,
        duration: Optional[float] = None,
        num_frames: Optional[int] = None,
        fps: int = 16,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        seed: Optional[int] = None,
        timesteps: Optional[List[float]] = None,
        return_latents: bool = False,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting Fun-Control pipeline")
        self.load_components(return_latents)
        control_video = control_video if control_video is not None else video
        num_frames, lat_f, lat_h, lat_w = self._lat_geometry(height, width, num_frames, duration, fps)
        context = self.encode_prompt(prompt or "")
        neg_context = self.encode_prompt(negative_prompt or "")
        if control_video is not None:
            control = self.encode_video_latents(_pixels(self._control_video(control_video, num_frames, height,
                                                                            width)))
        else:
            control = torch.zeros(1, self.vae.cfg.z_dim, lat_f, lat_h, lat_w, device=self.device)
        subject_ref = self._encode_images([ref_image], height, width)[0] if ref_image is not None else None
        safe_emit_progress(progress_callback, 0.25, "Control encoded")
        x = self.get_latents((1, self.transformer.cfg.in_channels - control.shape[1], lat_f, lat_h, lat_w),
                             seed=seed)
        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps, timesteps=timesteps)
        return self._finish(self._fun_loop(x, control, subject_ref, ts, guidance_scale, context, neg_context,
                                           progress_callback), progress_callback, return_latents)

    def _fun_loop(self, x, control, subject_ref, ts, guidance_scale, context, neg_context, progress_callback):
        dt = self.transformer.dtype
        ctl = control.to(dt)
        ref = None if subject_ref is None else subject_ref.to(dt)
        return self._host_loop(
            x, ts, lambda xi, t, c: self.transformer(torch.cat([xi, ctl], dim=1), t, c, subject_ref=ref),
            guidance_scale, context, neg_context, progress_callback)


@register_engine("wan", "fun")
class WanFunEngine(WanFunControlEngine):
    """Wan Fun: the channels after the noise are [control video latents or
    zeros | a start-image block: zeros with the start image's latents at the
    first frame and the end image's at the last], cut to the DiT's
    ``in_channels`` less the noise's; subject references append as tokens."""

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        start_image: Optional[Any] = None,
        image: Optional[Any] = None,
        end_image: Optional[Any] = None,
        subject_reference_images: Optional[Any] = None,
        control_video: Optional[Any] = None,
        reference_image: Optional[Any] = None,
        height: int = 480,
        width: int = 832,
        duration: Optional[float] = None,
        num_frames: Optional[int] = None,
        fps: int = 16,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        seed: Optional[int] = None,
        timesteps: Optional[List[float]] = None,
        return_latents: bool = False,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting Fun pipeline")
        self.load_components(return_latents)
        start_image = start_image if start_image is not None else image
        num_frames, lat_f, lat_h, lat_w = self._lat_geometry(height, width, num_frames, duration, fps)
        z_ch = self.vae.cfg.z_dim
        context = self.encode_prompt(prompt or "")
        neg_context = self.encode_prompt(negative_prompt or "")
        if control_video is not None:
            control = self.encode_video_latents(_pixels(self._control_video(control_video, num_frames, height,
                                                                            width)))
        else:
            control = torch.zeros(1, z_ch, lat_f, lat_h, lat_w, device=self.device)
        start_block = torch.zeros(1, z_ch, lat_f, lat_h, lat_w, device=self.device)
        if start_image is not None:
            start_block[:, :, :1] = self._encode_images([start_image], height, width)[0]
        if end_image is not None:
            start_block[:, :, -1:] = self._encode_images([end_image], height, width)[0]
        cond = torch.cat([control, start_block], dim=1)[:, :self.transformer.cfg.in_channels - z_ch]
        refs = _as_list(subject_reference_images or reference_image)
        subject_ref = torch.cat(self._encode_images(refs, height, width), dim=2) if refs else None
        x = self.get_latents((1, z_ch, lat_f, lat_h, lat_w), seed=seed)
        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps, timesteps=timesteps)
        return self._finish(self._fun_loop(x, cond, subject_ref, ts, guidance_scale, context, neg_context,
                                           progress_callback), progress_callback, return_latents)


@register_engine("wan", "causal")
class WanCausalEngine(WanShared):
    """Autoregressive block-causal generation (Self-Forcing / CausVid class).

    Latent frames are generated ``num_frame_per_block`` at a time. Each
    block runs a few-step x0-renoise loop (x0 = x − σ·flow at t, re-noised to
    the next t with fresh noise from a numpy generator seeded by ``seed``)
    against the K/V cache of the committed blocks, then is committed: one
    more forward at ``context_noise`` writes its K/V into the cache. An image
    (one latent frame) or a video pre-fills the cache at t = 0.
    ``local_attn_size`` / ``sink_size`` (latent frames) bound the keys a
    block attends to. The cache holds every frame of the request, ``S_max``
    tokens; each forward attends over all of them with a validity mask, as in
    JAX."""

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        image: Any = None,
        video: Any = None,
        height: int = 480,
        width: int = 832,
        duration: Optional[float] = None,
        fps: int = 16,
        num_frames: Optional[int] = None,
        num_inference_steps: int = 4,
        num_frame_per_block: int = 3,
        context_noise: float = 0.0,
        local_attn_size: int = -1,
        sink_size: int = 0,
        seed: Optional[int] = None,
        timesteps: Optional[List[float]] = None,
        return_latents: bool = False,
        render_on_step: bool = False,
        render_on_step_callback: Optional[Callable] = None,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting causal pipeline")
        self.load_components(return_latents)
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        height, width, num_frames, lat_t, lat_h, lat_w = self._geometry(height, width, num_frames)
        context = self.encode_prompt(prompt or "")
        safe_emit_progress(progress_callback, 0.1, "Prompt encoded")

        tf = self.transformer
        _, ph, pw = tf.cfg.patch_size
        h_tok, w_tok = lat_h // ph, lat_w // pw
        frame_seq = h_tok * w_tok
        initial = None
        if image is not None:
            arr = cv2.resize(self.load_image_input(image), (width, height), interpolation=cv2.INTER_LANCZOS4)
            initial = self.encode_video_latents(_pixels([arr]))
        elif video is not None:
            initial = self.encode_video_latents(_pixels([self.load_image_input(np.asarray(f)) for f in video]))
        n_input = 0 if initial is None else initial.shape[2]

        num_blocks = lat_t // num_frame_per_block
        gen_frames = num_blocks * num_frame_per_block
        total_frames = n_input + gen_frames
        s_max = total_frames * frame_seq
        noise = self.get_latents((1, tf.cfg.in_channels, gen_frames, lat_h, lat_w), seed=seed)
        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps, timesteps=timesteps)
        rng = np.random.default_rng(0 if seed is None else seed)  # the re-noise draws
        k_cache, v_cache = tf.init_cache(1, s_max, device=self.device)
        self.kv_cache = (k_cache, v_cache)
        local_tokens = local_attn_size * frame_seq if local_attn_size > 0 else -1
        sink_tokens = sink_size * frame_seq
        blk_shape = (1, tf.cfg.in_channels, num_frame_per_block, lat_h, lat_w)

        def forward(x, t_value, n_frames, start_frame):
            t_frames = torch.full((1, n_frames), float(t_value), dtype=torch.float32, device=self.device)
            rope = tf.causal_rope_tables(start_frame, n_frames, h_tok, w_tok, device=self.device)
            flow, _ = tf.forward_causal(x.to(tf.dtype), t_frames, context, k_cache, v_cache,
                                        start_frame * frame_seq, *rope, local_tokens=local_tokens,
                                        sink_tokens=sink_tokens)
            return flow

        output = torch.zeros(1, tf.cfg.in_channels, total_frames, lat_h, lat_w, device=self.device)
        if initial is not None:
            output[:, :, :n_input] = initial
            forward(initial.float(), 0.0, n_input, 0)  # the pre-fill: its K/V at t = 0
        safe_emit_progress(progress_callback, 0.2, "Cache pre-filled; generating")

        denoise_cb = make_mapped_progress(progress_callback, 0.2, 0.9)
        total_steps, done = num_blocks * len(ts), 0
        for b_idx in range(num_blocks):
            lo = b_idx * num_frame_per_block
            start_frame = n_input + lo
            x = noise[:, :, lo:lo + num_frame_per_block].float()
            for i, t in enumerate(ts):
                sigma = float(np.float32(float(t) / 1000.0))
                sigma_next = float(np.float32(float(ts[i + 1]) / 1000.0)) if i + 1 < len(ts) else 0.0
                if i + 1 < len(ts):
                    fresh = torch.from_numpy(rng.standard_normal(blk_shape).astype(np.float32)).to(self.device)
                else:
                    fresh = torch.zeros(blk_shape, device=self.device)
                flow = forward(x, t, num_frame_per_block, start_frame).float()
                x = (1.0 - sigma_next) * (x - sigma * flow) + sigma_next * fresh
                done += 1
                if denoise_cb is not None:
                    denoise_cb(done / total_steps, f"Causal step {done}/{total_steps}")
            output[:, :, start_frame:start_frame + num_frame_per_block] = x
            # commit: the finished block's K/V at context_noise
            forward(x, context_noise, num_frame_per_block, start_frame)
            if render_on_step and render_on_step_callback is not None:
                try:
                    render_on_step_callback(self.decode_latents(output[:, :, :start_frame + num_frame_per_block]),
                                            b_idx)
                except Exception:
                    logger.exception("preview callback failed")

        safe_emit_progress(progress_callback, 0.9, "Causal generation complete")
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return output
        frames = self.decode_latents(output)
        safe_emit_progress(progress_callback, 1.0, "Completed causal pipeline")
        return frames


def _check_audio_encoder(encoder, n_states: int, width: int, what: str) -> None:
    """The encoder's hidden states (its layers + the embeddings) and width
    against what the DiT takes; a mismatch raises before the DiT runs."""
    have = (encoder.cfg.num_hidden_layers + 1, encoder.cfg.hidden_size)
    if have != (n_states, width):
        raise ValueError(f"the audio encoder gives {have[0]} hidden states of {have[1]}; {what} takes "
                         f"{n_states} of {width}")


@register_engine("wan", "humo")
class WanHuMoEngine(WanShared):
    """HuMo: human video from text and audio, with reference images. The
    reference latents take the last latent slots, flagged by the 4-channel
    mask; each latent frame's window of stacked wav2vec2 states drives the
    DiT's per-frame audio cross-attention. Guidance blends the audio and text
    deltas, ``a·(TIA − TI) + t·(TI − neg) + neg`` in the DiT's dtype, the
    negative branch image-conditioned above ``step_change`` and fully null
    below it (where the text scale drops by 2); without references (TA) the
    image condition is null throughout. The JAX engine computes both negative
    branches every step and selects one; this one computes the selected one.
    It also encodes the prompts (then releases UMT5) and the condition video
    before the DiT loads; JAX loads every component first. The scheduler
    steps on the host, as in JAX."""

    @staticmethod
    def audio_windows(emb: np.ndarray, frame_num: int, t_scale: int, shift: int = 2) -> np.ndarray:
        """[F_pix, blocks, C] → [T_lat, t_scale + 2·shift, blocks, C]: latent
        frame 0 sees pixel frames −shift..shift, frame l the t_scale frames
        from 1 + t_scale·(l − 1) and shift on each side; frames outside are
        zero rows."""
        n_lat = 1 + (frame_num - 1) // t_scale
        n_rows = t_scale + 2 * shift
        zero = np.zeros(emb.shape[1:], emb.dtype)

        def row(i):
            return emb[i] if 0 <= i < emb.shape[0] else zero

        wind = []
        for lt in range(n_lat):
            if lt == 0:
                rows = [zero] * (n_rows - (2 * shift + 1)) + [row(i) for i in range(-shift, shift + 1)]
            else:
                st = 1 + t_scale * (lt - 1) - shift
                rows = [row(i) for i in range(st, st + n_rows)]
            wind.append(np.stack(rows))
        return np.stack(wind)

    @torch.inference_mode()
    def encode_audio_stack(self, audio: Any, sampling_rate: int, frame_num: int) -> np.ndarray:
        """Waveform (array or WAV file) → [F_pix, blocks, C]: the wav2vec2
        hidden states after the embeddings, resampled to one row a pixel
        frame, stacked."""
        from apex_studio_tpu_torch.utils.media import load_audio

        wav = load_audio(audio, sampling_rate)
        wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)
        encoder = self.load_helper("audio_encoder")
        cfg = self.transformer.cfg
        _check_audio_encoder(encoder, cfg.audio_blocks + 1, cfg.audio_channels, "the HuMo DiT")
        states = encoder(torch.from_numpy(np.ascontiguousarray(wav, np.float32))[None].to(self.device),
                         seq_len=frame_num)
        return torch.stack(states[1:], dim=0)[:, 0].transpose(0, 1).float().cpu().numpy()

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        audio: Any = None,
        image: Any = None,
        negative_prompt: Optional[str] = None,
        height: int = 480,
        width: int = 832,
        duration: Optional[float] = None,
        fps: int = 25,
        num_frames: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale_a: float = 5.5,
        guidance_scale_t: float = 5.0,
        step_change: int = 980,
        sampling_rate: int = 16000,
        seed: Optional[int] = None,
        return_latents: bool = False,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting HuMo pipeline")
        # the prompts encode, and the VAE encodes the condition, before the
        # DiT loads: at 97 frames the zero video's encode alone takes most of
        # the card
        if self.text_encoder is None:
            self.load_component_by_type("text_encoder")
        context = self.encode_prompt(prompt or "")
        use_cfg = guidance_scale_t > 1.0 and negative_prompt is not None
        neg_context = self.encode_prompt(negative_prompt) if use_cfg else None
        self.maybe_release_text_encoders()
        safe_emit_progress(progress_callback, 0.1, "Prompts encoded")
        if self.vae is None:
            self.load_component_by_type("vae")
        t_scale, s_scale = self.vae.cfg.temporal_scale, self.vae.cfg.spatial_scale
        if num_frames is None:
            num_frames = int(round((duration or 3.9) * fps)) + 1
        num_frames = max(1, t_scale * ((num_frames - 1) // t_scale) + 1)
        height -= height % (s_scale * 2)
        width -= width % (s_scale * 2)
        lat_t = (num_frames - 1) // t_scale + 1
        lat_h, lat_w = height // s_scale, width // s_scale
        z = self.vae.cfg.z_dim

        # reference latents, in the last latent slots
        refs = [self.encode_video_latents(_pixels(_resized([self.load_image_input(r)], width, height,
                                                           cv2.INTER_LANCZOS4)))
                for r in _as_list(image)]
        tia_mode = bool(refs)
        ref_lat = (torch.cat(refs, dim=2).float() if refs
                   else torch.zeros(1, z, 1, lat_h, lat_w, device=self.device))
        n_ref = ref_lat.shape[2]
        # the condition: the mask flags the trailing reference slots
        zero_vae = self.encode_video_latents(torch.zeros(1, 3, num_frames, height, width)).float()
        mask = torch.zeros(1, t_scale, lat_t, lat_h, lat_w, device=self.device)
        mask[:, :, lat_t - n_ref:] = 1.0
        y_c = torch.cat([mask, torch.cat([zero_vae[:, :, :lat_t - n_ref], ref_lat], dim=2)], dim=1)
        y_null = torch.cat([mask, zero_vae[:, :, :lat_t]], dim=1)
        del zero_vae
        self.load_components(return_latents=False)
        tf = self.transformer

        # audio windows, zero rows for the reference slots
        if audio is not None:
            stack = self.encode_audio_stack(audio, sampling_rate, num_frames)
        else:
            stack = np.zeros((num_frames, tf.cfg.audio_blocks, tf.cfg.audio_channels), np.float32)
        wind = self.audio_windows(stack, num_frames, t_scale)
        wind = np.concatenate([wind, np.zeros((n_ref,) + wind.shape[1:], wind.dtype)], axis=0)
        audio_w = torch.from_numpy(wind)[None].to(self.device)
        audio_zero = torch.zeros_like(audio_w)
        safe_emit_progress(progress_callback, 0.2, "Audio encoded")

        x = self.get_latents((1, z, lat_t, lat_h, lat_w), seed=seed)
        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps)
        g_a, g_t = guidance_scale_a, guidance_scale_t
        cb = make_mapped_progress(progress_callback, 0.25, 0.9)
        for i, tstep in enumerate(ts):
            t_b = torch.full((1,), float(tstep), dtype=torch.float32, device=self.device)
            hi = float(tstep) > step_change
            xd = x.to(tf.dtype)
            if tia_mode:
                tia = tf(xd, t_b, context, audio_w, y_c)
                ti = tf(xd, t_b, context, audio_zero, y_c)
                neg = tf(xd, t_b, neg_context, audio_zero, y_c if hi else y_null) if use_cfg else ti
                t_sc = g_t if hi or not use_cfg else g_t - 2.0
                v = g_a * (tia - ti) + t_sc * (ti - neg) + neg
            else:
                ta = tf(xd, t_b, context, audio_w, y_null)
                t_only = tf(xd, t_b, context, audio_zero, y_null)
                neg = tf(xd, t_b, neg_context, audio_zero, y_null) if use_cfg else t_only
                v = g_a * (ta - t_only) + g_t * (t_only - neg) + neg
            (x,) = self.scheduler.step(v.float(), float(tstep), x)
            safe_emit_progress(cb, (i + 1) / len(ts), f"Denoising step {i + 1}/{len(ts)}")

        safe_emit_progress(progress_callback, 0.9, "Denoising complete")
        video_lat = x[:, :, :lat_t - n_ref] if tia_mode else x
        if return_latents:
            return video_lat
        frames = self.decode_latents(video_lat)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames


@register_engine("wan", "s2v")
class WanS2VEngine(WanShared):
    """Speech-to-video, chunk-autoregressive: each chunk of
    ``num_frames_per_chunk`` frames denoises fresh latents conditioned on the
    reference image (RoPE t = 30), a rolling 73-frame motion buffer (negative
    RoPE times), the wav2vec2 states injected per latent frame and, given a
    pose video, its VAE latents (reverse-padded to the clip's length and
    encoded chunk by chunk). CFG zeroes the audio in the negative branch. The
    first chunk drops the motion tokens (``drop_first_motion``) unless
    ``init_first_frame`` seeds the buffer with the image; each chunk decodes
    [motion ‖ x] (or [condition ‖ x]) and the motion latents are re-encoded
    from the last pixels. The scheduler steps on the host, as in JAX.

    The prompts encode before the DiT loads and UMT5 is released after them;
    JAX loads every component first and keeps UMT5. The decodes take the Wan
    engines' whole-or-tiled rule by the latent's size (JAX decodes each chunk
    whole); at the tests' sizes both are whole. As in JAX, the request
    returns frames (``return_latents`` is not read)."""

    motion_frames = 73
    drop_first_motion = True

    @torch.inference_mode()
    def encode_audio(self, audio: Any, sampling_rate: int, num_frames: int, fps: int = 16):
        """→ ([1, L, C_a, frames] wav2vec2 states a video frame, chunks): all
        hidden states, 50 Hz resampled to 30 fps, then picked at ``fps`` over
        whole buckets of ``num_frames``."""
        from apex_studio_tpu_torch.models.audio.wav2vec2 import interpolate_linear
        from apex_studio_tpu_torch.utils.media import load_audio

        wav = load_audio(audio, sampling_rate)
        wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)  # zero mean, unit variance
        encoder = self.load_helper("audio_encoder")
        _check_audio_encoder(encoder, self.transformer.cfg.num_wav2vec_layers, self.transformer.cfg.audio_dim,
                             "the S2V DiT")
        states = encoder(torch.from_numpy(np.ascontiguousarray(wav, np.float32))[None].to(self.device))
        feat = torch.cat(states, dim=0)  # [L + 1, T, D]
        video_rate = 30
        out_len = int(feat.shape[1] / 50.0 * video_rate)  # 50 Hz → 30 fps
        feat = interpolate_linear(feat, max(out_len, 1)).float().cpu().numpy()
        n_layers, audio_frame_num, audio_dim = feat.shape

        scale = video_rate / fps
        num_repeat = int(audio_frame_num / (num_frames * scale)) + 1
        bucket = num_repeat * num_frames
        duration = bucket / fps
        total = int(np.ceil(duration * video_rate))
        times = np.linspace(0.0, duration, bucket, endpoint=False)
        idx = np.clip(np.round(times * video_rate).astype(int), 0, total - 1)
        rows = np.zeros((bucket, n_layers, audio_dim), np.float32)
        valid = idx < audio_frame_num
        rows[valid] = feat[:, np.clip(idx[valid], 0, audio_frame_num - 1)].transpose(1, 0, 2)
        return torch.from_numpy(np.ascontiguousarray(rows.transpose(1, 2, 0)))[None].to(self.device), num_repeat

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        audio: Any = None,
        image: Any = None,
        sampling_rate: int = 16000,
        negative_prompt: Optional[str] = None,
        pose_video: Any = None,
        height: int = 480,
        width: int = 832,
        num_frames_per_chunk: int = 80,
        num_inference_steps: int = 40,
        guidance_scale: float = 4.5,
        fps: int = 16,
        seed: Optional[int] = None,
        num_chunks: Optional[int] = None,
        init_first_frame: bool = False,
        return_latents: bool = False,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting s2v pipeline")
        if audio is None or image is None:
            raise ValueError("s2v requires audio and a reference image")
        if self.text_encoder is None:
            self.load_component_by_type("text_encoder")
        context = self.encode_prompt(prompt or "")
        use_cfg = negative_prompt is not None and guidance_scale > 1.0
        neg_context = self.encode_prompt(negative_prompt) if use_cfg else context
        self.maybe_release_text_encoders()
        for ctype in ("vae", "scheduler"):
            if getattr(self, ctype) is None:
                self.load_component_by_type(ctype)
        if self.transformer is None:
            self.transformer = self._load_transformer(self._primary_transformer_spec())
        tf = self.transformer
        t_scale, s_scale = self.vae.cfg.temporal_scale, self.vae.cfg.spatial_scale
        num_frames_per_chunk = max(t_scale, num_frames_per_chunk - num_frames_per_chunk % t_scale)
        height -= height % (s_scale * tf.cfg.patch_size[1])
        width -= width % (s_scale * tf.cfg.patch_size[2])

        audio_embeds, audio_chunks = self.encode_audio(audio, sampling_rate, num_frames_per_chunk, fps)
        num_chunks = min(num_chunks or audio_chunks, audio_chunks)
        safe_emit_progress(progress_callback, 0.2, f"Audio encoded ({num_chunks} chunks)")

        img_px = _pixels(_resized([self.load_image_input(image)], width, height, cv2.INTER_LANCZOS4))
        condition = self.encode_video_latents(img_px)  # [1, C, 1, h, w]
        motion_frames = self.motion_frames
        lat_motion = (motion_frames + 3) // t_scale
        lat_per_chunk = (num_frames_per_chunk + 3 + motion_frames) // t_scale - lat_motion
        lat_h, lat_w = height // s_scale, width // s_scale
        z_dim = tf.cfg.in_channels

        pose_chunks = None
        if pose_video is not None:
            from apex_studio_tpu_torch.preprocess.base import load_frames

            frames = load_frames(pose_video) if _is_path(pose_video) else list(pose_video)
            need = num_chunks * num_frames_per_chunk
            while len(frames) < need:
                frames = frames + frames[::-1]  # reverse-padded
            pose_px = _pixels(_resized(frames[:need], width, height, cv2.INTER_LANCZOS4))
            pose_chunks = []
            for r in range(num_chunks):
                seg = pose_px[:, :, r * num_frames_per_chunk:(r + 1) * num_frames_per_chunk]
                pose_chunks.append(self.encode_video_latents(torch.cat([seg[:, :, :1], seg], dim=2))[:, :, 1:])
            del pose_px

        motion_px = torch.zeros(1, 3, motion_frames, height, width)
        drop_first = self.drop_first_motion
        if init_first_frame:
            drop_first = False
            motion_px[:, :, -6:] = img_px
        motion_latents = self.encode_video_latents(motion_px)
        last_pixels = motion_px.to(self.device)
        zero_pose = torch.zeros(1, z_dim, lat_per_chunk, lat_h, lat_w, device=self.device)

        videos = []
        cb = make_mapped_progress(progress_callback, 0.25, 0.95)
        for r in range(num_chunks):
            chunk_cb = make_mapped_progress(cb, r / num_chunks, (r + 1) / num_chunks)
            x = self.get_latents((1, z_dim, lat_per_chunk, lat_h, lat_w), seed=None if seed is None else seed + r)
            a_slice = audio_embeds[..., r * num_frames_per_chunk:(r + 1) * num_frames_per_chunk]
            pose = pose_chunks[r] if pose_chunks is not None else zero_pose
            drop_motion = drop_first and r == 0
            kw = dict(motion_latents=motion_latents.to(tf.dtype), image_latents=condition.to(tf.dtype),
                      pose_latents=pose.to(tf.dtype), motion_frames=(motion_frames, lat_motion),
                      drop_motion_frames=drop_motion)
            ts, _ = self.get_timesteps(self.scheduler, num_inference_steps)
            for i, tstep in enumerate(ts):
                t_b = torch.full((1,), float(tstep), dtype=torch.float32, device=self.device)
                xd = x.to(tf.dtype)
                v = tf(xd, t_b, context, audio_embeds=a_slice, **kw)
                if use_cfg:
                    neg = tf(xd, t_b, neg_context, audio_embeds=a_slice * 0.0, **kw)
                    v = neg + guidance_scale * (v - neg)
                (x,) = self.scheduler.step(v.float(), float(tstep), x)
                safe_emit_progress(chunk_cb, 0.1 + 0.7 * (i + 1) / len(ts), f"Denoising step {i + 1}/{len(ts)}")
            decode_lat = torch.cat([condition if drop_motion else motion_latents, x], dim=2)
            video = self.decode_video_tensor(decode_lat, self.VAE_TILE, self.VAE_TILE_THRESHOLD)
            video = video[:, :, -num_frames_per_chunk:]
            if drop_motion:
                video = video[:, :, 3:]
            n_overlap = min(motion_frames, video.shape[2])
            last_pixels = torch.cat([last_pixels[:, :, n_overlap:], video[:, :, -n_overlap:]], dim=2)
            motion_latents = self.encode_video_latents(last_pixels)
            videos.append(video.cpu())
            safe_emit_progress(chunk_cb, 1.0, f"chunk {r + 1}/{num_chunks} done")

        safe_emit_progress(progress_callback, 0.95, "Denoising complete")
        full = torch.cat(videos, dim=2)
        b, c, t, h, w = full.shape
        frames = self.tensor_to_frames(full.transpose(1, 2).reshape(b * t, c, h, w))
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames


def match_and_blend_colors(video: np.ndarray, reference: np.ndarray, strength: float) -> np.ndarray:
    """Per-channel mean / std colour match of a [B, 3, T, H, W] video to a
    reference frame, blended by ``strength`` and clipped to [-1, 1]."""
    if strength <= 0.0:
        return video
    v_mean = video.mean(axis=(0, 2, 3, 4), keepdims=True)
    v_std = video.std(axis=(0, 2, 3, 4), keepdims=True) + 1e-6
    r_mean = reference.mean(axis=(0, 2, 3, 4), keepdims=True)
    r_std = reference.std(axis=(0, 2, 3, 4), keepdims=True) + 1e-6
    matched = (video - v_mean) / v_std * r_std + r_mean
    return np.clip(video * (1.0 - strength) + matched * strength, -1.0, 1.0)


@register_engine("wan", "multitalk")
class WanMultiTalkEngine(WanShared):
    """Multi-person audio-driven i2v (MultiTalk, and InfiniteTalk's weights),
    clip-autoregressive: each clip of ``num_frames`` carries the i2v mask +
    latent condition of its first frame (then of the previous clip's last
    ``motion_frames``, whose latents are re-noised to each step's t from a
    seeded ``np.random.default_rng(seed + 7·clip)``), each speaker's windowed
    wav2vec2 states, the speaker masks for L-RoPE routing and the CLIP-vision
    features. With a negative prompt a step takes three forwards (text
    dropped, then text and audio dropped), else two (audio dropped). Each
    clip is colour-matched to the reference. The scheduler steps on the host.

    The prompts encode before the DiT loads and UMT5 is released after them;
    JAX loads every component first and keeps UMT5. The decodes take the Wan
    engines' whole-or-tiled rule by the latent's size (JAX decodes whole); at
    the tests' sizes both are whole. As in JAX, the request returns frames
    (``return_latents`` is not read)."""

    @torch.inference_mode()
    def encode_person_audio(self, audio: Any, sampling_rate: int, fps: int) -> np.ndarray:
        """→ [F_pix, blocks, C]: the wav2vec2 states after the embeddings,
        resampled to one row a video frame, stacked."""
        from apex_studio_tpu_torch.utils.media import load_audio

        wav = load_audio(audio, sampling_rate)
        wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)
        video_length = max(int(len(wav) / sampling_rate * fps), 1)
        encoder = self.load_helper("audio_encoder")
        cfg = self.transformer.cfg
        _check_audio_encoder(encoder, cfg.audio_blocks + 1, cfg.audio_channels, "the MultiTalk DiT")
        states = encoder(torch.from_numpy(np.ascontiguousarray(wav, np.float32))[None].to(self.device),
                         seq_len=video_length)
        return torch.stack(states[1:], dim=0)[:, 0].transpose(0, 1).float().cpu().numpy()

    @staticmethod
    def human_masks(human_num: int, height: int, width: int, face_scale: float = 0.05) -> np.ndarray:
        """The default speaker layout: one speaker → the whole frame; two →
        the left and right halves' face boxes and the background."""
        if human_num == 1:
            m = np.ones((height, width), np.float32)
            return np.stack([m, np.ones_like(m), np.ones_like(m)])
        x0, x1 = int(height * face_scale), int(height * (1 - face_scale))
        half = width // 2
        m1 = np.zeros((height, width), np.float32)
        m1[x0:x1, int(half * face_scale):int(half * (1 - face_scale))] = 1
        m2 = np.zeros((height, width), np.float32)
        m2[x0:x1, int(half * face_scale) + half:int(half * (1 - face_scale)) + half] = 1
        return np.stack([m1, m2, ((m1 + m2) == 0).astype(np.float32)])

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        image: Any = None,
        audio: Any = None,
        person_1_audio: Any = None,
        person_2_audio: Any = None,
        audio_type: str = "para",
        negative_prompt: Optional[str] = None,
        sampling_rate: int = 16000,
        height: int = 480,
        width: int = 832,
        num_frames: int = 81,
        max_num_frames: int = 1000,
        motion_frames: int = 25,
        num_inference_steps: int = 40,
        guidance_scale: float = 5.0,
        audio_guidance_scale: float = 4.0,
        fps: int = 25,
        seed: Optional[int] = None,
        face_scale: float = 0.05,
        color_correction_strength: float = 1.0,
        return_latents: bool = False,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting multitalk pipeline")
        if image is None:
            raise ValueError("multitalk requires a conditioning image")
        if person_1_audio is None and audio is not None:
            person_1_audio = audio
        speakers = [a for a in (person_1_audio, person_2_audio) if a is not None]
        if not speakers:
            raise ValueError("multitalk requires at least one speaker audio")
        human_num = len(speakers)

        if self.text_encoder is None:
            self.load_component_by_type("text_encoder")
        context = self.encode_prompt(prompt or "")
        use_cfg = guidance_scale > 1.0 and negative_prompt is not None
        neg_context = self.encode_prompt(negative_prompt) if use_cfg else context
        self.maybe_release_text_encoders()
        for ctype in ("vae", "scheduler"):
            if getattr(self, ctype) is None:
                self.load_component_by_type(ctype)
        if self.transformer is None:
            self.transformer = self._load_transformer(self._primary_transformer_spec())
        tf = self.transformer
        t_scale, s_scale = self.vae.cfg.temporal_scale, self.vae.cfg.spatial_scale
        num_frames = max(1, num_frames - (num_frames - 1) % t_scale)
        height -= height % (s_scale * 2)
        width -= width % (s_scale * 2)

        full_audio = [self.encode_person_audio(a, sampling_rate, fps) for a in speakers]
        if human_num == 2 and audio_type == "add":  # both speakers hear the summed track
            n = min(len(full_audio[0]), len(full_audio[1]))
            summed = full_audio[0][:n] + full_audio[1][:n]
            full_audio = [summed, summed]
        total_frames = min(max_num_frames, min(len(a) for a in full_audio))
        safe_emit_progress(progress_callback, 0.15, "Audio encoded")

        img = self.load_image_input(image)
        clip_feats = WanI2VEngine.encode_image_clip(self, img) if tf.cfg.image_dim is not None else None
        cond_px = _pixels(_resized([img], width, height, cv2.INTER_LANCZOS4))
        ref_px = cond_px.numpy()

        lat_t = (num_frames - 1) // t_scale + 1
        lat_h, lat_w = height // s_scale, width // s_scale
        token_masks = np.stack([cv2.resize(m, (lat_w // 2, lat_h // 2), interpolation=cv2.INTER_NEAREST)
                                for m in self.human_masks(human_num, height, width, face_scale)])
        ref_masks = torch.from_numpy((token_masks > 0).reshape(len(token_masks), -1).astype(np.float32)).to(
            self.device)
        window = tf.cfg.audio_window
        offsets = np.arange(window) - window // 2
        z_dim = self.vae.cfg.z_dim

        def velocity(x_in, t_b, audio_embs):
            xd = x_in.to(tf.dtype)
            silent = audio_embs * 0.0
            pos = tf(xd, t_b, context, clip_feats, audio_embs, ref_target_masks=ref_masks)
            if use_cfg:
                drop_text = tf(xd, t_b, neg_context, clip_feats, audio_embs, ref_target_masks=ref_masks)
                uncond = tf(xd, t_b, neg_context, clip_feats, silent, ref_target_masks=ref_masks)
                return uncond + guidance_scale * (pos - drop_text) + audio_guidance_scale * (drop_text - uncond)
            drop_audio = tf(xd, t_b, context, clip_feats, silent, ref_target_masks=ref_masks)
            return drop_audio + audio_guidance_scale * (pos - drop_audio)

        all_frames = []
        audio_start, cur_motion, cond_source, clip_idx = 0, 1, cond_px, 0
        cb = make_mapped_progress(progress_callback, 0.2, 0.95)
        while True:
            clip_idx += 1
            is_first = clip_idx == 1
            idx = np.clip(np.arange(audio_start, audio_start + num_frames)[:, None] + offsets[None, :], 0,
                          total_frames - 1)
            audio_embs = torch.from_numpy(np.stack([a[idx] for a in full_audio])).to(self.device)

            # the i2v condition: the motion pixels then zeros, the mask on the motion span
            pad = torch.zeros(1, 3, num_frames - cond_source.shape[2], height, width)
            latent_cond = self.encode_video_latents(torch.cat([cond_source.cpu(), pad], dim=2))
            valid = np.zeros((1, 1, num_frames, lat_h, lat_w), np.float32)
            valid[:, :, :cur_motion] = 1.0
            mask = torch.from_numpy(_packed_frame_mask(valid, t_scale)).to(self.device)
            condition = torch.cat([mask, latent_cond], dim=1)
            cur_motion_lat = 1 + (cur_motion - 1) // t_scale
            motion_lat = latent_cond[:, :, :cur_motion_lat]

            x = self.get_latents((1, z_dim, lat_t, lat_h, lat_w), seed=None if seed is None else seed + clip_idx)
            ts, _ = self.get_timesteps(self.scheduler, num_inference_steps)
            clip_cb = make_mapped_progress(cb, min(audio_start / max(total_frames, 1), 1.0),
                                           min((audio_start + num_frames) / max(total_frames, 1), 1.0))
            rng = np.random.default_rng(0 if seed is None else seed + 7 * clip_idx)
            motion_noise = torch.from_numpy(rng.standard_normal(tuple(motion_lat.shape)).astype(np.float32)).to(
                self.device)
            for i, tstep in enumerate(ts):
                if not is_first:
                    x[:, :, :cur_motion_lat] = self.scheduler.add_noise(motion_lat, motion_noise, float(tstep))
                t_b = torch.full((1,), float(tstep), dtype=torch.float32, device=self.device)
                v = velocity(torch.cat([x, condition], dim=1), t_b, audio_embs)
                (x,) = self.scheduler.step(v.float(), float(tstep), x)
                safe_emit_progress(clip_cb, (i + 1) / len(ts), f"Denoising step {i + 1}/{len(ts)}")
            if not is_first:
                x[:, :, :cur_motion_lat] = motion_lat

            video = self.decode_video_tensor(x, self.VAE_TILE, self.VAE_TILE_THRESHOLD).float().cpu().numpy()
            if color_correction_strength > 0.0:
                video = match_and_blend_colors(video, ref_px, color_correction_strength)
            all_frames.append(video if is_first else video[:, :, cur_motion:])
            audio_start += num_frames - motion_frames
            if audio_start + num_frames >= total_frames or total_frames <= num_frames:
                break
            cur_motion = min(motion_frames, video.shape[2])
            cond_source = torch.from_numpy(np.ascontiguousarray(video[:, :, -cur_motion:]))

        safe_emit_progress(progress_callback, 0.95, "Denoising complete")
        full = np.concatenate(all_frames, axis=2)[:, :, :total_frames]
        b, c, t, h, w = full.shape
        frames = self.tensor_to_frames(torch.from_numpy(np.ascontiguousarray(
            full.transpose(0, 2, 1, 3, 4).reshape(b * t, c, h, w))))
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames
