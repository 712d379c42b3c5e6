"""CogVideoX engines: t2v, i2v, v2v, control and inp, port of
``apex_studio_tpu/engine/cogvideox.py``.

- T5 features at 226 tokens, the padded rows zeroed, no attention mask
- the DDIM v-prediction sampler (zero terminal SNR, the SNR shift)
- CFG over [uncond, cond], optionally with the dynamic-CFG cosine ramp
- i2v: the first frame's latent, zero-padded over time, channel-concatenated
  every step; control: the control video's latents concatenated; inp: the
  inverted mask resized to the latent grid (frame 0 apart, JAX's antialiased
  trilinear resize) and the masked video's latents concatenated; v2v: DDPM
  corruption of the source's latents at ``strength``
- latents NCTHW, frames by the causal 1 + 4k rule

Where the JAX engine would fail inside the DiT or in the step after it (a
conditioning whose channels the DiT does not take), the port raises before
the DiT runs.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.jax_resize import resize as jax_resize
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.cogvideox")


def _frames_of(media, max_frames: Optional[int] = None) -> List[np.ndarray]:
    if isinstance(media, (str, bytes)) or hasattr(media, "__fspath__"):
        from apex_studio_tpu_torch.preprocess.base import load_frames

        media = load_frames(media, max_frames=max_frames)
    return [np.asarray(f) for f in media]


def dynamic_guidance(guidance_scale: float, t: float, n_train: int) -> float:
    """The dynamic-CFG scale at timestep ``t``: 1 + s·(1 − cos(π·((n − t)/n)⁵))/2."""
    return 1.0 + guidance_scale * ((1.0 - math.cos(math.pi * ((n_train - float(t)) / n_train) ** 5.0)) / 2.0)


class CogVideoXShared(BaseEngine):
    def load_components(self) -> None:
        self.load_missing("text_encoder", "transformer", "vae", "scheduler")

    def encode_prompt(self, prompt: str, max_sequence_length: int = 226) -> torch.Tensor:
        hidden, mask = self.text_encoder.encode([prompt], max_sequence_length=max_sequence_length,
                                                use_chat_template=False)
        return torch.where(mask[..., None].bool(), hidden.float(), torch.zeros((), device=hidden.device))

    def prompts(self, prompt, negative_prompt, guidance_scale: float, max_sequence_length: int):
        context = self.encode_prompt(prompt or "", max_sequence_length)
        neg = self.encode_prompt(negative_prompt or "", max_sequence_length) if guidance_scale > 1.0 else None
        return context, neg

    def noise_channels(self, cond_channels: int) -> int:
        """The noise latent's channels beside ``cond_channels`` of conditioning:
        the DiT's ``in_channels`` less them. A ``ValueError`` when that is not
        the DiT's ``out_channels``: JAX fails in the DiT or in the step after it."""
        cfg = self.transformer.cfg
        noise_c = cfg.in_channels - cond_channels
        if noise_c != cfg.out_channels:
            raise ValueError(f"the {self.model_type} request's {cond_channels} conditioning channels beside "
                             f"{cfg.out_channels} noise channels do not make the DiT's in_channels "
                             f"{cfg.in_channels}")
        return noise_c

    def decode_latents(self, z: torch.Tensor) -> List[np.ndarray]:
        video = self.vae.decode(z.float())
        b, c, t, h, w = video.shape
        return self.tensor_to_frames(video.transpose(1, 2).reshape(b * t, c, h, w))

    def denoise(self, x, condition, ts, context, neg_context, guidance_scale: float, use_dynamic_cfg: bool,
                render_cb: Optional[Callable], render_interval: int, render_on_step: bool,
                progress_cb: Optional[Callable]) -> torch.Tensor:
        use_cfg = guidance_scale > 1.0 and neg_context is not None
        if len(ts) <= 8:
            render_on_step = False
        tf = self.transformer
        n_train = getattr(self.scheduler, "num_train_timesteps", 1000)
        cond = None if condition is None else condition.float()
        for i, t in enumerate(ts):
            g = dynamic_guidance(guidance_scale, float(t), n_train) if use_dynamic_cfg else guidance_scale
            t_vec = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
            x_in = x.to(tf.dtype)
            if cond is not None:
                x_in = torch.cat([x_in, cond.to(x_in.dtype)], dim=1)
            v = tf(x_in, t_vec, context)
            if use_cfg:
                v_neg = tf(x_in, t_vec, neg_context).float()
                v = v_neg + g * (v.float() - v_neg)
            (x,) = self.scheduler.step(v.float(), float(t), x)
            if render_on_step and render_cb is not None and (i + 1) % render_interval == 0 and i + 1 < len(ts):
                try:
                    render_cb(self.preview_frames(x, self.decode_latents), i)
                except Exception:
                    logger.exception("preview callback failed")
            if progress_cb is not None:
                progress_cb(min((i + 1) / len(ts), 1.0), f"Denoising step {i + 1}/{len(ts)}")
        return x

    def _geometry(self, height: int, width: int, num_frames: int):
        vae_cfg = self.vae.cfg
        s_scale, t_scale = vae_cfg.spatial_scale, vae_cfg.temporal_scale
        p = self.transformer.cfg.patch_size
        height -= height % (s_scale * p)
        width -= width % (s_scale * p)
        num_frames = max(1, num_frames - (num_frames - 1) % t_scale)
        lat_t = (num_frames - 1) // t_scale + 1
        return height, width, num_frames, lat_t, height // s_scale, width // s_scale

    def _finish(self, x, return_latents: bool, progress_callback, message: str):
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self.decode_latents(x)
        safe_emit_progress(progress_callback, 1.0, message)
        return frames


@register_engine("cogvideo", "t2v")
class CogVideoXT2VEngine(CogVideoXShared):
    @torch.inference_mode()
    def run(self, prompt: Optional[str] = None, negative_prompt: Optional[str] = None, height: int = 480,
            width: int = 720, num_frames: int = 49, num_inference_steps: int = 50, guidance_scale: float = 6.0,
            use_dynamic_cfg: bool = False, seed: Optional[int] = None, latents: Optional[np.ndarray] = None,
            return_latents: bool = False, render_on_step: bool = False,
            render_on_step_callback: Optional[Callable] = None, render_on_step_interval: int = 3,
            progress_callback: Optional[Callable] = None, max_sequence_length: int = 226, **_: Any):
        safe_emit_progress(progress_callback, 0.0, "Starting t2v pipeline")
        self.load_components()
        height, width, num_frames, lat_t, lat_h, lat_w = self._geometry(height, width, num_frames)
        context, neg_context = self.prompts(prompt, negative_prompt, guidance_scale, max_sequence_length)
        safe_emit_progress(progress_callback, 0.2, "Prompts ready")
        x = self.get_latents((1, self.noise_channels(0), lat_t, lat_h, lat_w), seed=seed, latents=latents)
        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps)
        safe_emit_progress(progress_callback, 0.35, "Noise + timesteps ready")
        x = self.denoise(x, None, ts, context, neg_context, guidance_scale, use_dynamic_cfg,
                         render_on_step_callback, render_on_step_interval, render_on_step,
                         make_mapped_progress(progress_callback, 0.35, 0.9))
        return self._finish(x, return_latents, progress_callback, "Completed pipeline")


@register_engine("cogvideo", "i2v")
class CogVideoXI2VEngine(CogVideoXShared):
    @torch.inference_mode()
    def run(self, image: Any = None, prompt: Optional[str] = None, negative_prompt: Optional[str] = None,
            height: int = 480, width: int = 720, num_frames: int = 49, num_inference_steps: int = 50,
            guidance_scale: float = 6.0, use_dynamic_cfg: bool = False, seed: Optional[int] = None,
            return_latents: bool = False, render_on_step: bool = False,
            render_on_step_callback: Optional[Callable] = None, render_on_step_interval: int = 3,
            progress_callback: Optional[Callable] = None, max_sequence_length: int = 226, **_: Any):
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting i2v pipeline")
        self.load_components()
        if image is None:
            raise ValueError("i2v requires an input image")
        if isinstance(image, (str, bytes)) or hasattr(image, "__fspath__"):
            image = _frames_of(image)[0]
        image = self.load_image_input(np.asarray(image))
        height, width, num_frames, lat_t, lat_h, lat_w = self._geometry(height, width, num_frames)
        context, neg_context = self.prompts(prompt, negative_prompt, guidance_scale, max_sequence_length)

        # the first frame's latent, zero-padded over latent time, channel-concatenated
        resized = cv2.resize(image, (width, height), interpolation=cv2.INTER_LANCZOS4)
        px = torch.from_numpy(resized.astype(np.float32) / 127.5 - 1.0).permute(2, 0, 1)
        first_lat = self.encode_video_latents(px[None, :, None])
        cond = torch.cat([first_lat, first_lat.new_zeros((1, first_lat.shape[1], lat_t - 1, lat_h, lat_w))], dim=2)
        safe_emit_progress(progress_callback, 0.25, "Image conditioning ready")

        x = self.get_latents((1, self.noise_channels(cond.shape[1]), lat_t, lat_h, lat_w), seed=seed)
        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps)
        x = self.denoise(x, cond, ts, context, neg_context, guidance_scale, use_dynamic_cfg,
                         render_on_step_callback, render_on_step_interval, render_on_step,
                         make_mapped_progress(progress_callback, 0.35, 0.9))
        return self._finish(x, return_latents, progress_callback, "Completed pipeline")


@register_engine("cogvideo", "v2v")
class CogVideoXV2VEngine(CogVideoXShared):
    """Video to video by DDPM corruption of the source's latents at ``strength``."""

    @torch.inference_mode()
    def run(self, video: Any = None, prompt: Optional[str] = None, negative_prompt: Optional[str] = None,
            height: int = 480, width: int = 720, strength: float = 0.8, num_inference_steps: int = 50,
            guidance_scale: float = 6.0, use_dynamic_cfg: bool = False, seed: Optional[int] = None,
            return_latents: bool = False, render_on_step: bool = False,
            render_on_step_callback: Optional[Callable] = None, render_on_step_interval: int = 3,
            progress_callback: Optional[Callable] = None, max_sequence_length: int = 226, **_: Any):
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting v2v pipeline")
        self.load_components()
        if video is None:
            raise ValueError("v2v requires an input video")
        frames_in = [self.load_image_input(f) for f in _frames_of(video)]
        height, width, num_frames, lat_t, lat_h, lat_w = self._geometry(height, width, len(frames_in))
        self.noise_channels(0)
        stacked = np.stack([cv2.resize(f, (width, height), interpolation=cv2.INTER_LANCZOS4)
                            for f in frames_in[:num_frames]])
        vid = torch.from_numpy((stacked.astype(np.float32) / 127.5 - 1.0).transpose(3, 0, 1, 2))[None]
        source = self.vae.encode(vid.to(self.device)).float()
        safe_emit_progress(progress_callback, 0.2, "Encoded source video")
        context, neg_context = self.prompts(prompt, negative_prompt, guidance_scale, max_sequence_length)

        ts_full, _ = self.get_timesteps(self.scheduler, num_inference_steps)
        start = min(int(round(num_inference_steps * (1.0 - strength))), len(ts_full) - 1)
        ts = ts_full[start:]
        self.scheduler.set_begin_index(start)
        noise = self.get_latents(tuple(source.shape), seed=seed)
        x = self.scheduler.add_noise(source, noise, ts[0])
        x = self.denoise(x, None, ts, context, neg_context, guidance_scale, use_dynamic_cfg,
                         render_on_step_callback, render_on_step_interval, render_on_step,
                         make_mapped_progress(progress_callback, 0.3, 0.9))
        return self._finish(x, return_latents, progress_callback, "Completed pipeline")


@register_engine("cogvideo", "control")
class CogVideoXControlEngine(CogVideoXShared):
    """Control-video generation: the control video's latents channel-concatenated
    with the noise."""

    @torch.inference_mode()
    def run(self, control_video: Any = None, prompt: Optional[str] = None, negative_prompt: Optional[str] = None,
            height: int = 480, width: int = 720, num_frames: Optional[int] = None, num_inference_steps: int = 50,
            guidance_scale: float = 6.0, use_dynamic_cfg: bool = False, seed: Optional[int] = None,
            return_latents: bool = False, render_on_step: bool = False,
            render_on_step_callback: Optional[Callable] = None, render_on_step_interval: int = 3,
            progress_callback: Optional[Callable] = None, max_sequence_length: int = 226, **_: Any):
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting control pipeline")
        self.load_components()
        if control_video is None:
            raise ValueError("control requires a control_video")
        frames_in = _frames_of(control_video, num_frames)
        nf = num_frames or len(frames_in)
        height, width, nf, lat_t, lat_h, lat_w = self._geometry(height, width, min(nf, len(frames_in)))
        noise_c = self.noise_channels(self.vae.cfg.latent_channels)
        vid = np.stack([cv2.resize(f, (width, height), interpolation=cv2.INTER_AREA) for f in frames_in[:nf]])
        cond = self.encode_video_latents((vid.astype(np.float32) / 127.5 - 1.0).transpose(3, 0, 1, 2)[None])
        context, neg_context = self.prompts(prompt, negative_prompt, guidance_scale, max_sequence_length)

        x = self.get_latents((1, noise_c, lat_t, lat_h, lat_w), seed=seed)
        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps)
        x = self.denoise(x, cond, ts, context, neg_context, guidance_scale, use_dynamic_cfg,
                         render_on_step_callback, render_on_step_interval, render_on_step,
                         make_mapped_progress(progress_callback, 0.35, 0.9))
        return self._finish(x, return_latents, progress_callback, "Completed control pipeline")


def mask_latents(mask: np.ndarray, lat_t: int, lat_h: int, lat_w: int) -> torch.Tensor:
    """The inverted mask ([T, H, W] in [0, 1]) on the latent grid, [1, 1, lat_t,
    lat_h, lat_w]: frame 0 resized on its own, the rest to ``lat_t − 1`` frames,
    both by ``jax.image.resize(..., "trilinear")`` (antialiased when it
    downsamples), as JAX does."""
    inv = torch.from_numpy(1.0 - mask)[None, None]
    first = jax_resize(inv[:, :, :1], (1, 1, 1, lat_h, lat_w), "trilinear")
    if lat_t - 1 > 0 and inv.shape[2] > 1:
        rest = jax_resize(inv[:, :, 1:], (1, 1, lat_t - 1, lat_h, lat_w), "trilinear")
        return torch.cat([first, rest], dim=2)
    return first.expand(1, 1, lat_t, lat_h, lat_w)


@register_engine("cogvideo", "inp")
class CogVideoXInpEngine(CogVideoXShared):
    """Video inpainting: [the resized inverted mask ‖ the masked video's
    latents] channel-concatenated with the noise; masked pixels are −1."""

    @torch.inference_mode()
    def run(self, video: Any = None, mask_video: Any = None, prompt: Optional[str] = None,
            negative_prompt: Optional[str] = None, height: int = 480, width: int = 720,
            num_frames: Optional[int] = None, num_inference_steps: int = 50, guidance_scale: float = 6.0,
            use_dynamic_cfg: bool = False, seed: Optional[int] = None, return_latents: bool = False,
            render_on_step: bool = False, render_on_step_callback: Optional[Callable] = None,
            render_on_step_interval: int = 3, progress_callback: Optional[Callable] = None,
            max_sequence_length: int = 226, **_: Any):
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting inpaint pipeline")
        self.load_components()
        if video is None:
            raise ValueError("inp requires an input video")
        frames_in = _frames_of(video, num_frames)
        nf = num_frames or len(frames_in)
        height, width, nf, lat_t, lat_h, lat_w = self._geometry(height, width, min(nf, len(frames_in)))
        noise_c = self.noise_channels(1 + self.vae.cfg.latent_channels)
        vid = np.stack([cv2.resize(f, (width, height), interpolation=cv2.INTER_AREA)
                        for f in frames_in[:nf]]).astype(np.float32)
        if mask_video is not None:
            mframes = _frames_of(mask_video, nf)[:nf]
            while len(mframes) < nf:
                mframes.append(mframes[-1])
            mask = np.stack([cv2.resize(f[..., 0] if f.ndim == 3 else f, (width, height),
                                        interpolation=cv2.INTER_NEAREST) for f in mframes]).astype(np.float32) / 255.0
        else:
            mask = np.ones((nf, height, width), np.float32)
        mask3 = mask[..., None]
        px = vid / 127.5 - 1.0
        masked = px * (mask3 < 0.5) + (-1.0) * (mask3 > 0.5)
        masked_lat = self.encode_video_latents(masked.transpose(3, 0, 1, 2)[None])
        scaling = getattr(self.vae.cfg, "scaling_factor", 1.0)
        mask_lat = mask_latents(mask, lat_t, lat_h, lat_w).to(masked_lat.device)
        cond = torch.cat([mask_lat.float() * scaling, masked_lat.float()], dim=1)
        context, neg_context = self.prompts(prompt, negative_prompt, guidance_scale, max_sequence_length)

        x = self.get_latents((1, noise_c, lat_t, lat_h, lat_w), seed=seed)
        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps)
        x = self.denoise(x, cond, ts, context, neg_context, guidance_scale, use_dynamic_cfg,
                         render_on_step_callback, render_on_step_interval, render_on_step,
                         make_mapped_progress(progress_callback, 0.35, 0.9))
        return self._finish(x, return_latents, progress_callback, "Completed inpaint pipeline")
