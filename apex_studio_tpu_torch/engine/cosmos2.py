"""Cosmos Predict2 video2world engines, i2v and v2v (port of
``apex_studio_tpu/engine/cosmos2.py``).

EDM-style preconditioning on a flow sigma ladder (1 → 0): at σ, t = σ/(σ+1),
c_in = c_skip = 1 − t, c_out = −t; x0 = c_skip·x + c_out·F(c_in·x). The
conditioning frames (the image repeated over the clip, or the first frames
of a video, VAE encoded) enter clean, at t = σ_c/(σ_c+1) with σ_c = 1e-4
through the per-frame timesteps, are marked by the DiT's condition-mask
channel and are put back into x0 every step; CFG mixes the two x0 before the
Euler step on (x − x0)/σ. The T5 sequence has its padded rows zeroed and
reaches the DiT unmasked.
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.cosmos2")


class Cosmos2Shared(BaseEngine):
    def load_components(self, return_latents: bool = False) -> None:
        self.load_missing("text_encoder", "transformer", "vae", "scheduler")

    def encode_prompt(self, prompt: str, max_sequence_length: int = 512) -> torch.Tensor:
        hidden, mask = self.text_encoder.encode([prompt], max_sequence_length=max_sequence_length,
                                                use_chat_template=False)
        return torch.where(mask[..., None].bool(), hidden, torch.zeros((), dtype=hidden.dtype,
                                                                       device=hidden.device))

    @torch.inference_mode()
    def decode_latents(self, z: torch.Tensor) -> List[np.ndarray]:
        video = self.vae.decode(z.float())
        b, c, t, h, w = video.shape
        return self.tensor_to_frames(video.transpose(1, 2).reshape(b * t, c, h, w))

    def _check_transformer(self, latent_channels: int) -> None:
        """video2world feeds the latents and the condition mask: the DiT must
        take one channel more than the VAE makes (JAX would fail in the patch
        embedding)."""
        c_in = self.transformer.cfg.in_channels
        if c_in != latent_channels + 1:
            raise ValueError(f"the Cosmos DiT takes {c_in} channels; video2world feeds the VAE's "
                             f"{latent_channels} and a condition mask")

    @torch.inference_mode()
    def _denoise(self, x, cond_latents, cond_ind, context, neg_context, guidance_scale, num_inference_steps, fps,
                 progress_cb, sigma_conditioning: float = 1e-4):
        """cond_ind: (1, 1, T_lat, 1, 1), 1 on the clean conditioning frames."""
        tf = self.transformer
        do_cfg = guidance_scale > 1.0
        cond_mask = cond_ind.expand(1, 1, x.shape[2], x.shape[3], x.shape[4])
        t_cond = float(np.float32(sigma_conditioning / (sigma_conditioning + 1.0)))
        ctx, nctx = context.float(), neg_context.float()

        def x0_of(pred, x, t):
            x0 = (1.0 - t) * x + (-t) * pred
            return cond_ind * cond_latents + (1.0 - cond_ind) * x0

        # descending flow sigmas 1 → 0
        sigmas = np.linspace(1.0, 0.0, num_inference_steps + 1)
        sigmas[-1] = 0.0
        x = x * float(sigmas[0])
        for i in range(num_inference_steps):
            # the per-frame time from the float64 sigma, the preconditioning in f32, as JAX has them
            sigma = float(max(sigmas[i], 1e-4))
            t_frame = torch.where(cond_ind[0, 0, :, 0, 0] > 0.5, t_cond, float(np.float32(sigma / (sigma + 1.0))))[None]
            sigma = np.float32(sigma)
            t = np.float32(sigma / (sigma + np.float32(1.0)))
            c_in = np.float32(1.0) - t
            x_in = (cond_ind * cond_latents + (1.0 - cond_ind) * x * float(c_in)).to(tf.dtype)
            x0 = x0_of(tf(x_in, t_frame, ctx, fps=None, condition_mask=cond_mask).float(), x, float(t))
            if do_cfg:
                nx0 = x0_of(tf(x_in, t_frame, nctx, fps=None, condition_mask=cond_mask).float(), x, float(t))
                x0 = x0 + guidance_scale * (x0 - nx0)
            v = (x - x0) / float(sigma)
            x = x + float(sigmas[i + 1] - sigmas[i]) * v
            safe_emit_progress(progress_cb, (i + 1) / num_inference_steps, f"step {i + 1}/{num_inference_steps}")
        # the clean frames come straight from the conditioning
        return cond_ind * cond_latents + (1.0 - cond_ind) * x

    def _run(self, cond_video, n_cond_latent_frames, prompt, negative_prompt, num_inference_steps,
             guidance_scale, seed, return_latents, progress_callback, fps):
        context = self.encode_prompt(prompt or "")
        neg_context = self.encode_prompt(negative_prompt or "")
        safe_emit_progress(progress_callback, 0.15, "Prompts encoded")
        cond_latents = self.encode_video_latents(cond_video).float()
        self._check_transformer(cond_latents.shape[1])
        lat_f = cond_latents.shape[2]
        cond_ind = torch.zeros(1, 1, lat_f, 1, 1, device=self.device)
        cond_ind[:, :, :n_cond_latent_frames] = 1.0
        x = self.get_latents(tuple(cond_latents.shape), seed=seed)
        safe_emit_progress(progress_callback, 0.3, "Latents ready")
        x = self._denoise(x, cond_latents, cond_ind, context, neg_context, guidance_scale, num_inference_steps, fps,
                          make_mapped_progress(progress_callback, 0.3, 0.9))
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self.decode_latents(x)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames

    def _clip_length(self, num_frames, duration, fps) -> int:
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        t_scale = self.vae.cfg.temporal_scale
        return max(1, num_frames - (num_frames - 1) % t_scale)


@register_engine("cosmos2", "i2v")
class Cosmos2I2VEngine(Cosmos2Shared):
    @torch.inference_mode()
    def run(self, image: Any = None, prompt: Optional[str] = None, negative_prompt: Optional[str] = None,
            height: int = 480, width: int = 832, duration: Optional[float] = None, fps: int = 16,
            num_frames: Optional[int] = None, num_inference_steps: int = 35, guidance_scale: float = 7.0,
            seed: Optional[int] = None, return_latents: bool = False, progress_callback=None,
            offload: bool = True, **_: Any):
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting Cosmos2 i2v")
        self.load_components(return_latents)
        num_frames = self._clip_length(num_frames, duration, fps)
        arr = cv2.resize(self.load_image_input(image), (width, height), interpolation=cv2.INTER_AREA)
        px = torch.from_numpy(arr.astype(np.float32)).permute(2, 0, 1)[None, :, None] / 127.5 - 1.0
        # the image repeated over the whole clip before the encode
        vid = px.repeat(1, 1, num_frames, 1, 1)
        return self._run(vid, 1, prompt, negative_prompt, num_inference_steps, guidance_scale, seed,
                         return_latents, progress_callback, fps)


@register_engine("cosmos2", "v2v")
class Cosmos2V2VEngine(Cosmos2Shared):
    @torch.inference_mode()
    def run(self, video: Any = None, prompt: Optional[str] = None, negative_prompt: Optional[str] = None,
            height: int = 480, width: int = 832, duration: Optional[float] = None, fps: int = 16,
            num_frames: Optional[int] = None, num_inference_steps: int = 35, guidance_scale: float = 7.0,
            seed: Optional[int] = None, conditioning_frames: int = 9, return_latents: bool = False,
            progress_callback=None, offload: bool = True, **_: Any):
        import cv2

        from apex_studio_tpu_torch.preprocess.base import load_frames

        safe_emit_progress(progress_callback, 0.0, "Starting Cosmos2 v2v")
        self.load_components(return_latents)
        num_frames = self._clip_length(num_frames, duration, fps)
        t_scale = self.vae.cfg.temporal_scale
        frames_in = load_frames(video) if isinstance(video, str) else list(video)
        frames_in = [cv2.resize(np.asarray(fr), (width, height), interpolation=cv2.INTER_AREA) for fr in frames_in]
        n_cond = min(len(frames_in), conditioning_frames)
        while len(frames_in) < num_frames:
            frames_in.append(frames_in[-1])
        vid = torch.from_numpy(np.stack(frames_in[:num_frames]).astype(np.float32))
        vid = vid.permute(3, 0, 1, 2)[None] / 127.5 - 1.0
        n_cond_lat = max(1, (n_cond - 1) // t_scale + 1)
        return self._run(vid, n_cond_lat, prompt, negative_prompt, num_inference_steps, guidance_scale, seed,
                         return_latents, progress_callback, fps)
