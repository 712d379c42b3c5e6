"""Kandinsky 5.0 engines, t2v and i2v (port of
``apex_studio_tpu/engine/kandinsky5.py``).

- the prompt: the Qwen2.5-VL sequence (256 tokens) and CLIP-L's pooled
  vector; the Qwen mask is dropped as in JAX, so the DiT attends the padded
  text rows too
- flow-match Euler through the manifest's scheduler, CFG against the
  encoded negative prompt, the timestep × 1000 into the DiT
- i2v: the image's VAE latent in the first latent frame of C extra channels
  and a validity mask (1 on that frame) as one more, concatenated to the
  noise (the DiT's ``visual_cond`` input)
- the HunyuanVideo 3-D causal VAE
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.kandinsky5")


class Kandinsky5Shared(BaseEngine):
    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.text_encoder_2 = None

    def load_text_encoders(self) -> None:
        from apex_studio_tpu_torch.text_encoder import TextEncoder

        te_specs = [s for s in self.component_specs.values() if s.get("type") == "text_encoder"]
        qwen = next((s for s in te_specs if "Qwen" in (s.get("base") or "")), None)
        clip = next((s for s in te_specs if "CLIP" in (s.get("base") or "")), None)
        if qwen is None or clip is None:
            raise KeyError("kandinsky5 manifest needs Qwen2.5-VL and CLIP text_encoder components")
        if self.text_encoder is None:
            self.text_encoder = TextEncoder(self, qwen)
        if self.text_encoder_2 is None:
            self.text_encoder_2 = TextEncoder(self, clip)

    @torch.inference_mode()
    def encode_prompt(self, prompt: str, max_sequence_length: int = 256):
        """→ (the Qwen sequence [1, L, 3584], CLIP's pooled vector [1, 768])."""
        self.load_text_encoders()
        seq, _mask = self.text_encoder.encode([prompt], max_sequence_length=max_sequence_length)
        clip = self.text_encoder_2
        ids, mask = clip.tokenize([prompt], 77)
        _, pooled = clip._ensure_model()(torch.from_numpy(ids).long().to(self.device),
                                         attention_mask=torch.from_numpy(mask).to(self.device))
        return seq, pooled

    def load_components(self, return_latents: bool = False) -> None:
        self.load_text_encoders()
        self.load_missing("transformer", "vae", "scheduler")

    @torch.inference_mode()
    def decode_latents(self, z: torch.Tensor) -> List[np.ndarray]:
        video = self.vae.decode(z.float())
        b, c, t, h, w = video.shape
        return self.tensor_to_frames(video.transpose(1, 2).reshape(b * t, c, h, w))

    def _check_transformer(self, channels: int) -> None:
        """The DiT's visual input must take the noise and the conditioning
        channels; JAX would fail in its first matmul."""
        tf = self.transformer
        if tf.visual_in_channels != channels:
            raise ValueError(f"the Kandinsky 5 DiT takes {tf.visual_in_channels} visual channels "
                             f"(visual_cond={tf.cfg.visual_cond}); this request feeds {channels}")

    @torch.inference_mode()
    def _denoise(self, x, cond, context, pooled, neg_context, neg_pooled, guidance_scale, ts, progress_cb):
        """cond: None (t2v) or (B, C + 1, T, H, W) conditioning channels."""
        tf = self.transformer
        dt = tf.dtype
        do_cfg = guidance_scale > 1.0
        cnd = None if cond is None else cond.to(dt)
        ctx, pld, nctx, npld = (a.to(dt) for a in (context, pooled, neg_context, neg_pooled))
        for i, t in enumerate(np.asarray(ts, np.float64)):
            t_b = torch.full((1,), float(t), dtype=torch.float32, device=self.device)
            x_in = x.to(dt) if cnd is None else torch.cat([x.to(dt), cnd], dim=1)
            v = tf(x_in, t_b, ctx, pld)
            if do_cfg:
                neg = tf(x_in, t_b, nctx, npld)
                v = neg + guidance_scale * (v - neg)
            out = self.scheduler.step(v.float(), float(t), x)
            x = out[0] if isinstance(out, tuple) else out
            safe_emit_progress(progress_cb, (i + 1) / len(ts), f"step {i + 1}/{len(ts)}")
        return x

    def _run(self, prompt, negative_prompt, height, width, num_frames, num_inference_steps, guidance_scale, seed,
             timesteps, return_latents, progress_callback, cond=None):
        context, pooled = self.encode_prompt(prompt or "")
        neg_context, neg_pooled = self.encode_prompt(negative_prompt or "")
        safe_emit_progress(progress_callback, 0.2, "Prompts encoded")
        t_scale, s_scale = self.vae.cfg.temporal_scale, self.vae.cfg.spatial_scale
        lat_f = (num_frames - 1) // t_scale + 1
        lat_h, lat_w = height // s_scale, width // s_scale
        c = self.transformer.cfg.in_visual_dim
        self._check_transformer(c + (0 if cond is None else cond.shape[1]))
        x = self.get_latents((1, c, lat_f, lat_h, lat_w), seed=seed)
        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps, timesteps=timesteps)
        x = self._denoise(x, cond, context, pooled, neg_context, neg_pooled, guidance_scale, ts,
                          make_mapped_progress(progress_callback, 0.25, 0.9))
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self.decode_latents(x)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames


@register_engine("kandinsky5", "t2v")
class Kandinsky5T2VEngine(Kandinsky5Shared):
    @torch.inference_mode()
    def run(self, prompt: Optional[str] = None, negative_prompt: Optional[str] = None, height: int = 512,
            width: int = 768, duration: Optional[float] = None, fps: int = 24, num_frames: Optional[int] = None,
            num_inference_steps: int = 50, guidance_scale: float = 5.0, seed: Optional[int] = None,
            timesteps: Optional[List[float]] = None, return_latents: bool = False, progress_callback=None,
            offload: bool = True, **_: Any):
        safe_emit_progress(progress_callback, 0.0, "Starting Kandinsky5 t2v")
        self.load_components(return_latents)
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        return self._run(prompt, negative_prompt, height, width, num_frames, num_inference_steps, guidance_scale,
                         seed, timesteps, return_latents, progress_callback)


@register_engine("kandinsky5", "i2v")
class Kandinsky5I2VEngine(Kandinsky5Shared):
    @torch.inference_mode()
    def run(self, image: Any = None, prompt: Optional[str] = None, negative_prompt: Optional[str] = None,
            height: int = 512, width: int = 768, duration: Optional[float] = None, fps: int = 24,
            num_frames: Optional[int] = None, num_inference_steps: int = 50, guidance_scale: float = 5.0,
            seed: Optional[int] = None, timesteps: Optional[List[float]] = None, return_latents: bool = False,
            progress_callback=None, offload: bool = True, **_: Any):
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting Kandinsky5 i2v")
        self.load_components(return_latents)
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        t_scale, s_scale = self.vae.cfg.temporal_scale, self.vae.cfg.spatial_scale
        lat_f = (num_frames - 1) // t_scale + 1
        lat_h, lat_w = height // s_scale, width // s_scale
        arr = cv2.resize(self.load_image_input(image), (width, height), interpolation=cv2.INTER_AREA)
        px = torch.from_numpy(arr.astype(np.float32)).permute(2, 0, 1)[None, :, None] / 127.5 - 1.0
        img_lat = self.encode_video_latents(px)  # [1, C, 1, h, w]
        c = img_lat.shape[1]
        cond = torch.zeros(1, c + 1, lat_f, lat_h, lat_w, device=self.device)
        cond[:, :c, :1] = img_lat
        cond[:, c, 0] = 1.0  # the validity mask on the first frame
        return self._run(prompt, negative_prompt, height, width, num_frames, num_inference_steps, guidance_scale,
                         seed, timesteps, return_latents, progress_callback, cond=cond)
