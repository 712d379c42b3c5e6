"""LongCat-Video engines: t2v, i2v, vc, continuation, long_video, interactive
and refine (port of ``apex_studio_tpu/engine/longcat.py``).

All seven share one DiT, the Wan VAE and the UMT5 prompt encoder:

- t2v: CFG-zero* guidance, the unconditional branch rescaled by the
  projection scale (``optimized_scale``) before the CFG mix; the model
  predicts the negated flow, so a step is ``x − dt·v``; sigmas are
  linspace(1, 0.001), or a subsample of the 16-step distillation grid
- i2v: the image's latent in the first latent slot, at t = 0, attended in
  isolation (``num_cond_latents``) and never updated
- vc: the last ``num_cond_frames`` input frames become clean context; with
  ``use_kv_cache`` each block's K/V of the context are made once (t = 0,
  cross-attention skipped) and every step runs only the new frames against
  them
- continuation: the source resampled to the model fps, then one vc segment
- long_video: t2v for the first segment, then vc segments, each continuing
  the frames decoded so far
- interactive: one prompt a segment, a single prompt split into sentences
- refine: the clip upsampled to 720p (and 2× in time, trilinear), VAE
  encoded, noised to ``t_thresh`` and denoised on the truncated schedule
  without CFG
"""

from __future__ import annotations

import logging
import re
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from apex_studio_tpu_torch.engine.base import BaseEngine
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.longcat")


def optimized_scale(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """CFG-zero* projection scale ⟨pos, neg⟩ / (‖neg‖² + 1e-8) per sample,
    shaped [B, 1, 1, 1, 1]."""
    b = pos.shape[0]
    p, n = pos.reshape(b, -1), neg.reshape(b, -1)
    dot = (p * n).sum(dim=1, keepdim=True)
    sq = (n * n).sum(dim=1, keepdim=True) + 1e-8
    return (dot / sq).reshape(b, 1, 1, 1, 1)


def split_into_sentences(text: str) -> List[str]:
    """Sentences of ``text`` for interactive mode: split after . ! or ?
    followed by whitespace, newlines read as spaces."""
    parts = re.split(r"(?<=[.!?])\s+", text.replace("\n", " "))
    return [p.strip() for p in parts if p.strip()]


def upsample_time(px: torch.Tensor, frames: int) -> torch.Tensor:
    """[B, C, T, H, W] → [B, C, frames, H, W], linear in time with half-pixel
    centres (``jax.image.resize(..., "trilinear")`` at the same H and W: the
    first and last frames are the input's own, as both clamp at the edge)."""
    return F.interpolate(px, size=(frames, *px.shape[-2:]), mode="trilinear", align_corners=False)


class LongCatShared(BaseEngine):
    def load_components(self) -> None:
        self.load_missing("text_encoder", "transformer", "vae")

    def encode_prompt(self, prompt: str, max_sequence_length: int = 512):
        """→ (UMT5 hidden states, their mask)."""
        return self.text_encoder.encode([prompt or ""], max_sequence_length=max_sequence_length,
                                        use_chat_template=False)

    @staticmethod
    def sigmas_for(steps: int, use_distill: bool = False, num_distill_steps: int = 16) -> np.ndarray:
        if use_distill:
            grid = np.round(np.arange(1, num_distill_steps + 1) * (1000 // num_distill_steps)).astype(np.int64)
            idx = np.floor(np.linspace(0, num_distill_steps, num=steps, endpoint=False)).astype(np.int64)
            sig = grid[::-1][idx].astype(np.float64) / 1000.0
        else:
            sig = np.linspace(1.0, 0.001, steps)
        return np.concatenate([sig, [0.0]])

    def _forward(self, x, t_frames, context, neg_context, guidance_scale, num_cond_latents, kv_cache,
                 num_ctx_latents):
        """One velocity (negated flow): the conditional forward, or with CFG
        the CFG-zero* mix of the conditional and unconditional ones."""
        tf = self.transformer
        kw = dict(num_cond_latents=num_cond_latents, num_ctx_latents=num_ctx_latents, kv_cache=kv_cache)
        x_in = x.to(tf.dtype)
        pos = tf(x_in, t_frames, context[0], context[1], **kw)
        if neg_context is None:
            return pos
        neg = tf(x_in, t_frames, neg_context[0], neg_context[1], **kw)
        st = optimized_scale(pos, neg)
        return neg * st + guidance_scale * (pos - neg * st)

    @torch.inference_mode()
    def denoise(self, latents, sigmas, context, neg_context, guidance_scale, num_cond_latents: int = 0,
                kv_cache=None, num_ctx_latents: int = 0, progress_callback: Optional[Callable] = None):
        use_cfg = neg_context is not None and guidance_scale > 1.0
        lat_t = latents.shape[2]
        x = latents.float()
        n_steps = len(sigmas) - 1
        for i in range(n_steps):
            t_frames = torch.full((1, lat_t), float(np.float32(sigmas[i] * 1000.0)), dtype=torch.float32,
                                  device=self.device)
            t_frames[:, :num_cond_latents] = 0.0
            v = self._forward(x, t_frames, context, neg_context if use_cfg else None, guidance_scale,
                              num_cond_latents, kv_cache, num_ctx_latents).float()
            # the model predicts the negated flow: x' = x − dt·v
            step = float(np.float32(sigmas[i + 1] - sigmas[i]))
            if num_cond_latents > 0:
                x = torch.cat([x[:, :, :num_cond_latents],
                               x[:, :, num_cond_latents:] + step * (-v[:, :, num_cond_latents:])], dim=2)
            else:
                x = x + step * (-v)
            if progress_callback is not None:
                safe_emit_progress(progress_callback, (i + 1) / n_steps, f"step {i + 1}/{n_steps}")
        return x

    @torch.inference_mode()
    def build_kv_cache(self, cond_latents: torch.Tensor, text_len: int):
        """Each block's pre-RoPE K/V of the clean context (t = 0, the
        cross-attention skipped)."""
        tf = self.transformer
        empty = torch.zeros(1, text_len, tf.cfg.caption_channels, device=self.device)
        t = torch.zeros(cond_latents.shape[0], cond_latents.shape[2], device=self.device)
        _, caches = tf(cond_latents.to(tf.dtype), t, empty, return_kv=True, skip_crs_attn=True)
        return caches

    @torch.inference_mode()
    def decode_video(self, latents: torch.Tensor) -> List[np.ndarray]:
        out = self.vae.decode(latents.float())  # [B, 3, T, H, W]
        b, c, t, h, w = out.shape
        return self.tensor_to_frames(out.transpose(1, 2).reshape(b * t, c, h, w))

    def _frames_tensor(self, frames: List[np.ndarray], height: int, width: int) -> torch.Tensor:
        import cv2

        arr = np.stack([cv2.resize(np.asarray(f), (width, height), interpolation=cv2.INTER_LANCZOS4)
                        for f in frames])
        px = torch.from_numpy(arr.astype(np.float32) / 127.5 - 1.0).permute(3, 0, 1, 2)[None]
        return px.contiguous().to(self.device)

    @torch.inference_mode()
    def _encode(self, px: torch.Tensor) -> torch.Tensor:
        return self.vae.encode(px.float()).float()

    def _geometry(self, height, width, num_frames):
        t_scale = self.vae.cfg.temporal_scale
        s_scale = self.vae.cfg.spatial_scale
        _, ph, pw = self.transformer.cfg.patch_size
        height -= height % (s_scale * ph)
        width -= width % (s_scale * pw)
        num_frames = max(1, num_frames - (num_frames - 1) % t_scale)
        lat_t = (num_frames - 1) // t_scale + 1
        return height, width, num_frames, lat_t, height // s_scale, width // s_scale

    def _contexts(self, prompt, negative_prompt, guidance_scale):
        ctx = self.encode_prompt(prompt or "")
        nctx = self.encode_prompt(negative_prompt or "") if guidance_scale > 1.0 else None
        return ctx, nctx

    def generate_t2v(self, prompt, negative_prompt, height, width, num_frames, num_inference_steps,
                     guidance_scale, seed, use_distill, progress_callback=None):
        self.load_components()
        height, width, num_frames, lat_t, lat_h, lat_w = self._geometry(height, width, num_frames)
        ctx, nctx = self._contexts(prompt, negative_prompt, guidance_scale)
        x = self.get_latents((1, self.transformer.cfg.in_channels, lat_t, lat_h, lat_w), seed=seed)
        sig = self.sigmas_for(num_inference_steps, use_distill)
        x = self.denoise(x, sig, ctx, nctx, guidance_scale, progress_callback=progress_callback)
        return x, (height, width, num_frames)

    def generate_vc(self, frames, prompt, negative_prompt, height, width, num_frames, num_cond_frames,
                    num_inference_steps, guidance_scale, seed, use_kv_cache=True, use_distill=False,
                    progress_callback=None):
        """Continue ``frames`` by ``num_frames`` new frames; returns the
        latents of [context + new] and the pixel geometry."""
        self.load_components()
        t_scale = self.vae.cfg.temporal_scale
        height, width, num_frames, _, lat_h, lat_w = self._geometry(height, width, num_frames)
        num_cond_frames = min(num_cond_frames, len(frames))
        num_cond_frames = max(1, num_cond_frames - (num_cond_frames - 1) % t_scale)
        cond_lat = self._encode(self._frames_tensor(frames[-num_cond_frames:], height, width))
        num_cond_latents = cond_lat.shape[2]

        lat_new = (num_frames - 1) // t_scale + 1
        ctx, nctx = self._contexts(prompt, negative_prompt, guidance_scale)
        noise = self.get_latents((1, self.transformer.cfg.in_channels, lat_new, lat_h, lat_w), seed=seed)
        sig = self.sigmas_for(num_inference_steps, use_distill)
        if use_kv_cache:
            cache = self.build_kv_cache(cond_lat, int(ctx[0].shape[1]))
            x = self.denoise(noise, sig, ctx, nctx, guidance_scale, kv_cache=cache,
                             num_ctx_latents=num_cond_latents, progress_callback=progress_callback)
            del cache
            full = torch.cat([cond_lat, x], dim=2)
        else:
            stacked = torch.cat([cond_lat, noise], dim=2)
            full = self.denoise(stacked, sig, ctx, nctx, guidance_scale, num_cond_latents=num_cond_latents,
                                progress_callback=progress_callback)
        return full, num_cond_frames, (height, width)

    def _load_frames(self, video) -> List[np.ndarray]:
        if isinstance(video, (str, bytes)) or hasattr(video, "__fspath__"):
            from apex_studio_tpu_torch.preprocess.base import load_frames

            return load_frames(video)
        return [np.asarray(f) for f in video]


@register_engine("longcat", "t2v")
class LongCatT2VEngine(LongCatShared):
    @torch.inference_mode()
    def run(self, prompt=None, negative_prompt=None, height: int = 480, width: int = 832, duration=None,
            fps: int = 15, num_frames: Optional[int] = None, num_inference_steps: int = 50,
            guidance_scale: float = 4.0, use_distill: bool = False, seed: Optional[int] = None,
            return_latents: bool = False, progress_callback: Optional[Callable] = None, offload: bool = True,
            **_: Any):
        safe_emit_progress(progress_callback, 0.0, "Starting LongCat t2v")
        if num_frames is None:
            num_frames = int(round((duration or 6.2) * fps)) + 1
        cb = make_mapped_progress(progress_callback, 0.1, 0.9)
        x, _ = self.generate_t2v(prompt, negative_prompt, height, width, num_frames, num_inference_steps,
                                 guidance_scale, seed, use_distill, cb)
        if return_latents:
            return x
        frames = self.decode_video(x)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames


@register_engine("longcat", "i2v")
class LongCatI2VEngine(LongCatShared):
    @torch.inference_mode()
    def run(self, image=None, prompt=None, negative_prompt=None, height: int = 480, width: int = 832,
            duration=None, fps: int = 15, num_frames: Optional[int] = None, num_inference_steps: int = 50,
            guidance_scale: float = 4.0, use_distill: bool = False, seed: Optional[int] = None,
            return_latents: bool = False, progress_callback: Optional[Callable] = None, offload: bool = True,
            **_: Any):
        safe_emit_progress(progress_callback, 0.0, "Starting LongCat i2v")
        self.load_components()
        if image is None:
            raise ValueError("i2v requires an input image")
        img = self.load_image_input(image)
        if num_frames is None:
            num_frames = int(round((duration or 6.2) * fps)) + 1
        height, width, num_frames, lat_t, lat_h, lat_w = self._geometry(height, width, num_frames)
        cond_lat = self._encode(self._frames_tensor([img], height, width))  # [1, C, 1, h, w]
        ctx, nctx = self._contexts(prompt, negative_prompt, guidance_scale)
        noise = self.get_latents((1, self.transformer.cfg.in_channels, lat_t, lat_h, lat_w), seed=seed)
        x = torch.cat([cond_lat, noise[:, :, 1:]], dim=2)
        sig = self.sigmas_for(num_inference_steps, use_distill)
        cb = make_mapped_progress(progress_callback, 0.2, 0.9)
        x = self.denoise(x, sig, ctx, nctx, guidance_scale, num_cond_latents=1, progress_callback=cb)
        if return_latents:
            return x
        frames = self.decode_video(x)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames


@register_engine("longcat", "vc")
class LongCatVCEngine(LongCatShared):
    @torch.inference_mode()
    def run(self, video=None, prompt=None, negative_prompt=None, height: int = 480, width: int = 832,
            duration=None, fps: int = 15, num_frames: Optional[int] = None, num_cond_frames: int = 13,
            num_inference_steps: int = 50, guidance_scale: float = 4.0, use_kv_cache: bool = True,
            use_distill: bool = False, seed: Optional[int] = None, return_latents: bool = False,
            progress_callback: Optional[Callable] = None, offload: bool = True, **_: Any):
        safe_emit_progress(progress_callback, 0.0, "Starting LongCat vc")
        if video is None:
            raise ValueError("vc requires an input video")
        frames = self._load_frames(video)
        if num_frames is None:
            num_frames = int(round((duration or 6.2) * fps)) + 1
        cb = make_mapped_progress(progress_callback, 0.15, 0.9)
        full, _, _ = self.generate_vc(frames, prompt, negative_prompt, height, width, num_frames, num_cond_frames,
                                      num_inference_steps, guidance_scale, seed, use_kv_cache, use_distill, cb)
        if return_latents:
            return full
        out = self.decode_video(full)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return out


@register_engine("longcat", "continuation")
class LongCatContinuationEngine(LongCatVCEngine):
    """The source resampled to the model fps, then one vc segment."""

    @torch.inference_mode()
    def run(self, video=None, fps: int = 15, source_fps: Optional[int] = None, **kwargs: Any):
        frames = self._load_frames(video)
        if source_fps and source_fps > fps:
            frames = frames[::max(1, round(source_fps / fps))]
        return super().run(video=frames, fps=fps, **kwargs)


@register_engine("longcat", "long_video")
class LongCatLongVideoEngine(LongCatVCEngine):
    """A t2v first segment, then vc segments with the KV cache, each
    continuing the frames decoded so far."""

    @torch.inference_mode()
    def run(self, prompt=None, prompts: Optional[List[str]] = None, negative_prompt=None, num_segments: int = 3,
            height: int = 480, width: int = 832, duration=None, fps: int = 15, num_frames: Optional[int] = None,
            num_cond_frames: int = 13, num_inference_steps: int = 50, guidance_scale: float = 4.0,
            use_distill: bool = False, seed: Optional[int] = None, progress_callback: Optional[Callable] = None,
            offload: bool = True, **_: Any):
        safe_emit_progress(progress_callback, 0.0, "Starting LongCat long video")
        if num_frames is None:
            num_frames = int(round((duration or 6.2) * fps)) + 1
        seg_prompts = prompts or [prompt] * (num_segments + 1)
        num_segments = len(seg_prompts) - 1
        total = num_segments + 1
        cb = make_mapped_progress(progress_callback, 0.05, 0.95)
        x, _ = self.generate_t2v(seg_prompts[0], negative_prompt, height, width, num_frames, num_inference_steps,
                                 guidance_scale, seed, use_distill, make_mapped_progress(cb, 0.0, 1.0 / total))
        all_frames = self.decode_video(x)
        for s in range(num_segments):
            seg_cb = make_mapped_progress(cb, (s + 1) / total, (s + 2) / total)
            full, n_cond, _ = self.generate_vc(all_frames, seg_prompts[s + 1], negative_prompt, height, width,
                                               num_frames, num_cond_frames, num_inference_steps, guidance_scale,
                                               None if seed is None else seed + s + 1, True, use_distill, seg_cb)
            all_frames.extend(self.decode_video(full)[n_cond:])
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return all_frames


@register_engine("longcat", "interactive")
class LongCatInteractiveEngine(LongCatLongVideoEngine):
    """One prompt a segment; a single prompt is split into sentences."""

    @torch.inference_mode()
    def run(self, prompt=None, prompts: Optional[List[str]] = None, **kwargs: Any):
        if not prompts and prompt:
            prompts = split_into_sentences(prompt)
        if not prompts:
            raise ValueError("interactive mode needs at least one prompt")
        return super().run(prompts=prompts, **kwargs)


@register_engine("longcat", "refine")
class LongCatRefineEngine(LongCatShared):
    @torch.inference_mode()
    def run(self, video=None, prompt=None, height: int = 720, width: int = 1280, num_inference_steps: int = 50,
            t_thresh: float = 0.5, spatial_refine_only: bool = False, seed: Optional[int] = None,
            return_latents: bool = False, progress_callback: Optional[Callable] = None, offload: bool = True,
            **_: Any):
        safe_emit_progress(progress_callback, 0.0, "Starting LongCat refine")
        self.load_components()
        if video is None:
            raise ValueError("refine requires an input video")
        frames = self._load_frames(video)
        t_scale = self.vae.cfg.temporal_scale
        height, width, _, _, _, _ = self._geometry(height, width, 1)

        n_in = len(frames)
        new_n = n_in if spatial_refine_only else 2 * n_in
        px = self._frames_tensor(frames, height, width)  # [1, 3, T, H, W]
        if new_n != n_in:
            px = upsample_time(px, new_n)
        # pad the tail so the frames fill whole latent slots (the causal Wan
        # VAE takes 1 + k·t_scale frames)
        pad_back = (t_scale - (new_n - 1) % t_scale) % t_scale
        if pad_back:
            px = torch.cat([px, px[:, :, -1:].expand(-1, -1, pad_back, -1, -1)], dim=2)

        z = self._encode(px)
        del px
        noise = self.get_latents(tuple(z.shape), seed=seed)
        x = (1.0 - t_thresh) * z + t_thresh * noise

        sig_full = self.sigmas_for(num_inference_steps)[:-1]
        sig = np.concatenate([[t_thresh], sig_full[sig_full < t_thresh], [0.0]])
        ctx = self.encode_prompt(prompt or "")
        cb = make_mapped_progress(progress_callback, 0.2, 0.9)
        x = self.denoise(x, sig, ctx, None, 1.0, progress_callback=cb)
        if return_latents:
            return x
        out = self.decode_video(x)[:new_n]
        safe_emit_progress(progress_callback, 1.0, "Refine complete")
        return out
