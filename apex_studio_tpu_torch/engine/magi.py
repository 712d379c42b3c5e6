"""MAGI-1 engines (t2v, i2v, v2v), port of ``apex_studio_tpu/engine/magi.py``.

Latent time is split into chunks of ``chunk_width`` frames; a sliding window
of ``window_size`` chunks denoises at once, each chunk at its own point of the
schedule, so chunk i is conditioned on the cleaner chunks before it through
the DiT's block-causal attention.

- no KV cache: clean context chunks re-enter the forward (at most
  ``context_chunks``), as in JAX
- three CFG branches a step: text and previous-chunk over the whole window
  (the negative caption on the context chunks), and unconditional, each
  active chunk alone (a batch of B·r chunks, one chunk each, no mask); the
  t-bucketed scales are schedule constants combined on the host
- i2v pins the first latent frame to the encoded image (one latent frame's
  worth of frames, ``cv2.INTER_AREA``); v2v pins the source's whole chunks
"""

from __future__ import annotations

import math
from typing import Any, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress


class MagiShared(BaseEngine):
    context_chunks: int = 4  # clean chunks re-fed as context (no KV cache)

    def load_components(self) -> None:
        self.load_missing("text_encoder", "transformer", "vae", "scheduler")

    def encode_prompt(self, prompt: str, max_sequence_length: int = 800):
        hidden, mask = self.text_encoder.encode([prompt], max_sequence_length=max_sequence_length,
                                                use_chat_template=False)
        return hidden, mask.bool()

    def _forward(self, x, t_vec, y, y_mask, dropout: bool, block_causal: bool = True):
        t = torch.as_tensor(np.asarray(t_vec, np.float32), device=x.device)[None].repeat(x.shape[0], 1)
        return self.transformer(x, t, y, y_mask, caption_dropout=dropout, block_causal=block_causal)

    @staticmethod
    def _cfg_scales(t_active: np.ndarray, cfg_t_range, prev_scales, text_scales):
        idx = np.searchsorted(np.asarray(cfg_t_range) - 1e-7, t_active) - 1
        idx = np.clip(idx, 0, len(prev_scales) - 1)
        return np.asarray(prev_scales)[idx], np.asarray(text_scales)[idx]

    def _cfg_forward(self, x_seq, t_full, n_ctx, ctx, ctx_mask, neg, neg_mask, cfg_number, cfg_t_range,
                     prev_chunk_scales, text_scales, chunk_width):
        """x_seq: (B, C, (n_ctx + R)·cw, H, W); t_full: n_ctx + R values.
        Returns the velocity of the R active chunks."""
        b = x_seq.shape[0]
        r_act = len(t_full) - n_ctx

        def tile_y(base, base_mask, n):
            return (base[:, None].expand(b, n, *base.shape[1:]),
                    base_mask[:, None].expand(b, n, base_mask.shape[-1]))

        # captions per chunk: the clean context chunks take the negative entry
        y_t, m_t = tile_y(ctx, ctx_mask, r_act)
        y_n, m_n = tile_y(neg, neg_mask, r_act)
        if n_ctx:
            y_c, m_c = tile_y(neg, neg_mask, n_ctx)
            y_text, m_text = torch.cat([y_c, y_t], dim=1), torch.cat([m_c, m_t], dim=1)
            y_null, m_null = torch.cat([y_c, y_n], dim=1), torch.cat([m_c, m_n], dim=1)
        else:
            y_text, m_text, y_null, m_null = y_t, m_t, y_n, m_n

        act = self._forward(x_seq, t_full, y_text, m_text, dropout=False)[:, :, n_ctx * chunk_width:]
        if cfg_number != 3:
            return act
        out_pre = self._forward(x_seq, t_full, y_null, m_null, dropout=True)[:, :, n_ctx * chunk_width:]
        # unconditional: each active chunk alone (a batch of B·r_act, r = 1, no mask)
        x_act = x_seq[:, :, n_ctx * chunk_width:]
        c, h, w = x_act.shape[1], x_act.shape[3], x_act.shape[4]
        xu = x_act.reshape(b, c, r_act, chunk_width, h, w).transpose(1, 2).reshape(b * r_act, c, chunk_width, h, w)
        yu = neg[:, None].expand(b, r_act, *neg.shape[1:]).reshape(b * r_act, 1, *neg.shape[1:])
        mu = neg_mask[:, None].expand(b, r_act, neg_mask.shape[-1]).reshape(b * r_act, 1, -1)
        t_u = torch.as_tensor(np.asarray(t_full[n_ctx:], np.float32), device=x_seq.device).reshape(-1, 1).repeat(b, 1)
        out_u = self.transformer(xu, t_u, yu, mu, caption_dropout=True, block_causal=False)
        out_u = out_u.reshape(b, r_act, c, chunk_width, h, w).transpose(1, 2).reshape(b, c, r_act * chunk_width, h, w)

        prev_s, text_s = self._cfg_scales(np.asarray(t_full[n_ctx:]), cfg_t_range, prev_chunk_scales, text_scales)
        ps = torch.as_tensor(np.repeat(prev_s, chunk_width), dtype=act.dtype, device=act.device).reshape(1, 1, -1, 1, 1)
        ts = torch.as_tensor(np.repeat(text_s, chunk_width), dtype=act.dtype, device=act.device).reshape(1, 1, -1, 1, 1)
        return (1.0 - ps) * out_u + (ps - ts) * out_pre + ts * act

    def denoise(self, x: torch.Tensor, ctx, ctx_mask, neg, neg_mask, num_inference_steps: int, chunk_width: int,
                window_size: int, cfg_number: int, cfg_t_range, text_scales, prev_chunk_scales,
                prefix_chunks: int = 0, clean_frames: Optional[torch.Tensor] = None,
                progress_callback=None) -> torch.Tensor:
        """The sliding window over stages: x (B, C, T_lat, H, W) noise;
        ``prefix_chunks`` whole clean chunks and ``clean_frames`` (kept clean,
        pinned after every step) at the start."""
        sched = self.scheduler
        d = max(1, num_inference_steps // window_size)
        sched.set_scheduler_params(chunk_width, d)
        num_chunks = x.shape[2] // chunk_width
        window_size = min(window_size, num_chunks - prefix_chunks) or 1
        total = d * (num_chunks + window_size - 1 - prefix_chunks)
        x = x.clone()
        if clean_frames is not None:
            x[:, :, :clean_frames.shape[2]] = clean_frames

        for step in range(total):
            stage, idx = divmod(step, d)
            i = prefix_chunks + stage
            chunk_start = max(prefix_chunks, i - window_size + 1)
            chunk_end = min(num_chunks, i + 1)
            t_start = max(0, i - (num_chunks - 1))
            t_end = min(window_size, i - prefix_chunks + 1) if i - prefix_chunks < window_size else window_size
            n_ctx = min(chunk_start, self.context_chunks)
            t_act = sched.chunk_timesteps(t_start, t_end, idx)
            t_full = np.concatenate([np.full(n_ctx, sched.clean_t, np.float32), t_act])

            lo, hi = (chunk_start - n_ctx) * chunk_width, chunk_end * chunk_width
            flow = self._cfg_forward(x[:, :, lo:hi], t_full, n_ctx, ctx, ctx_mask, neg, neg_mask, cfg_number,
                                     cfg_t_range, prev_chunk_scales, text_scales, chunk_width)
            a = chunk_start * chunk_width
            x[:, :, a:hi] = sched.step(x[:, :, a:hi], flow, t_start, t_end, idx)
            if clean_frames is not None:
                x[:, :, :clean_frames.shape[2]] = clean_frames
            safe_emit_progress(progress_callback, (step + 1) / total, f"magi stage {stage + 1} step {idx + 1}/{d}")
        return x

    def _run(self, prompt: str, negative_prompt: Optional[str], height: int, width: int, num_frames: int,
             num_inference_steps: int, seed, chunk_width: int, window_size: int, cfg_number: int, cfg_t_range,
             text_scales, prev_chunk_scales, return_latents: bool, progress_callback,
             prefix_latents: Optional[torch.Tensor] = None, prefix_is_chunks: bool = False, **_: Any):
        self.load_components()
        safe_emit_progress(progress_callback, 0.05, "components ready")
        ctx, ctx_mask = self.encode_prompt(prompt)
        neg, neg_mask = self.encode_prompt(negative_prompt or "")
        safe_emit_progress(progress_callback, 0.15, "prompt encoded")

        st, tt = self.vae.spatial_compression_ratio, self.vae.temporal_compression_ratio
        t_lat = max(1, math.ceil(num_frames / tt))
        num_chunks = max(1, math.ceil(t_lat / chunk_width))
        t_lat = num_chunks * chunk_width
        cfg = self.transformer.cfg
        z_ch = cfg.in_channels // 2 if cfg.half_channel_vae else cfg.in_channels
        x = self.get_latents((1, z_ch, t_lat, height // st, width // st), seed=seed)

        prefix_chunks, clean_frames = 0, None
        if prefix_latents is not None:
            clean_frames = prefix_latents
            if prefix_is_chunks:
                prefix_chunks = prefix_latents.shape[2] // chunk_width
                x[:, :, :prefix_latents.shape[2]] = prefix_latents

        self.get_timesteps(self.scheduler, num_inference_steps)
        x = self.denoise(x, ctx, ctx_mask, neg, neg_mask, num_inference_steps, chunk_width, window_size,
                         cfg_number, cfg_t_range, text_scales, prev_chunk_scales, prefix_chunks=prefix_chunks,
                         clean_frames=clean_frames,
                         progress_callback=make_mapped_progress(progress_callback, 0.2, 0.9))
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "returning latents")
            return x
        frames = self.decode_latents(x)
        safe_emit_progress(progress_callback, 1.0, "completed pipeline")
        return frames

    def decode_latents(self, z: torch.Tensor) -> List[np.ndarray]:
        video = self.vae.decode(z.float())
        b, c, t, h, w = video.shape
        return self.tensor_to_frames(video.transpose(1, 2).reshape(b * t, c, h, w))

    @staticmethod
    def _frames(num_frames, duration) -> int:
        if num_frames is not None:
            return num_frames
        return int(duration) if str(duration).isdigit() else 96

    @staticmethod
    def _opts(kwargs) -> dict:
        return {**_DEFAULTS, **{k: v for k, v in kwargs.items() if k in _DEFAULTS}}


_DEFAULTS = dict(
    chunk_width=6, window_size=4, cfg_number=3,
    cfg_t_range=(0.0, 0.0217, 0.1, 0.3, 0.999),
    text_scales=(7.5, 7.5, 7.5, 0.0, 0.0),
    prev_chunk_scales=(1.5, 1.5, 1.5, 1.0, 1.0),
)


@register_engine("magi", "t2v")
class MagiT2VEngine(MagiShared):
    @torch.inference_mode()
    def run(self, prompt: str = "", negative_prompt: Optional[str] = None, height: int = 512, width: int = 512,
            duration: Any = 96, fps: int = 24, num_frames: Optional[int] = None, num_inference_steps: int = 64,
            seed: Optional[int] = None, return_latents: bool = False, progress_callback=None, **kwargs: Any):
        return self._run(prompt, negative_prompt, height, width, self._frames(num_frames, duration),
                         num_inference_steps, seed, return_latents=return_latents,
                         progress_callback=progress_callback, **self._opts(kwargs))


@register_engine("magi", "i2v")
class MagiI2VEngine(MagiShared):
    """The first latent frame is pinned to the encoded image (a one-latent-frame prefix)."""

    @torch.inference_mode()
    def run(self, image: Any = None, prompt: str = "", negative_prompt: Optional[str] = None, height: int = 512,
            width: int = 512, duration: Any = 96, fps: int = 24, num_frames: Optional[int] = None,
            num_inference_steps: int = 64, seed: Optional[int] = None, return_latents: bool = False,
            progress_callback=None, **kwargs: Any):
        import cv2

        self.load_components()
        arr = cv2.resize(self.load_image_input(image), (width, height), interpolation=cv2.INTER_AREA)
        vid = torch.from_numpy(np.ascontiguousarray(arr)).float().permute(2, 0, 1)[None, :, None] / 127.5 - 1.0
        vid = vid.repeat(1, 1, self.vae.temporal_compression_ratio, 1, 1)  # one latent frame's worth
        prefix = self.encode_video_latents(vid)
        return self._run(prompt, negative_prompt, height, width, self._frames(num_frames, duration),
                         num_inference_steps, seed, return_latents=return_latents,
                         progress_callback=progress_callback, prefix_latents=prefix, prefix_is_chunks=False,
                         **self._opts(kwargs))


@register_engine("magi", "v2v")
class MagiV2VEngine(MagiShared):
    """Continue a video: its whole latent chunks become the clean prefix."""

    @torch.inference_mode()
    def run(self, video: Any = None, prompt: str = "", negative_prompt: Optional[str] = None, height: int = 512,
            width: int = 512, duration: Any = 96, fps: int = 24, num_frames: Optional[int] = None,
            num_inference_steps: int = 64, seed: Optional[int] = None, return_latents: bool = False,
            progress_callback=None, **kwargs: Any):
        opts = self._opts(kwargs)
        self.load_components()
        frames = self.load_video_input(video, height, width)
        vid = torch.from_numpy(np.stack(frames)).float().permute(3, 0, 1, 2)[None] / 127.5 - 1.0
        tt = self.vae.temporal_compression_ratio
        prefix = self.encode_video_latents(vid[:, :, :(vid.shape[2] // tt) * tt])
        cw = opts["chunk_width"]
        pc = prefix.shape[2] // cw
        if pc:
            prefix = prefix[:, :, :pc * cw]
        return self._run(prompt, negative_prompt, height, width, self._frames(num_frames, duration),
                         num_inference_steps, seed, return_latents=return_latents,
                         progress_callback=progress_callback, prefix_latents=prefix, prefix_is_chunks=bool(pc),
                         **opts)

    @staticmethod
    def load_video_input(video: Any, height: int, width: int):
        import cv2

        from apex_studio_tpu_torch.preprocess.base import load_frames

        frames = load_frames(video) if isinstance(video, str) else list(video)
        return [cv2.resize(np.asarray(fr), (width, height), interpolation=cv2.INTER_AREA) for fr in frames]
