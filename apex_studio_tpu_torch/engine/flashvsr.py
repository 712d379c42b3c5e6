"""FlashVSR streaming video upscaler, port of ``apex_studio_tpu/engine/flashvsr.py``.

One-step (DMD) Wan-DiT video super-resolution in causal chunks: the first
chunk is latent frames 0–6, chunk c (c ≥ 1) frames 4+2c to 6+2c, with the DiT's
rolling self-attention cache carried from chunk to chunk; the LQ pixels'
features come from one pass of the LQ projector over the whole clip. The
latents decode through the Wan VAE (the full manifest) or the ``tiny_wan``
TCDecoder with the upscaled LQ video as its channel condition (the tiny one).

- the clip: the last frame repeated four times at the tail, cut to the
  largest 8n + 1 frames (at least 25), resized by ``cv2.INTER_LANCZOS4`` to the
  upscaled size cut to a multiple of 128
- the noise from numpy's seeded ``default_rng``, as in JAX
- the context: ``flashvsr/posi_prompt.pth`` under the components' root where
  it resolves, else zeros (the distilled model is prompt-insensitive)
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import safe_emit_progress

logger = logging.getLogger("apex.engine.flashvsr")


def largest_8n1_leq(n: int) -> int:
    """The largest 8k + 1 ≤ n."""
    return 0 if n < 1 else ((n - 1) // 8) * 8 + 1


@register_engine("flashvsr", "upscale")
class FlashVSRUpscaleEngine(BaseEngine):
    def _load_context(self, length: int = 512) -> torch.Tensor:
        """The fixed positive-prompt T5 embedding (``posi_prompt.pth``) where it
        resolves, else zeros [1, length, text_dim]."""
        text_dim = self.transformer.cfg.text_dim
        path = self._resolve_path("flashvsr/posi_prompt.pth")
        if path is not None:
            try:
                from apex_studio_tpu_torch.loaders.safetensors_io import load_torch_checkpoint

                arr = next(iter(load_torch_checkpoint(path).values()))
                return arr.float().reshape(1, -1, text_dim).to(self.device)
            except Exception:
                logger.exception("posi_prompt load failed; using zeros")
        return torch.zeros(1, length, text_dim, device=self.device)

    @torch.inference_mode()
    def run(self, video: Optional[Any] = None, image: Optional[Any] = None, height: Optional[int] = None,
            width: Optional[int] = None, upscale_factor: float = 4.0, seed: Optional[int] = None,
            kv_ratio: float = 3.0, local_range: int = 11, num_inference_steps: int = 1,
            guidance_scale: float = 1.0, max_frames: int = 121, fps: float = 24.0, return_latents: bool = False,
            progress_callback: Optional[Callable] = None, **_: Any):
        import cv2

        from apex_studio_tpu_torch.preprocess.base import load_frames

        safe_emit_progress(progress_callback, 0.0, "Starting FlashVSR upscale")
        self.load_missing("transformer", "vae")
        if video is not None:
            frames_in = (load_frames(video, max_frames=max_frames) if isinstance(video, str)
                         else list(video)[:max_frames])
        elif image is not None:
            frames_in = [self.load_image_input(image)] * 25
        else:
            raise ValueError("flashvsr upscale needs a video or an image")

        # four copies of the last frame at the tail, then the largest 8n + 1, at least 25 (three chunks)
        frames_in = list(frames_in) + [frames_in[-1]] * 4
        n_frames = largest_8n1_leq(len(frames_in))
        if n_frames < 25:
            frames_in = frames_in + [frames_in[-1]] * (25 - len(frames_in))
            n_frames = 25
        frames_in = frames_in[:n_frames]

        h0, w0 = np.asarray(frames_in[0]).shape[:2]
        height = height or int(round(h0 * upscale_factor))
        width = width or int(round(w0 * upscale_factor))
        height, width = max(height - height % 128, 128), max(width - width % 128, 128)
        up = [cv2.resize(np.asarray(fr), (width, height), interpolation=cv2.INTER_LANCZOS4) for fr in frames_in]
        vid = torch.from_numpy(np.stack(up)).to(self.device).float().permute(3, 0, 1, 2)[None] / 127.5 - 1.0

        tf = self.transformer
        n = (n_frames - 1) // 8
        t_lat, n_chunks = 2 * n, n - 2
        lat_h, lat_w = height // 8, width // 8
        h_tok, w_tok = lat_h // 2, lat_w // 2  # patch (1, 2, 2)
        rng = np.random.default_rng(seed if seed is not None else 0)
        noise = torch.from_numpy(rng.standard_normal((1, tf.cfg.in_dim, t_lat, lat_h, lat_w)).astype(np.float32))
        noise = noise.to(self.device)

        safe_emit_progress(progress_callback, 0.1, "Preparing LQ features")
        lq_all = tf.LQ_proj_in(vid)
        if getattr(self, "_context_kv", None) is None:
            t_emb, t_mod = tf.time_embed(1000.0)
            self._context_kv = (t_emb, t_mod, tf.context_kv(self._load_context()))
        t_emb, t_mod, ctx_kv = self._context_kv

        tok_per_lat = h_tok * w_tok
        out_chunks: List[torch.Tensor] = []
        caches = None
        safe_emit_progress(progress_callback, 0.2, "Denoising (streaming)")
        for c in range(n_chunks):
            a, b = (0, 6) if c == 0 else (4 + 2 * c, 6 + 2 * c)
            x_chunk = noise[:, :, a:b]
            lq = [t[:, a * tok_per_lat:b * tok_per_lat] for t in lq_all]
            cos, sin = tf.rope_for_chunk(b - a, h_tok, w_tok, 0 if c == 0 else a)
            pred, caches = tf(x_chunk, t_emb, t_mod, cos, sin, ctx_kv, lq_tokens=lq, caches=caches)
            out_chunks.append(x_chunk - pred.to(x_chunk.dtype))
            safe_emit_progress(progress_callback, 0.2 + 0.6 * (c + 1) / n_chunks,
                               f"FlashVSR chunk {c + 1}/{n_chunks}")
        del caches
        latents = torch.cat(out_chunks, dim=2)  # [1, 16, t_lat, h, w]
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return latents

        safe_emit_progress(progress_callback, 0.85, "Decoding")
        frames = self.decode_latents(latents, vid[:, :, :8 * n - 3])
        safe_emit_progress(progress_callback, 1.0, "Upscale complete")
        return frames

    def decode_latents(self, latents: torch.Tensor, cond: torch.Tensor) -> List[np.ndarray]:
        """Latents → frames through the Wan VAE (the full manifest), or the
        TCDecoder with the LQ video ``cond`` as its channel condition."""
        from apex_studio_tpu_torch.models.vaes.tae_vae import TAEVAE

        out = self.vae.decode(latents, cond=cond) if isinstance(self.vae, TAEVAE) else self.vae.decode(latents)
        b, c, t, h, w = out.shape
        return self.tensor_to_frames(out.transpose(1, 2).reshape(b * t, c, h, w))
