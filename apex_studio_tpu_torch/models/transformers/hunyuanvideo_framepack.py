"""HunyuanVideo FramePack DiT, port of
``apex_studio_tpu/models/transformers/hunyuanvideo_framepack.py``.

The HunyuanVideo DiT with FramePack's anti-drifting context:

- clean history latents at three scales (1x, 2x, 4x: patchify + Linear over
  (1,2,2), (2,4,4) and (4,8,8) patches) prepended to the noisy section's
  tokens in the order 4x, 2x, clean, section;
- RoPE from explicit frame indices per segment; the 2x / 4x tables are the
  full-resolution ones averaged over 2³ / 4³ blocks with edge padding;
- SigLIP image embeddings projected (up ×3, SiLU, down) and prepended to the
  refined text, their slots always kept;
- only the section's own tokens are projected out. There is no
  token_replace path.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.models.transformers.hunyuanvideo import (
    HunyuanVideoConfig,
    HunyuanVideoTransformer3DModel,
    _patch,
)


def _avg_pool_rope(tab: np.ndarray, t: int, h: int, w: int, k: int) -> np.ndarray:
    """[T·H·W, D/2] table averaged over k×k×k blocks, edges replicated."""
    d = tab.shape[-1]
    x = tab.reshape(t, h, w, d)
    pt, ph, pw = (k - t % k) % k, (k - h % k) % k, (k - w % k) % k
    x = np.pad(x, ((0, pt), (0, ph), (0, pw), (0, 0)), mode="edge")
    tt, hh, ww = x.shape[:3]
    return x.reshape(tt // k, k, hh // k, k, ww // k, k, d).mean(axis=(1, 3, 5)).reshape(-1, d)


class FramepackHistoryEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, *, dtype):
        super().__init__()
        self.proj = Linear(cin * 1 * 2 * 2, dim, dtype=dtype)
        self.proj_2x = Linear(cin * 2 * 4 * 4, dim, dtype=dtype)
        self.proj_4x = Linear(cin * 4 * 8 * 8, dim, dtype=dtype)

    def embed(self, x: torch.Tensor, scale: int, dtype) -> torch.Tensor:
        if scale == 1:
            return self.proj(_patch(x, 1, 2).to(dtype))
        if scale == 2:
            return self.proj_2x(_patch(x, 2, 4).to(dtype))
        return self.proj_4x(_patch(x, 4, 8).to(dtype))


class FramepackImageProjection(nn.Module):
    def __init__(self, cin: int, dim: int, *, dtype):
        super().__init__()
        self.up = Linear(cin, dim * 3, dtype=dtype)
        self.down = Linear(dim * 3, dim, dtype=dtype)

    def forward(self, x):
        return self.down(F.silu(self.up(x)))


@transformer_registry.register("hunyuanvideo.framepack",
                               aliases=("framepack", "HunyuanVideoFramepackTransformer3DModel"))
class HunyuanVideoFramepackTransformer3DModel(HunyuanVideoTransformer3DModel):
    config_class = HunyuanVideoConfig

    def __init__(self, cfg: Optional[HunyuanVideoConfig] = None, *, dtype=torch.bfloat16):
        cfg = cfg or HunyuanVideoConfig()
        super().__init__(cfg, dtype=dtype)
        self.clean_x_embedder = FramepackHistoryEmbed(cfg.in_channels, cfg.dim, dtype=dtype)
        self.image_projection = FramepackImageProjection(getattr(cfg, "image_proj_dim", 1152), cfg.dim,
                                                         dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,                     # [B, C, T, H, W] noisy section
        t: torch.Tensor,                     # [B]
        text: torch.Tensor,                  # [B, Lt, 4096]
        text_mask: Optional[torch.Tensor] = None,
        pooled: Optional[torch.Tensor] = None,
        guidance: Optional[torch.Tensor] = None,
        image_embeds: Optional[torch.Tensor] = None,   # [B, Li, image_proj_dim]
        indices_latents=None,
        latents_clean: Optional[torch.Tensor] = None,
        indices_latents_clean=None,
        latents_history_2x: Optional[torch.Tensor] = None,
        indices_latents_history_2x=None,
        latents_history_4x: Optional[torch.Tensor] = None,
        indices_latents_history_4x=None,
    ) -> torch.Tensor:
        cfg = self.cfg
        b, _, tt, hh, ww = x.shape
        h_tok, w_tok = hh // cfg.patch_size, ww // cfg.patch_size
        if indices_latents is None:
            indices_latents = np.arange(tt)
        temb, _ = self.embed_conditions(t, pooled, guidance, token_replace=False)

        img = self.x_embedder(self.patchify(x).to(self.dtype))
        n_out = img.shape[1]
        cos, sin = self.rope_for_indices(indices_latents, h_tok, w_tok)
        segments: List[Tuple[torch.Tensor, np.ndarray, np.ndarray]] = []
        if latents_clean is not None:
            ccos, csin = self.rope_for_indices(indices_latents_clean, h_tok, w_tok)
            segments.append((self.clean_x_embedder.embed(latents_clean, 1, self.dtype), ccos, csin))
        for scale, lat, idx in ((2, latents_history_2x, indices_latents_history_2x),
                                (4, latents_history_4x, indices_latents_history_4x)):
            if lat is None:
                continue
            n_t = len(np.asarray(idx))
            hc, hs = self.rope_for_indices(idx, h_tok, w_tok)
            segments.append((self.clean_x_embedder.embed(lat, scale, self.dtype),
                             _avg_pool_rope(hc, n_t, h_tok, w_tok, scale),
                             _avg_pool_rope(hs, n_t, h_tok, w_tok, scale)))
        for toks, pc, ps in segments:  # each goes to the front: 4x, 2x, clean, section
            img = torch.cat([toks, img], dim=1)
            cos, sin = np.concatenate([pc, cos], axis=0), np.concatenate([ps, sin], axis=0)
        rope_cos, rope_sin = (torch.from_numpy(a)[None, :, None, :].to(img.device) for a in (cos, sin))

        txt = self.context_embedder(text.to(self.dtype), t, text_mask)
        if image_embeds is not None:
            img_txt = self.image_projection(image_embeds.to(self.dtype))
            txt = torch.cat([img_txt, txt], dim=1)
            if text_mask is not None:
                text_mask = torch.cat([torch.ones(b, img_txt.shape[1], dtype=text_mask.dtype,
                                                  device=text_mask.device), text_mask], dim=1)
        img = self.run_blocks(img, txt, text_mask, temb, None, 0, rope_cos, rope_sin)
        return self.unpatchify(self.proj_out(img[:, -n_out:]), tt, hh, ww)
