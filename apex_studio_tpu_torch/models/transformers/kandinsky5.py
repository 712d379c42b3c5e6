"""Kandinsky 5.0 video DiT, port of
``apex_studio_tpu/models/transformers/kandinsky5.py``.

A text-refiner + visual-decoder transformer:

- the Qwen2.5-VL sequence passes through ``num_text_blocks`` encoder blocks
  (1-D RoPE over the text positions, a 6-parameter modulation)
- the visual tokens run ``num_visual_blocks`` decoder blocks: self-attention
  with 3-axis interleaved-pair RoPE (``axes_dims``, each axis' coordinates
  divided by its ``scale_factor``), text cross-attention and a GELU
  feed-forward, each gated by a 9-parameter modulation of the time embedding
  plus the pooled CLIP vector
- the modulations are f32 Linears over SiLU(temb) (zero-initialised in the
  published model; the checkpoint fills them)
- q/k RMSNorm in f32; every attention unmasked, as in JAX (the engine does
  not pass the Qwen mask)
- patches are channel-last (pt, ph, pw, C) on the way in; the output
  features are ordered (C, pt, ph, pw)
- ``visual_cond`` (i2v) takes the latent, the first-frame latent and a
  validity mask: 2·C + 1 input channels

Head dim ``sum(axes_dims)`` (64 at the published widths: 28 heads at 1792).
Same attribute names and dtype flow as the JAX module; every attention goes
to ``ops.attention`` (the flash kernel on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import LayerNorm, Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.ops.attention import attention
from apex_studio_tpu_torch.ops.rope import apply_rope, rope_freqs_1d


@dataclasses.dataclass
class Kandinsky5Config:
    in_visual_dim: int = 16
    out_visual_dim: int = 16
    in_text_dim: int = 3584
    in_text_dim2: int = 768
    time_dim: int = 512
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    model_dim: int = 1792
    ff_dim: int = 7168
    num_text_blocks: int = 2
    num_visual_blocks: int = 32
    axes_dims: Tuple[int, int, int] = (16, 24, 24)
    visual_cond: bool = False

    @property
    def head_dim(self) -> int:
        return sum(self.axes_dims)

    @classmethod
    def from_dict(cls, cfg: dict) -> "Kandinsky5Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg.items() if k in known}
        return cls(**kw)


class _Modulation(nn.Module):
    """SiLU → Linear(time_dim, n·model_dim) in f32."""

    def __init__(self, time_dim: int, model_dim: int, n: int):
        super().__init__()
        self.out_layer = Linear(time_dim, n * model_dim, dtype=torch.float32)
        self.n = n
        self.model_dim = model_dim

    def forward(self, temb):
        return self.out_layer(F.silu(temb.float()))[:, None].chunk(self.n, dim=-1)


class _K5Attention(nn.Module):
    def __init__(self, dim: int, head_dim: int, *, dtype):
        super().__init__()
        self.to_query = Linear(dim, dim, dtype=dtype)
        self.to_key = Linear(dim, dim, dtype=dtype)
        self.to_value = Linear(dim, dim, dtype=dtype)
        self.out_layer = Linear(dim, dim, dtype=dtype)
        self.query_norm = RMSNorm(head_dim)
        self.key_norm = RMSNorm(head_dim)
        self.heads = dim // head_dim
        self.head_dim = head_dim

    def forward(self, x, context=None, rope=None):
        b, s, d = x.shape
        kv_in = x if context is None else context
        q = self.to_query(x).reshape(b, s, self.heads, self.head_dim)
        k = self.to_key(kv_in).reshape(b, -1, self.heads, self.head_dim)
        v = self.to_value(kv_in).reshape(b, -1, self.heads, self.head_dim)
        q = self.query_norm(q.float()).to(x.dtype)
        k = self.key_norm(k.float()).to(x.dtype)
        if rope is not None:
            cos, sin = rope
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        out = attention(q, k, v)
        return self.out_layer(out.reshape(b, s, d))


class _K5FF(nn.Module):
    def __init__(self, dim: int, ff_dim: int, *, dtype):
        super().__init__()
        self.in_layer = Linear(dim, ff_dim, use_bias=False, dtype=dtype)
        self.out_layer = Linear(ff_dim, dim, use_bias=False, dtype=dtype)

    def forward(self, x):
        return self.out_layer(F.gelu(self.in_layer(x)))


def _modulated(norm, x, shift, scale):
    return (norm(x) * (scale + 1.0) + shift).to(x.dtype)


def _gated(x, gate, delta):
    return x + (gate * delta.float()).to(x.dtype)


class _K5EncoderBlock(nn.Module):
    def __init__(self, cfg: Kandinsky5Config, *, dtype):
        super().__init__()
        d = cfg.model_dim
        self.text_modulation = _Modulation(cfg.time_dim, d, 6)
        self.self_attention_norm = LayerNorm(d, elementwise_affine=False)
        self.self_attention = _K5Attention(d, cfg.head_dim, dtype=dtype)
        self.feed_forward_norm = LayerNorm(d, elementwise_affine=False)
        self.feed_forward = _K5FF(d, cfg.ff_dim, dtype=dtype)

    def forward(self, x, temb, rope):
        sh, sc, g, sh2, sc2, g2 = self.text_modulation(temb)
        x = _gated(x, g, self.self_attention(_modulated(self.self_attention_norm, x, sh, sc), rope=rope))
        return _gated(x, g2, self.feed_forward(_modulated(self.feed_forward_norm, x, sh2, sc2)))


class _K5DecoderBlock(nn.Module):
    def __init__(self, cfg: Kandinsky5Config, *, dtype):
        super().__init__()
        d = cfg.model_dim
        self.visual_modulation = _Modulation(cfg.time_dim, d, 9)
        self.self_attention_norm = LayerNorm(d, elementwise_affine=False)
        self.self_attention = _K5Attention(d, cfg.head_dim, dtype=dtype)
        self.cross_attention_norm = LayerNorm(d, elementwise_affine=False)
        self.cross_attention = _K5Attention(d, cfg.head_dim, dtype=dtype)
        self.feed_forward_norm = LayerNorm(d, elementwise_affine=False)
        self.feed_forward = _K5FF(d, cfg.ff_dim, dtype=dtype)

    def forward(self, x, text, temb, rope):
        sh, sc, g, sh2, sc2, g2, sh3, sc3, g3 = self.visual_modulation(temb)
        x = _gated(x, g, self.self_attention(_modulated(self.self_attention_norm, x, sh, sc), rope=rope))
        x = _gated(x, g2, self.cross_attention(_modulated(self.cross_attention_norm, x, sh2, sc2), context=text))
        return _gated(x, g3, self.feed_forward(_modulated(self.feed_forward_norm, x, sh3, sc3)))


@transformer_registry.register("kandinsky5.base", aliases=("kandinsky5", "Kandinsky5Transformer3DModel"))
class Kandinsky5Transformer3DModel(nn.Module):
    config_class = Kandinsky5Config

    def __init__(self, cfg: Kandinsky5Config, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.model_dim
        visual_in = 2 * cfg.in_visual_dim + 1 if cfg.visual_cond else cfg.in_visual_dim
        # time: sinusoid(model_dim) → Linear(time) → SiLU → Linear(time)
        self.time_in = Linear(d, cfg.time_dim, dtype=dtype)
        self.time_out = Linear(cfg.time_dim, cfg.time_dim, dtype=dtype)
        self.text_in = Linear(cfg.in_text_dim, d, dtype=dtype)
        self.text_norm = LayerNorm(d)
        self.pooled_in = Linear(cfg.in_text_dim2, cfg.time_dim, dtype=dtype)
        self.pooled_norm = LayerNorm(cfg.time_dim)
        self.visual_in = Linear(int(np.prod(cfg.patch_size)) * visual_in, d, dtype=dtype)
        self.text_transformer_blocks = nn.ModuleList(
            [_K5EncoderBlock(cfg, dtype=dtype) for _ in range(cfg.num_text_blocks)])
        self.visual_transformer_blocks = nn.ModuleList(
            [_K5DecoderBlock(cfg, dtype=dtype) for _ in range(cfg.num_visual_blocks)])
        self.out_modulation = _Modulation(cfg.time_dim, d, 2)
        self.out_norm = LayerNorm(d, elementwise_affine=False)
        self.out_layer = Linear(d, int(np.prod(cfg.patch_size)) * cfg.out_visual_dim, dtype=dtype)

    @property
    def visual_in_channels(self) -> int:
        return self.visual_in.weight.shape[1] // int(np.prod(self.cfg.patch_size))

    def visual_rope(self, t: int, h: int, w: int, scale: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                    device=None):
        """cos / sin [1, t·h·w, 1, D/2]: each axis' coordinate (divided by its
        scale) through its ``axes_dims`` share, f32 as JAX computes it."""
        coords = [torch.arange(n, dtype=torch.float32, device=device) / s for n, s in zip((t, h, w), scale)]
        grids = torch.meshgrid(*coords, indexing="ij")
        parts = [rope_freqs_1d(g.reshape(-1), ad) for g, ad in zip(grids, self.cfg.axes_dims)]
        cos = torch.cat([c for c, _ in parts], dim=-1)[None, :, None, :]
        sin = torch.cat([s for _, s in parts], dim=-1)[None, :, None, :]
        return cos, sin

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, T, H, W] → [B, N, pt·ph·pw·C], channel last."""
        pt, ph, pw = self.cfg.patch_size
        b, c, t, h, w = x.shape
        x = x.permute(0, 2, 3, 4, 1).reshape(b, t // pt, pt, h // ph, ph, w // pw, pw, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
        return x.reshape(b, (t // pt) * (h // ph) * (w // pw), pt * ph * pw * c)

    def unpatchify(self, tok, t, h, w):
        pt, ph, pw = self.cfg.patch_size
        c = self.cfg.out_visual_dim
        b = tok.shape[0]
        x = tok.reshape(b, t // pt, h // ph, w // pw, c, pt, ph, pw).permute(0, 4, 1, 5, 2, 6, 3, 7)
        return x.reshape(b, c, t, h, w)

    def forward(self, x, t, context, pooled, scale_factor=(1.0, 1.0, 1.0)):
        """x [B, C, T, H, W]; t [B] (the flow time × 1000); context
        [B, L, in_text_dim]; pooled [B, in_text_dim2]."""
        cfg = self.cfg
        b, c, tt, hh, ww = x.shape
        pt, ph, pw = cfg.patch_size
        half = cfg.model_dim // 2
        freqs = torch.from_numpy((1.0 / (10000.0 ** (np.arange(half, dtype=np.float64) / half)))
                                 .astype(np.float32)).to(x.device)
        args = t.float()[:, None] * freqs[None]
        sincos = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        temb = self.time_out(F.silu(self.time_in(sincos)))
        temb = temb.float() + self.pooled_norm(self.pooled_in(pooled.to(self.dtype)))
        text = self.text_norm(self.text_in(context.to(self.dtype))).to(self.dtype)

        t_rope = rope_freqs_1d(torch.arange(text.shape[1], dtype=torch.float32, device=x.device), cfg.head_dim)
        t_rope = (t_rope[0][None, :, None, :], t_rope[1][None, :, None, :])
        for blk in self.text_transformer_blocks:
            text = blk(text, temb, t_rope)

        tok = self.visual_in(self.patchify(x).to(self.dtype))
        v_rope = self.visual_rope(tt // pt, hh // ph, ww // pw, scale_factor, device=x.device)
        for blk in self.visual_transformer_blocks:
            tok = blk(tok, text, temb, v_rope)

        sh, sc = self.out_modulation(temb)
        tok = _modulated(self.out_norm, tok, sh, sc).to(self.dtype)
        return self.unpatchify(self.out_layer(tok).float(), tt, hh, ww)
