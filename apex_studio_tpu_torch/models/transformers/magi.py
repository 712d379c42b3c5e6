"""MAGI-1 chunk-autoregressive video DiT, port of
``apex_studio_tpu/models/transformers/magi.py`` (4.5B: 34 layers, 24 heads of
128 over 8 KV groups, FFN 12288).

- the sequence is R equal chunks of L tokens, each with its own timestep; the
  adaLN gates broadcast per chunk through a [B, R, L, D] view
- block-causal self-attention over chunks (chunk i attends to chunks ≤ i; the
  clean context chunks are causal among themselves too) as R launches of the
  kernel: chunk i's L queries against the first (i + 1)·L keys, unmasked
  (``block_causal_attention``); no [S, S] mask is built
- parallel self + cross attention on norm1(x): GQA self-attention with
  zero-centred q/k LayerNorms (the converter adds 1.0 to the published
  gammas); per-chunk cross-attention against the caption, whose ``cross_kv``
  rows are per-head ``[k_h | v_h]`` pairs; both outputs TP8-interleaved
  (``(n hn hd) -> (hn n hd)``, n = 2, hn = 8) into one fused projection
- learnable RoPE: one band vector (head_dim / 8) shared by t, h and w, the
  spatial coordinates centred and rescaled to the 16×16 grid, time from
  ``t_chunk_offset``; it rotates the first 6·head_dim/8 dims of a head
- the adaLN condition is a timestep embedding plus one learned caption token,
  ``null_caption_embedding`` row -2 (kept) or -1 (dropped); the caption
  reaches the cross-attention through ``y_proj_xattn``
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import LayerNorm, Linear
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.ops.attention import attention


@dataclasses.dataclass
class MagiConfig:
    num_layers: int = 34
    num_attention_heads: int = 24
    attention_head_dim: int = 128
    ffn_dim: int = 12288
    num_query_groups: int = 8
    in_channels: int = 32
    out_channels: int = 32
    patch_size: int = 2
    t_patch_size: int = 1
    caption_channels: int = 4096
    caption_max_length: int = 800
    cond_hidden_ratio: float = 0.25
    xattn_cond_hidden_ratio: float = 1.0
    cond_gating_ratio: float = 1.0
    gate_num_chunks: int = 2
    frequency_embedding_size: int = 256
    x_rescale_factor: float = 1.0
    half_channel_vae: bool = False
    gated_linear_unit: bool = False
    eps: float = 1e-6

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_query_groups * self.attention_head_dim

    @property
    def cond_dim(self) -> int:
        return int(self.dim * self.cond_hidden_ratio)

    @classmethod
    def from_dict(cls, cfg: dict) -> "MagiConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in known})


def _sinusoidal(t: torch.Tensor, dim: int, rescale: float = 1000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None] * rescale
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def softcap(x: torch.Tensor, cap: float = 1.0) -> torch.Tensor:
    return cap * torch.tanh(x.float() / cap)


def block_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunks: int) -> torch.Tensor:
    """Attention under the block-causal chunk mask (chunk i attends to the
    keys of chunks 0..i) as ``chunks`` unmasked launches of the kernel: chunk
    i's L queries against the first (i + 1)·L keys and values (BSHD views, no
    copy). Each row gets exactly the keys the mask keeps. One chunk is one
    unmasked launch."""
    s = q.shape[1]
    if chunks == 1:
        return attention(q, k, v)
    length = s // chunks
    return torch.cat([attention(q[:, i * length:(i + 1) * length], k[:, :(i + 1) * length],
                                v[:, :(i + 1) * length]) for i in range(chunks)], dim=1)


class ZeroCenteredLN(nn.Module):
    """A LayerNorm whose published gamma is zero-centred; the converter adds
    1.0 on load, so at run time it is a plain affine LayerNorm."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.norm = LayerNorm(dim, eps=eps)

    def forward(self, x):
        return self.norm(x)


class MagiRope(nn.Module):
    """Learnable frequency bands shared by (t, h, w)."""

    def __init__(self, head_dim: int):
        super().__init__()
        nb = head_dim // 8
        self.bands = nn.Parameter(torch.tensor(1.0 / 10000.0 ** (np.arange(nb) / nb), dtype=torch.float32))
        self.head_dim = head_dim

    def tables(self, t_tok: int, h_tok: int, w_tok: int, t_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sin, cos), each (T·H·W, 3·nb) in f32: spatial axes centred (± (n−1)/2)
        and endpoint-rescaled to the 16×16 grid by (n/rf − 1)/(n − 1) with
        rf = √(H·W/256); time positions are plain indices from ``t_offset``."""
        dev = self.bands.device
        rescale = math.sqrt((h_tok * w_tok) / (16.0 * 16.0))

        def centered(n: int) -> torch.Tensor:
            x = torch.arange(n, dtype=torch.float32, device=dev) - (n - 1) / 2.0
            if n > 1:
                x = x * ((n / rescale - 1.0) / (n - 1.0))
            return x

        tpos = torch.arange(t_offset, t_offset + t_tok, dtype=torch.float32, device=dev)
        grids = torch.stack(torch.meshgrid(tpos, centered(h_tok), centered(w_tok), indexing="ij"), dim=-1)
        ang = grids.reshape(-1, 3)[:, :, None] * self.bands.float()[None, None, :]
        ang = ang.reshape(ang.shape[0], -1)
        return torch.sin(ang), torch.cos(ang)


def apply_partial_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate the first 2·rot dims of each head (rot = sin's width: 6·D/8 in
    all), the rest pass through. x: (B, S, H, D)."""
    rot = sin.shape[-1]
    x1, x2 = x[..., :rot], x[..., rot:2 * rot]
    s, c = sin[None, :, None, :], cos[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c, x[..., 2 * rot:]], dim=-1)


class MagiBlock(nn.Module):
    def __init__(self, cfg: MagiConfig, *, dtype):
        super().__init__()
        d, kv, hd = cfg.dim, cfg.kv_dim, cfg.attention_head_dim
        nb = dict(use_bias=False, dtype=dtype)
        self.adaln_proj = Linear(cfg.cond_dim, int(d * cfg.cond_gating_ratio * cfg.gate_num_chunks), dtype=dtype)
        self.norm1 = LayerNorm(d, eps=cfg.eps)
        self.self_q = Linear(d, d, **nb)
        self.self_k = Linear(d, kv, **nb)
        self.self_v = Linear(d, kv, **nb)
        self.self_norm_q = ZeroCenteredLN(hd, eps=cfg.eps)
        self.self_norm_k = ZeroCenteredLN(hd, eps=cfg.eps)
        xdim = int(d * cfg.xattn_cond_hidden_ratio)
        self.cross_q = Linear(d, d, **nb)
        self.cross_kv = Linear(xdim, kv * 2, **nb)
        self.cross_norm_q = ZeroCenteredLN(hd, eps=cfg.eps)
        self.cross_norm_k = ZeroCenteredLN(hd, eps=cfg.eps)
        self.proj = Linear(2 * d, d, **nb)
        self.norm2 = ZeroCenteredLN(d, eps=cfg.eps)
        self.ffn_norm = LayerNorm(d, eps=cfg.eps)
        self.ffn_proj1 = Linear(d, 2 * cfg.ffn_dim if cfg.gated_linear_unit else cfg.ffn_dim, **nb)
        self.ffn_proj2 = Linear(cfg.ffn_dim, d, **nb)
        self.norm3 = ZeroCenteredLN(d, eps=cfg.eps)
        self.cfg = cfg

    def _heads(self, x, n):
        b, s, _ = x.shape
        return x.reshape(b, s, n, self.cfg.attention_head_dim)

    def forward(self, x, y_xattn, y_mask, condition, rope_sin, rope_cos, block_causal: bool):
        """x: (B, R·L, D); y_xattn: (B, R, Ly, xdim); y_mask: (B, R, Ly) bool;
        condition: (B, R, cond_dim); block-causal over the R chunks when
        ``block_causal``."""
        cfg = self.cfg
        b, s, d = x.shape
        r = condition.shape[1]
        l = s // r
        heads, groups = cfg.num_attention_heads, cfg.num_query_groups
        rep = heads // groups
        residual = x
        nx = self.norm1(x).to(x.dtype)

        # self-attention (GQA)
        q = self.self_norm_q(self._heads(self.self_q(nx), heads))
        k = self.self_norm_k(self._heads(self.self_k(nx), groups))
        v = self._heads(self.self_v(nx), groups)
        q = apply_partial_rope(q.float(), rope_sin, rope_cos).to(x.dtype)
        k = apply_partial_rope(k.float(), rope_sin, rope_cos).to(x.dtype)
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        attn = block_causal_attention(q, k, v, r if block_causal else 1).reshape(b, s, d)

        # cross-attention, each chunk against its caption: one launch over B·R rows
        cq = self.cross_norm_q(self._heads(self.cross_q(nx), heads)).reshape(b * r, l, heads, -1)
        kv = self.cross_kv(y_xattn.reshape(b * r, -1, y_xattn.shape[-1]))
        # the projection's rows are per-head [k_h | v_h] pairs, not [all k | all v]
        kv = kv.reshape(*kv.shape[:2], groups, 2, kv.shape[-1] // (2 * groups))
        ck = self.cross_norm_k(kv[..., 0, :]).repeat_interleave(rep, dim=2)
        cv = kv[..., 1, :].repeat_interleave(rep, dim=2)
        xattn = attention(cq, ck.to(cq.dtype), cv.to(cq.dtype), mask=y_mask.reshape(b * r, -1)).reshape(b, s, d)

        # the TP8 interleave before the fused projection: (n hn hd) -> (hn n hd), n = 2, hn = 8
        hn = 8
        cat = torch.stack([attn, xattn], dim=2).reshape(b, s, 2, hn, d // hn).transpose(2, 3).reshape(b, s, 2 * d)
        h = self.proj(cat.to(x.dtype)).float()

        gates = softcap(self.adaln_proj(F.silu(condition.to(x.dtype))), 1.0)
        gate_msa, gate_mlp = gates.chunk(2, dim=-1)  # (B, R, D) each

        def gated_residual(val, res, gate, post_norm):
            val = val.reshape(b, r, l, d) * gate[:, :, None, :]
            return post_norm(val.reshape(b, s, d)) + res.float()

        x = gated_residual(h, residual, gate_msa, self.norm2).to(residual.dtype)
        residual = x
        h = self.ffn_proj1(self.ffn_norm(x).to(x.dtype))
        if cfg.gated_linear_unit:
            a, g = h.chunk(2, dim=-1)
            h = F.silu(a) * g
        else:
            h = F.gelu(h)
        h = self.ffn_proj2(h).float()
        return gated_residual(h, residual, gate_mlp, self.norm3).to(residual.dtype)


@transformer_registry.register("magi.base", aliases=("magi", "MagiTransformer3DModel"))
class MagiTransformer3DModel(nn.Module):
    config_class = MagiConfig

    def __init__(self, cfg: MagiConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        patch_dim = cfg.in_channels * cfg.t_patch_size * cfg.patch_size ** 2
        self.patch_embedding = Linear(patch_dim, d, use_bias=False, dtype=dtype)
        self.t_mlp1 = Linear(cfg.frequency_embedding_size, cfg.cond_dim, dtype=dtype)
        self.t_mlp2 = Linear(cfg.cond_dim, cfg.cond_dim, dtype=dtype)
        self.y_proj_xattn = Linear(cfg.caption_channels, int(d * cfg.xattn_cond_hidden_ratio), dtype=dtype)
        self.y_proj_adaln = Linear(cfg.caption_channels, cfg.cond_dim, dtype=dtype)
        self.null_caption_embedding = nn.Parameter(
            torch.zeros(cfg.caption_max_length, cfg.caption_channels, dtype=torch.float32))
        self.rope = MagiRope(cfg.attention_head_dim)
        self.blocks = nn.ModuleList([MagiBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.norm_out = ZeroCenteredLN(d, eps=cfg.eps)
        self.proj_out = Linear(d, cfg.patch_size ** 2 * cfg.t_patch_size * cfg.out_channels, use_bias=False,
                               dtype=dtype)

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T, H, W) → (B, N, C·pt·p·p): conv-ordered features."""
        pt, p = self.cfg.t_patch_size, self.cfg.patch_size
        b, c, t, h, w = x.shape
        x = x.reshape(b, c, t // pt, pt, h // p, p, w // p, p).permute(0, 2, 4, 6, 1, 3, 5, 7)
        return x.reshape(b, (t // pt) * (h // p) * (w // p), c * pt * p * p)

    def unpatchify(self, tok: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
        """``proj_out`` features are ordered [pt, ph, pw, C]: the channel fastest."""
        pt, p, c = self.cfg.t_patch_size, self.cfg.patch_size, self.cfg.out_channels
        x = tok.reshape(tok.shape[0], t // pt, h // p, w // p, pt, p, p, c).permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(tok.shape[0], c, t, h, w)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor, y: torch.Tensor,
                y_mask: Optional[torch.Tensor] = None, caption_dropout: bool = False, t_chunk_offset: int = 0,
                block_causal: bool = True) -> torch.Tensor:
        """x: (B, C, T, H, W) latents, R chunks along T; timestep: (B, R) in
        [0, 1]; y: (B, R, Ly, caption_channels); y_mask: (B, R, Ly) bool.
        ``caption_dropout`` picks the dropped learned adaLN token."""
        cfg = self.cfg
        b, _, tt, hh, ww = x.shape
        r = timestep.shape[1]
        x = x * cfg.x_rescale_factor
        if cfg.half_channel_vae:
            x = torch.cat([x, x], dim=1)
        tok = self.patch_embedding(self.patchify(x).to(self.dtype))
        t_tok, h_tok, w_tok = tt // cfg.t_patch_size, hh // cfg.patch_size, ww // cfg.patch_size
        sin, cos = self.rope.tables(t_tok, h_tok, w_tok, t_offset=t_chunk_offset * (t_tok // r))

        t_freq = _sinusoidal(timestep.reshape(-1), cfg.frequency_embedding_size)
        temb = self.t_mlp2(F.silu(self.t_mlp1(t_freq.to(self.dtype)))).reshape(b, r, -1)
        # the adaLN condition reads one of two learned caption tokens: row -2
        # (kept) or -1 (dropped); the cross-attention reads the caption passed in
        token = self.null_caption_embedding[-1 if caption_dropout else -2]
        y_adaln = self.y_proj_adaln(token.expand(b, cfg.caption_channels).to(self.dtype))
        # the caption in one layout however the caller built it (an expanded
        # view takes another GEMM path and rounds differently on the card)
        y_xattn = F.silu(self.y_proj_xattn(y.to(self.dtype).contiguous()))
        condition = temb + y_adaln[:, None, :]
        if y_mask is None:
            y_mask = torch.ones(y.shape[:3], dtype=torch.bool, device=y.device)

        for blk in self.blocks:
            tok = blk(tok, y_xattn, y_mask, condition, sin, cos, block_causal and r > 1)

        out = self.proj_out(self.norm_out(tok.float()).to(self.dtype))
        out = self.unpatchify(out.float(), tt, hh, ww)
        if cfg.half_channel_vae:
            out = out[:, : cfg.out_channels // 2]
        return out / cfg.x_rescale_factor
