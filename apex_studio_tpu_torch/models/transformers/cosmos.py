"""NVIDIA Cosmos (Predict2) video DiT, port of
``apex_studio_tpu/models/transformers/cosmos.py``.

- patchified latents, plus one padding-mask channel (zeros unless given)
  and, for video2world, a condition-mask channel before it: the patch
  embedding is a bias-free Linear over [C, pt, ph, pw]
- per-frame timesteps ([B, T] flow times in [0, 1]) condition every token of
  their frame
- adaLN-zero blocks (``_AdaLNZero``): a shared 3·dim time embedding plus a
  per-block LoRA-rank head (SiLU → dim → rank → n·dim) over the RMS-normed
  sinusoid, modulating an affine-free LayerNorm in f32
- NTK-scaled 3-axis rotate-half RoPE (t / h / w = D − 4⌊D/6⌋ / 2⌊D/6⌋ /
  2⌊D/6⌋, each axis' θ scaled by ``rope_scale^(d/(d−2))``), tables in float64
  numpy cast to f32
- an optional learnable axial position embedding, normalised per token and
  added at every block
- self-attention and T5 cross-attention with q/k RMSNorm, both unmasked as
  in JAX (the engine zeroes the padded T5 rows); a GELU feed-forward
- output features ordered (ph, pw, pt, C)

Same attribute names and dtype flow as the JAX module; every attention goes
to ``ops.attention`` (the flash kernel on the card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import LayerNorm, Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.ops.attention import attention
from apex_studio_tpu_torch.ops.rope import apply_rope_half


@dataclasses.dataclass
class CosmosConfig:
    in_channels: int = 16
    out_channels: int = 16
    num_attention_heads: int = 32
    attention_head_dim: int = 128
    num_layers: int = 28
    mlp_ratio: float = 4.0
    text_embed_dim: int = 1024
    adaln_lora_dim: int = 256
    max_size: Tuple[int, int, int] = (128, 240, 240)
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    rope_scale: Tuple[float, float, float] = (2.0, 1.0, 1.0)
    concat_padding_mask: bool = True
    extra_pos_embed_type: Optional[str] = "learnable"

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def from_dict(cls, cfg: dict) -> "CosmosConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg.items() if k in known}
        return cls(**kw)


class _CosmosAttention(nn.Module):
    def __init__(self, dim: int, kv_dim: int, heads: int, head_dim: int, *, dtype):
        super().__init__()
        self.to_q = Linear(dim, dim, use_bias=False, dtype=dtype)
        self.to_k = Linear(kv_dim, dim, use_bias=False, dtype=dtype)
        self.to_v = Linear(kv_dim, dim, use_bias=False, dtype=dtype)
        self.to_out = Linear(dim, dim, use_bias=False, dtype=dtype)
        self.norm_q = RMSNorm(head_dim)
        self.norm_k = RMSNorm(head_dim)
        self.heads = heads
        self.head_dim = head_dim

    def forward(self, x, context=None, rope=None):
        b, s, d = x.shape
        kv = x if context is None else context
        q = self.to_q(x).reshape(b, s, self.heads, self.head_dim)
        k = self.to_k(kv).reshape(b, -1, self.heads, self.head_dim)
        v = self.to_v(kv).reshape(b, -1, self.heads, self.head_dim)
        q = self.norm_q(q).to(x.dtype)
        k = self.norm_k(k).to(x.dtype)
        if rope is not None:
            cos, sin = rope
            q = apply_rope_half(q, cos, sin)
            k = apply_rope_half(k, cos, sin)
        out = attention(q, k, v)
        return self.to_out(out.reshape(b, s, d))


class _AdaLNZero(nn.Module):
    """LayerNorm + (SiLU → LoRA rank → n·dim) head added to the shared temb."""

    def __init__(self, dim: int, hidden: int, n: int, *, dtype):
        super().__init__()
        self.linear_1 = Linear(dim, hidden, use_bias=False, dtype=dtype)
        self.linear_2 = Linear(hidden, n * dim, use_bias=False, dtype=dtype)
        self.norm = LayerNorm(dim, elementwise_affine=False)
        self.n = n
        self.dim = dim

    def forward(self, x, embedded_t, temb):
        h = self.linear_2(self.linear_1(F.silu(embedded_t)))
        if temb is not None:
            h = h + temb[..., : self.n * self.dim]
        parts = h.float().chunk(self.n, dim=-1)
        normed = self.norm(x) * (1 + parts[1]) + parts[0]
        if self.n == 2:
            return normed.to(x.dtype), None
        return normed.to(x.dtype), parts[2]


class _CosmosBlock(nn.Module):
    def __init__(self, cfg: CosmosConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.norm1 = _AdaLNZero(d, cfg.adaln_lora_dim, 3, dtype=dtype)
        self.attn1 = _CosmosAttention(d, d, cfg.num_attention_heads, cfg.attention_head_dim, dtype=dtype)
        self.norm2 = _AdaLNZero(d, cfg.adaln_lora_dim, 3, dtype=dtype)
        self.attn2 = _CosmosAttention(d, cfg.text_embed_dim, cfg.num_attention_heads, cfg.attention_head_dim,
                                      dtype=dtype)
        self.norm3 = _AdaLNZero(d, cfg.adaln_lora_dim, 3, dtype=dtype)
        hid = int(d * cfg.mlp_ratio)
        self.ff_in = Linear(d, hid, use_bias=False, dtype=dtype)
        self.ff_out = Linear(hid, d, use_bias=False, dtype=dtype)

    def forward(self, x, ctx, embedded_t, temb, rope, extra_pos):
        if extra_pos is not None:
            x = x + extra_pos.to(x.dtype)
        h, gate = self.norm1(x, embedded_t, temb)
        x = x + (gate * self.attn1(h, rope=rope).float()).to(x.dtype)
        h, gate = self.norm2(x, embedded_t, temb)
        x = x + (gate * self.attn2(h, context=ctx).float()).to(x.dtype)
        h, gate = self.norm3(x, embedded_t, temb)
        ff = self.ff_out(F.gelu(self.ff_in(h)))
        return x + (gate * ff.float()).to(x.dtype)


@transformer_registry.register("cosmos.base", aliases=("cosmos", "cosmos2", "CosmosTransformer3DModel"))
class CosmosTransformer3DModel(nn.Module):
    config_class = CosmosConfig

    def __init__(self, cfg: CosmosConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        in_ch = cfg.in_channels + (1 if cfg.concat_padding_mask else 0)
        self.patch_embed = Linear(in_ch * int(np.prod(cfg.patch_size)), d, use_bias=False, dtype=dtype)
        # time: sinusoid(dim) → Linear → SiLU → Linear(3·dim); the RMS-normed
        # sinusoid is each block's "embedded timestep"
        self.t_linear_1 = Linear(d, d, use_bias=False, dtype=dtype)
        self.t_linear_2 = Linear(d, 3 * d, use_bias=False, dtype=dtype)
        self.t_norm = RMSNorm(d)
        if cfg.extra_pos_embed_type == "learnable":
            g = [s // p for s, p in zip(cfg.max_size, cfg.patch_size)]
            self.pos_emb_t = nn.Parameter(torch.zeros(g[0], d, dtype=torch.float32))
            self.pos_emb_h = nn.Parameter(torch.zeros(g[1], d, dtype=torch.float32))
            self.pos_emb_w = nn.Parameter(torch.zeros(g[2], d, dtype=torch.float32))
        else:
            self.pos_emb_t = None
        self.transformer_blocks = nn.ModuleList([_CosmosBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.norm_out = _AdaLNZero(d, cfg.adaln_lora_dim, 2, dtype=dtype)
        self.proj_out = Linear(d, int(np.prod(cfg.patch_size)) * cfg.out_channels, use_bias=False, dtype=dtype)

    def rope_tables(self, t: int, h: int, w: int, fps: Optional[float] = None, device=None):
        """cos / sin [1, t·h·w, 1, D/2] of the NTK-scaled 3-axis angles."""
        cfg = self.cfg
        hd = cfg.attention_head_dim
        dim_h = hd // 6 * 2
        dim_w = hd // 6 * 2
        dim_t = hd - dim_h - dim_w
        ntk = [s ** (d_ / (d_ - 2)) for s, d_ in zip(cfg.rope_scale, (dim_t, dim_h, dim_w))]
        t_pos = np.arange(t, dtype=np.float64)
        if fps is not None:
            t_pos = t_pos / fps * 24.0
        axes = []
        for pos, d_, nf in ((t_pos, dim_t, ntk[0]), (np.arange(h, dtype=np.float64), dim_h, ntk[1]),
                            (np.arange(w, dtype=np.float64), dim_w, ntk[2])):
            freqs = 1.0 / ((10000.0 * nf) ** (np.arange(0, d_, 2)[: d_ // 2] / d_))
            axes.append(np.outer(pos, freqs))
        et = np.broadcast_to(axes[0][:, None, None, :], (t, h, w, dim_t // 2))
        eh = np.broadcast_to(axes[1][None, :, None, :], (t, h, w, dim_h // 2))
        ew = np.broadcast_to(axes[2][None, None, :, :], (t, h, w, dim_w // 2))
        freqs = np.concatenate([et, eh, ew], axis=-1).reshape(1, -1, 1, hd // 2)
        return (torch.from_numpy(np.cos(freqs).astype(np.float32)).to(device),
                torch.from_numpy(np.sin(freqs).astype(np.float32)).to(device))

    def _extra_pos(self, t: int, h: int, w: int):
        if self.pos_emb_t is None:
            return None
        emb = (self.pos_emb_t[:t, None, None] + self.pos_emb_h[None, :h, None]
               + self.pos_emb_w[None, None, :w]).reshape(1, -1, self.cfg.dim).float()
        norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        norm = 1e-6 + norm * math.sqrt(1.0 / self.cfg.dim)
        return emb / norm

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        pt, ph, pw = self.cfg.patch_size
        b, c, t, h, w = x.shape
        x = x.reshape(b, c, t // pt, pt, h // ph, ph, w // pw, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
        return x.reshape(b, -1, c * pt * ph * pw)

    def unpatchify(self, tok, t, h, w):
        # out features ordered (ph, pw, pt, c)
        pt, ph, pw = self.cfg.patch_size
        c = self.cfg.out_channels
        b = tok.shape[0]
        x = tok.reshape(b, t // pt, h // ph, w // pw, ph, pw, pt, c).permute(0, 7, 1, 6, 2, 4, 3, 5)
        return x.reshape(b, c, t, h, w)

    def forward(self, x, t, context, fps: Optional[float] = None, condition_mask: Optional[torch.Tensor] = None,
                padding_mask: Optional[torch.Tensor] = None):
        """x: (B, C, T, H, W); t: (B,) or (B, T) per-frame flow times in
        [0, 1]; condition_mask: (B, 1, T, H, W) extra channel (video2world)."""
        cfg = self.cfg
        if condition_mask is not None:
            x = torch.cat([x, condition_mask.to(x.dtype)], dim=1)
        if cfg.concat_padding_mask:
            b_, _, t_, h_, w_ = x.shape
            pad = (x.new_zeros(b_, 1, t_, h_, w_) if padding_mask is None
                   else padding_mask.to(x.dtype).expand(b_, 1, t_, h_, w_))
            x = torch.cat([x, pad], dim=1)
        b, c, tt, hh, ww = x.shape
        pt, ph, pw = cfg.patch_size
        gt, gh, gw = tt // pt, hh // ph, ww // pw

        tok = self.patch_embed(self.patchify(x).to(self.dtype))
        rope = self.rope_tables(gt, gh, gw, fps, device=tok.device)
        extra = self._extra_pos(gt, gh, gw)

        per_frame = t.ndim == 2
        half = cfg.dim // 2
        freqs = torch.from_numpy(np.exp(-math.log(10000.0) * np.arange(half, dtype=np.float64) / half)
                                 .astype(np.float32)).to(tok.device)
        args = t.reshape(-1).float()[:, None] * freqs[None]
        sincos = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        temb = self.t_linear_2(F.silu(self.t_linear_1(sincos.to(self.dtype))))
        embedded_t = self.t_norm(sincos).to(self.dtype)
        if per_frame:
            hw = gh * gw
            temb = temb.reshape(b, gt, -1).repeat_interleave(hw, dim=1)
            embedded_t = embedded_t.reshape(b, gt, -1).repeat_interleave(hw, dim=1)
        else:
            temb = temb[:, None]
            embedded_t = embedded_t[:, None]

        ctx = context.to(self.dtype)
        for blk in self.transformer_blocks:
            tok = blk(tok, ctx, embedded_t, temb, rope, extra)
        tok, _ = self.norm_out(tok, embedded_t, temb)
        out = self.proj_out(tok).float()
        return self.unpatchify(out, tt, hh, ww)
