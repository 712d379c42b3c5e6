"""LTX-Video DiT, port of ``apex_studio_tpu/models/transformers/ltx.py``
(28 layers, 32 heads of 64, T5 4096 by default).

- token-sequence latents [B, S, C] (patch 1: the compression lives in the
  VAE), ``patchify_proj`` into the inner width
- PixArt AdaLN-single: sinusoidal 256 → MLP → inner, then silu + Linear →
  6·inner; PER-TOKEN timesteps [B, S] give a [B, S, 6, inner] table, which
  holds conditioning tokens at their own noise level
- each block's ``scale_shift_table`` [6, inner] is added to it: (shift,
  scale, gate) for the self-attention and the FFN
- block: RMSNorm (no affine) → scale / shift → self-attention (biases, qk
  RMSNorm over the FULL inner width before the head split, RoPE) → gate;
  cross-attention on the raw residual stream, the context mask a −10000 key
  bias; RMSNorm → scale / shift → GELU-tanh FFN → gate
- RoPE over fractional coordinates (t / max_t, y / max_y, x / max_x):
  dim // 6 exponentially spaced frequencies an axis, interleaved across the
  axes, each repeated twice, the leading dim % 6 entries cos 1 / sin 0; in f32
- STG: ``skip_blocks`` replace those blocks' self-attention output by the
  attention input or its value projection
- final: LayerNorm (no affine) with the [2, inner] table's (shift, scale) →
  ``proj_out``
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import GELUMLP, LayerNorm, Linear, RMSNorm, TimestepEmbedder
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.ops.attention import attention


@dataclass
class LTXVideoConfig:
    in_channels: int = 128
    out_channels: int = 128
    num_layers: int = 28
    num_attention_heads: int = 32
    attention_head_dim: int = 64
    caption_channels: int = 4096
    cross_attention_dim: int = 2048
    norm_eps: float = 1e-6
    qk_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # positional_embedding_max_pos (frames, height, width)
    max_pos: Tuple[int, int, int] = (20, 2048, 2048)
    timestep_scale: float = 1000.0
    causal_temporal_positioning: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LTXVideoConfig":
        known = {
            "in_channels": d.get("in_channels", 128),
            "out_channels": d.get("out_channels") or d.get("in_channels", 128),
            "num_layers": d.get("num_layers", 28),
            "num_attention_heads": d.get("num_attention_heads", 32),
            "attention_head_dim": d.get("attention_head_dim", 64),
            "caption_channels": d.get("caption_channels", 4096),
            "cross_attention_dim": d.get("cross_attention_dim", 2048),
            "norm_eps": d.get("norm_eps", 1e-6),
            "rope_theta": d.get("positional_embedding_theta", 10000.0),
            "max_pos": tuple(d.get("positional_embedding_max_pos", (20, 2048, 2048))),
            "timestep_scale": d.get("timestep_scale_multiplier") or 1000.0,
            "causal_temporal_positioning": d.get("causal_temporal_positioning", False),
        }
        extra = {k: v for k, v in d.items() if k not in known}
        return cls(**known, extra=extra)


def ltx_rope_freqs(coords: torch.Tensor, dim: int, theta: float,
                   max_pos: Tuple[int, int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """coords [B, 3, S] → (cos, sin) each [B, S, dim], in f32."""
    n = dim // 6
    frac = torch.stack([coords[:, i].float() / max_pos[i] for i in range(3)], dim=-1)  # [B, S, 3]
    # theta ** linspace(0, 1, n) ∈ [1, theta], times π/2
    indices = torch.pow(torch.tensor(theta, dtype=torch.float32, device=coords.device),
                        torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=coords.device)) * (math.pi / 2)
    freqs = indices * (frac[..., None] * 2.0 - 1.0)  # [B, S, 3, n]
    freqs = freqs.transpose(-1, -2).reshape(*freqs.shape[:2], 3 * n)
    cos = torch.cos(freqs).repeat_interleave(2, dim=-1)
    sin = torch.sin(freqs).repeat_interleave(2, dim=-1)
    pad = dim % 6
    if pad:
        cos = torch.cat([torch.ones_like(cos[..., :pad]), cos], dim=-1)
        sin = torch.cat([torch.zeros_like(sin[..., :pad]), sin], dim=-1)
    return cos, sin


def apply_ltx_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved rotation over the full inner width (before the head split)."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)
    return x * cos.to(x.dtype) + rot * sin.to(x.dtype)


class LTXAttention(nn.Module):
    """Self- or cross-attention with full-width qk RMSNorm and optional RoPE."""

    def __init__(self, dim: int, heads: int, *, qk_eps: float, dtype):
        super().__init__()
        self.to_q = Linear(dim, dim, dtype=dtype)
        self.to_k = Linear(dim, dim, dtype=dtype)
        self.to_v = Linear(dim, dim, dtype=dtype)
        self.to_out = Linear(dim, dim, dtype=dtype)
        self.q_norm = RMSNorm(dim, eps=qk_eps)
        self.k_norm = RMSNorm(dim, eps=qk_eps)
        self.heads = heads

    def forward(self, x, context=None, rope=None, mask_bias=None, skip_mode: Optional[str] = None):
        b, s, d = x.shape
        q = self.q_norm(self.to_q(x)).to(x.dtype)
        kv_in = x if context is None else context
        k = self.k_norm(self.to_k(kv_in)).to(x.dtype)
        v = self.to_v(kv_in)
        if rope is not None and context is None:
            cos, sin = rope
            q = apply_ltx_rope(q, cos, sin)
            k = apply_ltx_rope(k, cos, sin)
        # STG's perturbed stream: the attention output replaced by the
        # attention INPUT ("attention_skip") or the value projection ("attention_values")
        if skip_mode == "attention_skip":
            return self.to_out(x)
        if skip_mode == "attention_values":
            return self.to_out(v)
        hd = d // self.heads
        out = attention(q.reshape(b, s, self.heads, hd), k.reshape(b, -1, self.heads, hd),
                        v.reshape(b, -1, self.heads, hd), bias=mask_bias)
        return self.to_out(out.reshape(b, s, d))


class LTXBlock(nn.Module):
    def __init__(self, cfg: LTXVideoConfig, *, dtype):
        super().__init__()
        dim = cfg.inner_dim
        self.norm1 = RMSNorm(dim, eps=cfg.norm_eps, elementwise_affine=False)
        self.attn1 = LTXAttention(dim, cfg.num_attention_heads, qk_eps=cfg.qk_norm_eps, dtype=dtype)
        self.attn2 = LTXAttention(dim, cfg.num_attention_heads, qk_eps=cfg.qk_norm_eps, dtype=dtype)
        self.norm2 = RMSNorm(dim, eps=cfg.norm_eps, elementwise_affine=False)
        self.ff = GELUMLP(dim, 4 * dim, use_bias=True, approximate=True, dtype=dtype)
        self.scale_shift_table = nn.Parameter(torch.empty(6, dim, dtype=torch.float32))

    def forward(self, x, temb, context, rope, ctx_bias, skip_mode: Optional[str] = None):
        # temb [B, Tt, 6, dim] with Tt ∈ {1, S}
        ada = self.scale_shift_table[None, None] + temb
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (ada[:, :, i].to(x.dtype) for i in range(6))
        h = self.norm1(x).to(x.dtype) * (1 + scale_msa) + shift_msa
        x = x + gate_msa * self.attn1(h, rope=rope, skip_mode=skip_mode)
        # the cross-attention runs on the un-normed residual stream
        x = x + self.attn2(x, context=context, mask_bias=ctx_bias)
        h = self.norm2(x).to(x.dtype) * (1 + scale_mlp) + shift_mlp
        return x + gate_mlp * self.ff(h)


@transformer_registry.register("ltx.base", aliases=("ltx", "LTXVideoTransformer3DModel"))
class LTXVideoTransformer3D(nn.Module):
    config_class = LTXVideoConfig

    def __init__(self, cfg: LTXVideoConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        dim = cfg.inner_dim
        self.patchify_proj = Linear(cfg.in_channels, dim, dtype=dtype)
        # AdaLayerNormSingle: the PixArt timestep embedder + Linear → 6·dim
        self.time_embed = TimestepEmbedder(dim, freq_size=256, dtype=dtype)
        self.time_proj = Linear(dim, 6 * dim, dtype=dtype)
        # PixArtAlphaTextProjection: Linear → GELU(tanh) → Linear
        self.caption_in = Linear(cfg.caption_channels, dim, dtype=dtype)
        self.caption_out = Linear(dim, dim, dtype=dtype)
        self.blocks = nn.ModuleList([LTXBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.norm_out = LayerNorm(dim, eps=1e-6, elementwise_affine=False)
        self.proj_out = Linear(dim, cfg.out_channels, dtype=dtype)
        self.scale_shift_table = nn.Parameter(torch.empty(2, dim, dtype=torch.float32))

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor, timestep: torch.Tensor,
                encoder_attention_mask: Optional[torch.Tensor] = None, video_coords: Optional[torch.Tensor] = None,
                skip_blocks: Tuple[int, ...] = (), skip_strategy: str = "attention_values") -> torch.Tensor:
        """hidden_states [B, S, C], the text [B, Sc, caption_channels], timestep
        [B, 1] or [B, S] in [0, 1], its mask [B, Sc], video_coords [B, 3, S]
        → [B, S, out_channels]."""
        cfg = self.cfg
        b = hidden_states.shape[0]
        rope = ltx_rope_freqs(video_coords, cfg.inner_dim, cfg.rope_theta, cfg.max_pos)
        ctx_bias = None
        if encoder_attention_mask is not None:
            ctx_bias = ((1.0 - encoder_attention_mask.float()) * -10000.0)[:, None, None, :]
        x = self.patchify_proj(hidden_states.to(self.dtype))
        t = timestep.float() * cfg.timestep_scale  # [B, Tt]
        emb = self.time_embed(t.reshape(-1)).reshape(b, t.shape[1], -1)
        temb = self.time_proj(F.silu(emb)).float().reshape(b, t.shape[1], 6, cfg.inner_dim)
        context = self.caption_out(F.gelu(self.caption_in(encoder_hidden_states.to(self.dtype)), approximate="tanh"))
        skip_set = frozenset(skip_blocks)
        for i, block in enumerate(self.blocks):
            x = block(x, temb, context, rope, ctx_bias, skip_mode=skip_strategy if i in skip_set else None)
        # the final table's order: [shift, scale]
        vals = self.scale_shift_table[None, None] + emb.float()[:, :, None]
        shift, scale = vals[:, :, 0].to(x.dtype), vals[:, :, 1].to(x.dtype)
        return self.proj_out(self.norm_out(x).to(x.dtype) * (1 + scale) + shift)
