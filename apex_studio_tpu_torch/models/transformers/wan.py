"""Wan 2.1 / 2.2 video DiT, port of ``apex_studio_tpu/models/transformers/wan.py``
(the base ``WanTransformer3DModel``; the causal, VACE, Fun, Recam and Holocine
variants are not ported).

- blocks: an f32 layer norm without affine, modulated by a learned
  ``scale_shift_table`` plus the per-sample time projection [B, 6, dim];
  self-attention with 3-D RoPE (t/h/w = d−4⌊d/6⌋ / 2⌊d/6⌋ / 2⌊d/6⌋ rotary
  dims, θ = 10000); cross-attention over the UMT5 features after the affine
  ``norm2`` (plus CLIP image features through ``add_k/v_proj`` when
  ``added_kv_proj_dim`` is set); a tanh-GELU FFN
- the q/k RMS norm runs **across heads**, over the whole inner dim
- both attentions are unmasked flash-kernel launches: 40 heads, self at
  Sq = Sk = S, cross at Sq = S over the 512 text keys (zeroed padding, no bias)
- ``patch_embedding`` is the stride = patch Conv3d as a Linear over flattened
  [C, pt, ph, pw] patches; ``proj_out`` features are [pt, ph, pw, C], channel
  fastest, as published checkpoints lay them out
- RoPE tables are built from integer (t, h, w) ids in float64 numpy, cast to
  f32, and kept per grid
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import GELUMLP, Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import apply_rope, precompute_axial_freqs


@dataclasses.dataclass
class WanConfig:
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_attention_heads: int = 40
    attention_head_dim: int = 128
    in_channels: int = 16
    out_channels: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    ffn_dim: int = 13824
    num_layers: int = 40
    cross_attn_norm: bool = True
    eps: float = 1e-6
    inject_sample_info: bool = False        # SkyReels' fps embedding: not ported
    image_dim: Optional[int] = None         # 1280 for Wan 2.1 i2v (CLIP features)
    added_kv_proj_dim: Optional[int] = None  # set for the i2v cross-attn image K/V
    rope_max_seq_len: int = 1024
    pos_embed_seq_len: Optional[int] = None

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def rope_axes_dims(self) -> Tuple[int, int, int]:
        d = self.attention_head_dim
        h = w = 2 * (d // 6)
        return (d - 2 * h, h, w)

    @classmethod
    def from_dict(cls, cfg: dict) -> "WanConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "patch_size" in kw:
            kw["patch_size"] = tuple(kw["patch_size"])
        return cls(**kw)


class WanAttention(nn.Module):
    """Self- or cross-attention with across-heads RMS qk-norm."""

    def __init__(self, cfg: WanConfig, cross: bool, *, dtype):
        super().__init__()
        d = cfg.dim
        self.to_q = Linear(d, d, dtype=dtype)
        self.to_k = Linear(d, d, dtype=dtype)
        self.to_v = Linear(d, d, dtype=dtype)
        self.to_out = Linear(d, d, dtype=dtype)
        self.norm_q = RMSNorm(d, eps=cfg.eps)
        self.norm_k = RMSNorm(d, eps=cfg.eps)
        if cross and cfg.added_kv_proj_dim is not None:
            self.add_k_proj = Linear(cfg.added_kv_proj_dim, d, dtype=dtype)
            self.add_v_proj = Linear(cfg.added_kv_proj_dim, d, dtype=dtype)
            self.norm_added_k = RMSNorm(d, eps=cfg.eps)
        else:
            self.add_k_proj = self.add_v_proj = self.norm_added_k = None
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        return x.reshape(b, s, self.heads, self.head_dim)

    def forward(self, x, context=None, rope_cos=None, rope_sin=None, context_image=None):
        ctx = x if context is None else context
        q = self._heads(self.norm_q(self.to_q(x)))
        k = self._heads(self.norm_k(self.to_k(ctx)))
        v = self._heads(self.to_v(ctx))
        if rope_cos is not None:
            q = apply_rope(q, rope_cos, rope_sin)
            k = apply_rope(k, rope_cos, rope_sin)
        out = attention_op(q, k, v)
        if context_image is not None and self.add_k_proj is not None:
            k_img = self._heads(self.norm_added_k(self.add_k_proj(context_image)))
            v_img = self._heads(self.add_v_proj(context_image))
            out = out + attention_op(q, k_img, v_img)
        b, s = q.shape[:2]
        return self.to_out(out.reshape(b, s, -1))


class WanTransformerBlock(nn.Module):
    def __init__(self, cfg: WanConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.attn1 = WanAttention(cfg, cross=False, dtype=dtype)
        self.attn2 = WanAttention(cfg, cross=True, dtype=dtype)
        if cfg.cross_attn_norm:
            self.norm2_weight = nn.Parameter(torch.ones(d, dtype=torch.float32))
            self.norm2_bias = nn.Parameter(torch.zeros(d, dtype=torch.float32))
        else:
            self.norm2_weight = self.norm2_bias = None
        self.ffn = GELUMLP(d, cfg.ffn_dim, approximate=True, dtype=dtype)
        self.scale_shift_table = nn.Parameter(torch.empty(1, 6, d, dtype=torch.float32))
        self.eps = cfg.eps

    def forward(self, x, context, temb6, rope_cos, rope_sin, context_image=None):
        # temb6 [B, 6, dim] f32; the sum with the table is cast to the activations' dtype
        mods = (self.scale_shift_table + temb6).to(x.dtype)
        shift_msa, scale_msa, gate_msa = mods[:, 0:1], mods[:, 1:2], mods[:, 2:3]
        c_shift, c_scale, c_gate = mods[:, 3:4], mods[:, 4:5], mods[:, 5:6]

        norm_x = layer_norm(x, eps=self.eps) * (1 + scale_msa) + shift_msa
        x = x + self.attn1(norm_x, rope_cos=rope_cos, rope_sin=rope_sin) * gate_msa

        norm_x = (layer_norm(x, self.norm2_weight, self.norm2_bias, self.eps)
                  if self.norm2_weight is not None else x)
        x = x + self.attn2(norm_x, context=context, context_image=context_image)

        norm_x = layer_norm(x, eps=self.eps) * (1 + c_scale) + c_shift
        return x + self.ffn(norm_x) * c_gate


@transformer_registry.register("wan.base", aliases=("wan",))
class WanTransformer3DModel(nn.Module):
    config_class = WanConfig

    def __init__(self, cfg: WanConfig, *, dtype=torch.bfloat16):
        super().__init__()
        if cfg.inject_sample_info:
            raise NotImplementedError("the SkyReels fps embedding (inject_sample_info) is not ported")
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        patch_dim = cfg.in_channels * int(np.prod(cfg.patch_size))
        self.patch_embedding = Linear(patch_dim, d, dtype=dtype)
        self.time_embedder_linear_1 = Linear(cfg.freq_dim, d, dtype=dtype)
        self.time_embedder_linear_2 = Linear(d, d, dtype=dtype)
        self.time_proj = Linear(d, 6 * d, dtype=dtype)
        self.text_embedder_linear_1 = Linear(cfg.text_dim, d, dtype=dtype)
        self.text_embedder_linear_2 = Linear(d, d, dtype=dtype)
        if cfg.image_dim is not None:
            self.img_norm1 = nn.Parameter(torch.ones(cfg.image_dim, dtype=torch.float32))
            self.img_norm1_bias = nn.Parameter(torch.zeros(cfg.image_dim, dtype=torch.float32))
            self.img_ff1 = Linear(cfg.image_dim, cfg.image_dim, dtype=dtype)
            self.img_ff2 = Linear(cfg.image_dim, d, dtype=dtype)
            self.img_norm2 = nn.Parameter(torch.ones(d, dtype=torch.float32))
            self.img_norm2_bias = nn.Parameter(torch.zeros(d, dtype=torch.float32))
        else:
            self.img_ff1 = None
        self.blocks = nn.ModuleList([WanTransformerBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.proj_out = Linear(d, cfg.out_channels * int(np.prod(cfg.patch_size)), dtype=dtype)
        self.scale_shift_table = nn.Parameter(torch.empty(1, 2, d, dtype=torch.float32))
        self._tables: Dict[tuple, tuple] = {}

    # -- geometry --------------------------------------------------------------------

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, T, H, W] → [B, N, C·pt·ph·pw], token order (t, h, w), features
        [C, pt, ph, pw] as Conv3d(kernel = stride = patch) reads them."""
        pt, ph, pw = self.cfg.patch_size
        b, c, t, h, w = x.shape
        x = x.reshape(b, c, t // pt, pt, h // ph, ph, w // pw, pw)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
        return x.reshape(b, (t // pt) * (h // ph) * (w // pw), c * pt * ph * pw)

    def unpatchify(self, tokens: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
        """``proj_out`` features [pt, ph, pw, C], channel fastest, → [B, C, T, H, W]."""
        pt, ph, pw = self.cfg.patch_size
        c = self.cfg.out_channels
        b = tokens.shape[0]
        x = tokens.reshape(b, t // pt, h // ph, w // pw, pt, ph, pw, c)
        x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(b, c, t, h, w)

    def rope_tables(self, t_tok: int, h_tok: int, w_tok: int, device=None):
        """(cos, sin), each [1, N, 1, head_dim/2] f32, for a t × h × w token grid."""
        key = (t_tok, h_tok, w_tok, str(device))
        if key not in self._tables:
            ids = np.stack(
                np.meshgrid(np.arange(t_tok), np.arange(h_tok), np.arange(w_tok), indexing="ij"),
                axis=-1,
            ).reshape(1, -1, 3)
            cos, sin = precompute_axial_freqs(ids, self.cfg.rope_axes_dims, theta=10000.0)
            self._tables[key] = tuple(torch.from_numpy(a[:, :, None, :]).to(device) for a in (cos, sin))
        return self._tables[key]

    # -- forward ---------------------------------------------------------------------

    def _prepare_cond(self, x, t, context, context_image):
        """(tokens, temb, temb6, ctx, ctx_img, rope_cos, rope_sin)."""
        cfg = self.cfg
        _, _, tt, hh, ww = x.shape
        pt, ph, pw = cfg.patch_size
        if t.ndim != 1:
            raise NotImplementedError("per-frame timesteps (diffusion forcing) are not ported")
        t_freq = timestep_embedding(t.float(), cfg.freq_dim, flip_sin_to_cos=True)
        temb = self.time_embedder_linear_2(F.silu(self.time_embedder_linear_1(t_freq.to(self.dtype))))
        temb6 = self.time_proj(F.silu(temb)).float().reshape(-1, 6, cfg.dim)

        ctx = self.text_embedder_linear_2(
            F.gelu(self.text_embedder_linear_1(context.to(self.dtype)), approximate="tanh"))
        ctx_img = None
        if context_image is not None and self.img_ff1 is not None:
            y = layer_norm(context_image.to(self.dtype), self.img_norm1, self.img_norm1_bias)
            y = self.img_ff2(F.gelu(self.img_ff1(y)))
            ctx_img = layer_norm(y, self.img_norm2, self.img_norm2_bias)

        tokens = self.patch_embedding(self.patchify(x).to(self.dtype))
        rope_cos, rope_sin = self.rope_tables(tt // pt, hh // ph, ww // pw, device=tokens.device)
        return tokens, temb, temb6, ctx, ctx_img, rope_cos, rope_sin

    def _finalize(self, tokens, temb, tt, hh, ww):
        # the final modulated norm; the table's order is (shift, scale)
        table = self.scale_shift_table + temb.float()[:, None, :]
        shift, scale = table[:, 0:1].to(tokens.dtype), table[:, 1:2].to(tokens.dtype)
        tokens = layer_norm(tokens, eps=self.cfg.eps) * (1 + scale) + shift
        return self.unpatchify(self.proj_out(tokens), tt, hh, ww)

    def forward(
        self,
        x: torch.Tensor,                # [B, C, T, H, W] latents
        t: torch.Tensor,                # [B] timesteps (0..1000)
        context: torch.Tensor,          # [B, L, text_dim] UMT5 features
        context_image: Optional[torch.Tensor] = None,  # [B, Li, image_dim] CLIP
    ) -> torch.Tensor:
        _, _, tt, hh, ww = x.shape
        tokens, temb, temb6, ctx, ctx_img, rope_cos, rope_sin = self._prepare_cond(x, t, context, context_image)
        for blk in self.blocks:
            tokens = blk(tokens, ctx, temb6, rope_cos, rope_sin, context_image=ctx_img)
        return self._finalize(tokens, temb, tt, hh, ww)
