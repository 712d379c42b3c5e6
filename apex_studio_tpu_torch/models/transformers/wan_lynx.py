"""Wan Lynx DiT (face-ID personalised video) and its identity resampler,
port of ``apex_studio_tpu/models/transformers/wan_lynx.py``.

- ``LynxBlock``: a Wan block whose text cross-attention gains an IP branch:
  the same queries attend to the identity tokens (plus ``ip_registers``
  learned register tokens; 0 for Lynx-lite) through the block's
  ``to_k_ip`` / ``to_v_ip`` and the cross-attention's k-norm, the result
  scaled by ``ip_scale`` and added (one flash launch, Sk = 8 + 16);
- ``LynxResampler``: a perceiver (depth 8, 16 heads of 64, 8 queries, f32)
  distilling ArcFace embeddings into the identity tokens; its attention
  runs on the kernel's f32 entry (bf16 tiles, f32 out) as wav2vec2's does;
  registered, as in JAX, among the text encoders (``LynxResampler`` /
  ``lynx_resampler``).

``proj_out`` features are [C, pt, ph, pw], channel slowest, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import GELUMLP, LayerNorm, Linear
from apex_studio_tpu_torch.models.registry import text_encoder_registry, transformer_registry
from apex_studio_tpu_torch.models.transformers.wan import WanAttention, WanConfig, _patchify
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import precompute_axial_freqs


@dataclasses.dataclass
class WanLynxConfig(WanConfig):
    ip_cross_attention_dim: int = 2048
    ip_registers: int = 16
    num_ip_layers: Optional[int] = None  # default: every block


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int, heads: int):
        super().__init__()
        inner = dim_head * heads
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.to_q = Linear(dim, inner, use_bias=False, dtype=torch.float32)
        self.to_kv = Linear(dim, 2 * inner, use_bias=False, dtype=torch.float32)
        self.to_out = Linear(inner, dim, use_bias=False, dtype=torch.float32)
        self.heads, self.dim_head = heads, dim_head

    def forward(self, x, latents):
        x = self.norm1(x)
        latents = self.norm2(latents)
        b, n, _ = latents.shape
        q = self.to_q(latents).reshape(b, n, self.heads, self.dim_head)
        kv_in = torch.cat([x, latents], dim=1)
        kv = self.to_kv(kv_in).reshape(b, kv_in.shape[1], 2, self.heads, self.dim_head)
        return self.to_out(attention_op(q, kv[:, :, 0], kv[:, :, 1]).reshape(b, n, -1))


@text_encoder_registry.register("LynxResampler", aliases=("lynx_resampler",))
class LynxResampler(nn.Module):
    """Perceiver resampler: face embeddings [B, N, 512] → identity tokens
    [B, num_queries, output_dim], f32."""

    @dataclasses.dataclass
    class Config:
        dim: int = 1024
        depth: int = 8
        dim_head: int = 64
        heads: int = 16
        num_queries: int = 8
        embedding_dim: int = 512
        output_dim: int = 2048
        ff_mult: int = 4

        @classmethod
        def from_dict(cls, cfg: dict) -> "LynxResampler.Config":
            known = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in cfg.items() if k in known})

    config_class = Config

    def __init__(self, cfg: "LynxResampler.Config", *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = torch.float32
        d = cfg.dim
        self.latents = nn.Parameter(torch.empty(1, cfg.num_queries, d, dtype=torch.float32))
        self.proj_in = Linear(cfg.embedding_dim, d, dtype=torch.float32)
        self.proj_out = Linear(d, cfg.output_dim, dtype=torch.float32)
        self.norm_out = LayerNorm(cfg.output_dim, eps=1e-5)
        self.attn_layers = nn.ModuleList([PerceiverAttention(d, cfg.dim_head, cfg.heads) for _ in range(cfg.depth)])
        self.ff_layers = nn.ModuleList([GELUMLP(d, d * cfg.ff_mult, approximate=False, use_bias=False,
                                                dtype=torch.float32) for _ in range(cfg.depth)])

    def forward(self, x):
        x = self.proj_in(x.float())
        lat = self.latents.expand(x.shape[0], -1, -1)
        for attn, ff in zip(self.attn_layers, self.ff_layers):
            lat = attn(x, lat) + lat
            lat = ff(lat) + lat
        return self.norm_out(self.proj_out(lat))


class LynxBlock(nn.Module):
    """A Wan block whose cross-attention carries the IP branch."""

    def __init__(self, cfg: WanLynxConfig, with_ip: bool, *, dtype):
        super().__init__()
        d = cfg.dim
        self.attn1 = WanAttention(cfg, cross=False, dtype=dtype)
        self.attn2 = WanAttention(cfg, cross=True, dtype=dtype)
        if with_ip:
            self.to_k_ip = Linear(cfg.ip_cross_attention_dim, d, dtype=dtype)
            self.to_v_ip = Linear(cfg.ip_cross_attention_dim, d, dtype=dtype)
            self.registers = (nn.Parameter(torch.empty(1, cfg.ip_registers, cfg.ip_cross_attention_dim,
                                                       dtype=torch.float32)) if cfg.ip_registers > 0 else None)
        else:
            self.to_k_ip = self.to_v_ip = self.registers = None
        if cfg.cross_attn_norm:
            self.norm2_weight = nn.Parameter(torch.ones(d, dtype=torch.float32))
            self.norm2_bias = nn.Parameter(torch.zeros(d, dtype=torch.float32))
        else:
            self.norm2_weight = self.norm2_bias = None
        self.ffn = GELUMLP(d, cfg.ffn_dim, approximate=True, dtype=dtype)
        self.scale_shift_table = nn.Parameter(torch.empty(1, 6, d, dtype=torch.float32))
        self.eps, self.heads, self.head_dim = cfg.eps, cfg.num_attention_heads, cfg.attention_head_dim

    def _ip_attn(self, norm_x, ip_tokens, ip_scale):
        b, s, c = norm_x.shape
        if self.registers is not None:
            regs = self.registers.expand(ip_tokens.shape[0], -1, -1).to(ip_tokens.dtype)
            ip_tokens = torch.cat([ip_tokens, regs], dim=1)
        n = ip_tokens.shape[1]
        q = self.attn2.norm_q(self.attn2.to_q(norm_x)).reshape(b, s, self.heads, self.head_dim)
        k = self.attn2.norm_k(self.to_k_ip(ip_tokens)).reshape(b, n, self.heads, self.head_dim)
        v = self.to_v_ip(ip_tokens).reshape(b, n, self.heads, self.head_dim)
        return attention_op(q, k, v).reshape(b, s, c) * ip_scale

    def forward(self, x, context, temb6, rope_cos, rope_sin, ip_tokens=None, ip_scale=1.0):
        mods = (self.scale_shift_table + temb6).to(x.dtype)
        sh, sc, g = mods[:, 0:1], mods[:, 1:2], mods[:, 2:3]
        csh, csc, cg = mods[:, 3:4], mods[:, 4:5], mods[:, 5:6]
        norm_x = layer_norm(x, eps=self.eps) * (1 + sc) + sh
        x = x + self.attn1(norm_x, rope_cos=rope_cos, rope_sin=rope_sin) * g
        norm_x = (layer_norm(x, self.norm2_weight, self.norm2_bias, self.eps)
                  if self.norm2_weight is not None else x)
        cross = self.attn2(norm_x, context=context)
        if self.to_k_ip is not None and ip_tokens is not None:
            cross = cross + self._ip_attn(norm_x, ip_tokens.to(x.dtype), ip_scale)
        x = x + cross
        norm_x = layer_norm(x, eps=self.eps) * (1 + csc) + csh
        return x + self.ffn(norm_x) * cg


@transformer_registry.register("wan.lynx", aliases=("WanLynxTransformer3DModel", "wan_lynx"))
class WanLynxTransformer3DModel(nn.Module):
    config_class = WanLynxConfig

    def __init__(self, cfg: WanLynxConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        patch = int(np.prod(cfg.patch_size))
        self.patch_embedding = Linear(cfg.in_channels * patch, d, dtype=dtype)
        self.time_embedder_linear_1 = Linear(cfg.freq_dim, d, dtype=dtype)
        self.time_embedder_linear_2 = Linear(d, d, dtype=dtype)
        self.time_proj = Linear(d, 6 * d, dtype=dtype)
        self.text_embedder_linear_1 = Linear(cfg.text_dim, d, dtype=dtype)
        self.text_embedder_linear_2 = Linear(d, d, dtype=dtype)
        n_ip = cfg.num_ip_layers if cfg.num_ip_layers is not None else cfg.num_layers
        self.blocks = nn.ModuleList([LynxBlock(cfg, with_ip=i < n_ip, dtype=dtype) for i in range(cfg.num_layers)])
        self.norm_out_scale_shift = nn.Parameter(torch.empty(1, 2, d, dtype=torch.float32))
        self.proj_out = Linear(d, cfg.out_channels * patch, dtype=dtype)
        self._tables = {}

    def rope_tables(self, t_tok, h_tok, w_tok, device=None):
        key = (t_tok, h_tok, w_tok, str(device))
        if key not in self._tables:
            ids = np.stack(np.meshgrid(np.arange(t_tok), np.arange(h_tok), np.arange(w_tok), indexing="ij"),
                           axis=-1).reshape(1, -1, 3)
            cos, sin = precompute_axial_freqs(ids, self.cfg.rope_axes_dims, 10000.0)
            self._tables[key] = tuple(torch.from_numpy(a[:, :, None, :]).to(device) for a in (cos, sin))
        return self._tables[key]

    def forward(self, x, t, context, ip_tokens=None, ip_scale: float = 1.0):
        cfg = self.cfg
        b, _, tt, hh, ww = x.shape
        pt, ph, pw = cfg.patch_size
        n_t, n_h, n_w = tt // pt, hh // ph, ww // pw
        freq = timestep_embedding(t.float(), cfg.freq_dim, flip_sin_to_cos=True)
        temb = self.time_embedder_linear_2(F.silu(self.time_embedder_linear_1(freq.to(self.dtype))))
        temb6 = self.time_proj(F.silu(temb)).reshape(b, 6, cfg.dim).float()
        ctx = self.text_embedder_linear_2(
            F.gelu(self.text_embedder_linear_1(context.to(self.dtype)), approximate="tanh"))
        tokens = self.patch_embedding(_patchify(x, cfg.patch_size).to(self.dtype))
        rope_cos, rope_sin = self.rope_tables(n_t, n_h, n_w, device=tokens.device)
        for blk in self.blocks:
            tokens = blk(tokens, ctx, temb6, rope_cos, rope_sin, ip_tokens=ip_tokens, ip_scale=ip_scale)
        shift, scale = (self.norm_out_scale_shift + temb.float()[:, None, :]).chunk(2, dim=1)
        out = layer_norm(tokens, eps=cfg.eps) * (1 + scale.to(tokens.dtype)) + shift.to(tokens.dtype)
        out = self.proj_out(out).reshape(b, n_t, n_h, n_w, cfg.out_channels, pt, ph, pw)
        return out.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, cfg.out_channels, tt, hh, ww)
