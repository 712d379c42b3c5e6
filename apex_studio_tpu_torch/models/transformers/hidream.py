"""HiDream-I1 image MMDiT with MoE feed-forwards, port of
``apex_studio_tpu/models/transformers/hidream.py``.

A Flux-style double + single-stream DiT (16 + 32 blocks at dim 2560, 20
heads of 128) whose image-stream FFN is a DeepSeek-style MoE: softmax top-k
routing over routed SwiGLU experts, the gate weights NOT renormalized, plus a
half-width shared expert. As in the JAX module every routed expert runs over
every token and its output is weighted by the routing mask (each expert a
plain Linear product, no kernel). Conditioning: pooled CLIP-L + CLIP-G into
the time embedding, T5 tokens, and one Llama hidden state per block appended
to the text stream block by block. The sequence is ``[img, txt]``; RoPE over
``(0, row, col)`` image ids with zeroed text ids; every attention goes to
``ops.attention`` (the flash kernel on the card), unmasked.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import LayerNorm, Linear, RMSNorm, SwiGLU
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.ops.attention import attention
from apex_studio_tpu_torch.ops.rope import apply_rope, precompute_axial_freqs


@dataclasses.dataclass
class HiDreamConfig:
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 16
    num_single_layers: int = 32
    attention_head_dim: int = 128
    num_attention_heads: int = 20
    text_emb_dim: int = 2048          # pooled CLIP-L + CLIP-G
    caption_dim: int = 4096           # T5 and Llama feature width
    num_routed_experts: int = 4
    num_activated_experts: int = 2
    axes_dims_rope: Tuple[int, ...] = (64, 32, 32)
    llama_layers: Tuple[int, ...] = ()
    rope_theta: float = 10000.0

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def from_dict(cls, cfg: dict) -> "HiDreamConfig":
        cfg = dict(cfg)
        if isinstance(cfg.get("caption_channels"), list):
            cfg["caption_dim"] = cfg["caption_channels"][0]
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg.items() if k in known})


def _swiglu(dim: int, hidden: int, *, dtype, multiple_of: int = 256) -> SwiGLU:
    """LLaMA-style SwiGLU: the nominal hidden width shrunk to 2/3 and rounded
    up to a multiple of 256, as the published checkpoints are laid out."""
    hidden = int(2 * hidden / 3)
    return SwiGLU(dim, multiple_of * ((hidden + multiple_of - 1) // multiple_of), dtype=dtype)


class _MoESwiGLU(nn.Module):
    """Shared half-width expert + top-k routed experts; the gate weights are
    the raw softmax scores (no renormalization), routed in f32."""

    def __init__(self, dim: int, hidden: int, n_routed: int, n_active: int, *, dtype):
        super().__init__()
        self.shared_experts = _swiglu(dim, hidden // 2, dtype=dtype)
        self.experts = nn.ModuleList([_swiglu(dim, hidden, dtype=dtype) for _ in range(n_routed)])
        self.gate_weight = nn.Parameter(torch.empty(n_routed, dim, dtype=torch.float32))
        self.top_k = n_active
        self.n_routed = n_routed

    def routing(self, x: torch.Tensor) -> torch.Tensor:
        """[..., n_routed] f32 weights: each token's top-k softmax scores in
        their experts' columns, zero elsewhere."""
        scores = torch.softmax(x.float() @ self.gate_weight.float().t(), dim=-1)
        topw, topi = torch.topk(scores, self.top_k, dim=-1)
        return torch.zeros_like(scores).scatter(-1, topi, topw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_full = self.routing(x)
        out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for e, expert in enumerate(self.experts):
            out = out + (w_full[..., e:e + 1].to(x.dtype) * expert(x)).float()
        out = out + self.shared_experts(x).float()
        return out.to(x.dtype)


class _HiDreamAttention(nn.Module):
    def __init__(self, cfg: HiDreamConfig, single: bool, *, dtype):
        super().__init__()
        d = cfg.dim
        self.to_q = Linear(d, d, dtype=dtype)
        self.to_k = Linear(d, d, dtype=dtype)
        self.to_v = Linear(d, d, dtype=dtype)
        self.to_out = Linear(d, d, dtype=dtype)
        self.q_rms_norm = RMSNorm(d)
        self.k_rms_norm = RMSNorm(d)
        if not single:
            self.to_q_t = Linear(d, d, dtype=dtype)
            self.to_k_t = Linear(d, d, dtype=dtype)
            self.to_v_t = Linear(d, d, dtype=dtype)
            self.to_out_t = Linear(d, d, dtype=dtype)
            self.q_rms_norm_t = RMSNorm(d)
            self.k_rms_norm_t = RMSNorm(d)
        self.single = single
        self.heads = cfg.num_attention_heads
        self.hd = cfg.attention_head_dim

    def _split(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.heads, self.hd)

    def forward(self, img, txt=None, rope=None):
        b = img.shape[0]
        q = self._split(self.q_rms_norm(self.to_q(img)).to(img.dtype))
        k = self._split(self.k_rms_norm(self.to_k(img)).to(img.dtype))
        v = self._split(self.to_v(img))
        if not self.single:
            q = torch.cat([q, self._split(self.q_rms_norm_t(self.to_q_t(txt)).to(img.dtype))], dim=1)
            k = torch.cat([k, self._split(self.k_rms_norm_t(self.to_k_t(txt)).to(img.dtype))], dim=1)
            v = torch.cat([v, self._split(self.to_v_t(txt))], dim=1)
        cos, sin = rope
        out = attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)
        out = out.reshape(b, out.shape[1], -1)
        if self.single:
            return self.to_out(out)
        n_img = img.shape[1]
        return self.to_out(out[:, :n_img]), self.to_out_t(out[:, n_img:])


def _ff(cfg: HiDreamConfig, *, dtype):
    d = cfg.dim
    if cfg.num_routed_experts > 0:
        return _MoESwiGLU(d, 4 * d, cfg.num_routed_experts, cfg.num_activated_experts, dtype=dtype)
    return _swiglu(d, 4 * d, dtype=dtype)


class _DoubleBlock(nn.Module):
    def __init__(self, cfg: HiDreamConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.adaln = Linear(d, 12 * d, dtype=dtype)
        self.norm1_i = LayerNorm(d, elementwise_affine=False)
        self.norm1_t = LayerNorm(d, elementwise_affine=False)
        self.attn1 = _HiDreamAttention(cfg, single=False, dtype=dtype)
        self.norm3_i = LayerNorm(d, elementwise_affine=False)
        self.ff_i = _ff(cfg, dtype=dtype)
        self.norm3_t = LayerNorm(d, elementwise_affine=False)
        self.ff_t = _swiglu(d, 4 * d, dtype=dtype)

    def forward(self, img, txt, temb, rope):
        (sh_i, sc_i, g_i, sh_mi, sc_mi, g_mi,
         sh_t, sc_t, g_t, sh_mt, sc_mt, g_mt) = self.adaln(F.silu(temb))[:, None].chunk(12, dim=-1)
        ai, at = self.attn1(self.norm1_i(img).to(img.dtype) * (1 + sc_i) + sh_i,
                            self.norm1_t(txt).to(img.dtype) * (1 + sc_t) + sh_t, rope)
        img = img + g_i * ai
        txt = txt + g_t * at
        img = img + g_mi * self.ff_i(self.norm3_i(img).to(img.dtype) * (1 + sc_mi) + sh_mi)
        txt = txt + g_mt * self.ff_t(self.norm3_t(txt).to(img.dtype) * (1 + sc_mt) + sh_mt)
        return img, txt


class _SingleBlock(nn.Module):
    def __init__(self, cfg: HiDreamConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.adaln = Linear(d, 6 * d, dtype=dtype)
        self.norm1_i = LayerNorm(d, elementwise_affine=False)
        self.attn1 = _HiDreamAttention(cfg, single=True, dtype=dtype)
        self.norm3_i = LayerNorm(d, elementwise_affine=False)
        self.ff_i = _ff(cfg, dtype=dtype)

    def forward(self, x, temb, rope):
        sh, sc, g, sh_m, sc_m, g_m = self.adaln(F.silu(temb))[:, None].chunk(6, dim=-1)
        x = x + g * self.attn1(self.norm1_i(x).to(x.dtype) * (1 + sc) + sh, rope=rope)
        return x + g_m * self.ff_i(self.norm3_i(x).to(x.dtype) * (1 + sc_m) + sh_m)


@transformer_registry.register("hidream.base", aliases=("hidream", "HiDreamImageTransformer2DModel"))
class HiDreamImageTransformer2DModel(nn.Module):
    config_class = HiDreamConfig

    def __init__(self, cfg: HiDreamConfig, *, dtype=torch.bfloat16):
        super().__init__()
        if not cfg.llama_layers:
            cfg = dataclasses.replace(cfg, llama_layers=tuple(range(cfg.num_layers + cfg.num_single_layers)))
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        self.x_embedder = Linear(cfg.in_channels * cfg.patch_size ** 2, d, dtype=dtype)
        self.t_in_1 = Linear(256, d, dtype=dtype)
        self.t_in_2 = Linear(d, d, dtype=dtype)
        self.p_in_1 = Linear(cfg.text_emb_dim, d, dtype=dtype)
        self.p_in_2 = Linear(d, d, dtype=dtype)
        # one bias-free projection a Llama layer, and the T5 projection last
        self.caption_projection = nn.ModuleList(
            [Linear(cfg.caption_dim, d, use_bias=False, dtype=dtype) for _ in range(len(cfg.llama_layers) + 1)])
        self.double_stream_blocks = nn.ModuleList([_DoubleBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.single_stream_blocks = nn.ModuleList(
            [_SingleBlock(cfg, dtype=dtype) for _ in range(cfg.num_single_layers)])
        self.final_adaln = Linear(d, 2 * d, dtype=dtype)
        self.final_norm = LayerNorm(d, elementwise_affine=False)
        self.proj_out = Linear(d, cfg.patch_size ** 2 * cfg.out_channels, dtype=dtype)

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] → [B, (H/p)(W/p), p·p·C], channel fastest (the layout
        the published ``x_embedder`` expects)."""
        p = self.cfg.patch_size
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 3, 5, 1)
        return x.reshape(b, (h // p) * (w // p), p * p * c)

    def unpatchify(self, tok: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """Output features [p1, p2, C] → [B, C, H, W]."""
        p, c = self.cfg.patch_size, self.cfg.out_channels
        x = tok.reshape(tok.shape[0], h // p, w // p, p, p, c).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(tok.shape[0], c, h, w)

    def rope_tables(self, gh: int, gw: int, n_txt: int, device=None):
        """cos/sin [1, gh·gw + n_txt, 1, D/2] over ``(0, row, col)`` image ids
        (``(row, col)`` with two axes) and zeroed text ids, f32 path."""
        n_axes = len(self.cfg.axes_dims_rope)
        ids_img = np.stack(np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij"), axis=-1).reshape(1, -1, 2)
        if n_axes == 3:
            ids_img = np.concatenate([np.zeros((1, ids_img.shape[1], 1), ids_img.dtype), ids_img], axis=-1)
        ids = np.concatenate([ids_img, np.zeros((1, n_txt, n_axes), ids_img.dtype)], axis=1)
        cos, sin = precompute_axial_freqs(torch.as_tensor(ids, dtype=torch.float32, device=device),
                                          self.cfg.axes_dims_rope, self.cfg.rope_theta)
        return cos[:, :, None, :], sin[:, :, None, :]

    def forward(self, x: torch.Tensor, t: torch.Tensor, t5_ctx: torch.Tensor,
                llama_ctx: Sequence[torch.Tensor], pooled: torch.Tensor) -> torch.Tensor:
        """x [B, C, H, W]; t [B] in 0..1000; t5_ctx [B, Lt, caption_dim];
        llama_ctx one [B, Ll, caption_dim] a block; pooled [B, text_emb_dim]."""
        cfg = self.cfg
        _, _, hh, ww = x.shape
        gh, gw = hh // cfg.patch_size, ww // cfg.patch_size
        img = self.x_embedder(self.patchify(x).to(self.dtype))

        half = 128
        freqs = torch.as_tensor(np.exp(-math.log(10000.0) * np.arange(half, dtype=np.float64) / half),
                                dtype=torch.float32, device=x.device)
        args = t.float()[:, None] * freqs[None]
        sincos = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        temb = self.t_in_2(F.silu(self.t_in_1(sincos.to(self.dtype))))
        temb = temb + self.p_in_2(F.silu(self.p_in_1(pooled.to(self.dtype))))

        llama_proj = [self.caption_projection[i](h_.to(self.dtype)) for i, h_ in enumerate(llama_ctx)]
        txt = torch.cat([self.caption_projection[-1](t5_ctx.to(self.dtype)), llama_proj[-1]], dim=1)
        n_init = txt.shape[1]
        rope = self.rope_tables(gh, gw, n_init + llama_proj[0].shape[1], device=x.device)

        bid = 0
        for blk in self.double_stream_blocks:
            img, cur = blk(img, torch.cat([txt, llama_proj[bid]], dim=1), temb, rope)
            txt = cur[:, :n_init]
            bid += 1
        x_seq = torch.cat([img, txt], dim=1)
        n_img_txt = x_seq.shape[1]
        for blk in self.single_stream_blocks:
            x_seq = blk(torch.cat([x_seq, llama_proj[bid]], dim=1), temb, rope)[:, :n_img_txt]
            bid += 1

        img = x_seq[:, :gh * gw]
        sh, sc = self.final_adaln(F.silu(temb))[:, None].chunk(2, dim=-1)
        img = self.final_norm(img).to(img.dtype) * (1 + sc) + sh
        return self.unpatchify(self.proj_out(img).float(), hh, ww)
