"""LongCat-Video DiT, port of ``apex_studio_tpu/models/transformers/longcat.py``.

A 48-deep single-stream DiT at hidden 4096 (32 heads of 128) over Wan-VAE
latents:

- fused-QKV self-attention with q/k RMSNorm and interleaved-pair 3-axis RoPE
  whose per-axis dims derive from the head dim (t = D − 4⌊D/6⌋, h = w =
  2⌊D/6⌋, θ = 10000)
- text cross-attention over UMT5 features through a 2-layer tanh-GELU
  caption embedder; the text mask goes to the kernel as a key-padding row
- per-frame AdaLN: the timestep may differ per latent frame (0 on the
  conditioning frames), so each of the six modulations is [B, T, 1, C] and
  applies to its frame's h·w tokens, in f32
- a SwiGLU feed-forward (no bias, hidden 256·⌈⅔·4·dim/256⌉)

Conditioning modes with static shapes, as in JAX:

- ``num_cond_latents > 0`` (i2v, continuation without a cache): the
  conditioning tokens attend only among themselves and the noise tokens to
  every key, two kernel launches (Sq = Sk = n_cond, then Sq = n − n_cond
  against all n keys); the cross-attention output is zero on the
  conditioning span
- ``kv_cache`` (continuation with a cache): each block's pre-RoPE K/V of the
  clean context, made once with ``return_kv`` (t = 0, cross-attention
  skipped), are put before the new frames' K/V; RoPE runs over the whole
  context-plus-new grid and the queries take its tail, one launch of the
  new frames' queries against context + new keys

Same attribute names and dtype flow as the JAX module; every attention goes
to ``ops.attention`` (the flash kernel on the card).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import LayerNorm, Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import apply_rope, precompute_axial_freqs


@dataclasses.dataclass
class LongCatConfig:
    in_channels: int = 16
    out_channels: int = 16
    hidden_size: int = 4096
    depth: int = 48
    num_heads: int = 32
    caption_channels: int = 4096
    mlp_ratio: float = 4.0
    adaln_tembed_dim: int = 512
    frequency_embedding_size: int = 256
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_tokens_zero_pad: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rope_dims(self) -> Tuple[int, int, int]:
        hd = self.head_dim
        d_hw = 2 * (hd // 6)
        return (hd - 2 * d_hw, d_hw, d_hw)

    @classmethod
    def from_dict(cls, cfg: dict) -> "LongCatConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "patch_size" in kw:
            kw["patch_size"] = tuple(kw["patch_size"])
        return cls(**kw)


class LongCatBlock(nn.Module):
    def __init__(self, cfg: LongCatConfig, *, dtype):
        super().__init__()
        d = cfg.hidden_size
        self.adaLN_linear = Linear(cfg.adaln_tembed_dim, 6 * d, dtype=dtype)
        self.pre_crs_attn_norm = LayerNorm(d, eps=1e-6)
        self.qkv = Linear(d, 3 * d, dtype=dtype)
        self.q_norm = RMSNorm(cfg.head_dim, eps=1e-6)
        self.k_norm = RMSNorm(cfg.head_dim, eps=1e-6)
        self.proj = Linear(d, d, dtype=dtype)
        self.q_linear = Linear(d, d, dtype=dtype)
        self.kv_linear = Linear(d, 2 * d, dtype=dtype)
        self.cross_proj = Linear(d, d, dtype=dtype)
        self.cross_q_norm = RMSNorm(cfg.head_dim, eps=1e-6)
        self.cross_k_norm = RMSNorm(cfg.head_dim, eps=1e-6)
        hidden = int(2 * (d * cfg.mlp_ratio) / 3)
        hidden = 256 * ((hidden + 255) // 256)
        self.ffn_w1 = Linear(d, hidden, use_bias=False, dtype=dtype)
        self.ffn_w2 = Linear(hidden, d, use_bias=False, dtype=dtype)
        self.ffn_w3 = Linear(d, hidden, use_bias=False, dtype=dtype)
        self.heads = cfg.num_heads
        self.head_dim = cfg.head_dim

    def _mods(self, temb):
        # temb [B, T, C_t] → six [B, T, 1, C] per-frame modulations
        out = self.adaLN_linear(F.silu(temb.float()))
        return out[:, :, None, :].chunk(6, dim=-1)

    @staticmethod
    def _modulate(x, t_frames, shift, scale):
        b, n, c = x.shape
        xf = layer_norm(x.reshape(b, t_frames, n // t_frames, c).float(), eps=1e-6)
        return (xf * (1 + scale) + shift).reshape(b, n, c).to(x.dtype)

    @staticmethod
    def _gate(x, delta, t_frames, gate):
        b, n, c = x.shape
        out = (x.float().reshape(b, t_frames, n // t_frames, c)
               + gate * delta.float().reshape(b, t_frames, n // t_frames, c))
        return out.reshape(b, n, c).to(x.dtype)

    def self_attention(self, x_m, rope, n_cond_tok, kv_cache, return_kv):
        b, n, c = x_m.shape
        q, k, v = self.qkv(x_m).reshape(b, n, 3, self.heads, self.head_dim).unbind(2)
        q, k = self.q_norm(q), self.k_norm(k)
        new_kv = (k, v) if return_kv else None
        cos, sin = rope
        if kv_cache is not None:
            k_full = torch.cat([kv_cache[0].to(k.dtype), k], dim=1)
            v_full = torch.cat([kv_cache[1].to(v.dtype), v], dim=1)
            # RoPE over the whole (context + new) grid; the queries take its tail
            k_full = apply_rope(k_full, cos, sin)
            q = apply_rope(q, cos[:, -n:], sin[:, -n:])
            out = attention_op(q, k_full, v_full).reshape(b, n, c)
        else:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            if n_cond_tok > 0:
                # the conditioning tokens see only themselves; the noise sees all
                out_c = attention_op(q[:, :n_cond_tok], k[:, :n_cond_tok], v[:, :n_cond_tok])
                out_n = attention_op(q[:, n_cond_tok:], k, v)
                out = torch.cat([out_c, out_n], dim=1).reshape(b, n, c)
            else:
                out = attention_op(q, k, v).reshape(b, n, c)
        return self.proj(out), new_kv

    def cross_attention(self, x, text, text_mask, n_cond_tok):
        b, n, c = x.shape
        xq = x if n_cond_tok == 0 else x[:, n_cond_tok:]
        q = self.cross_q_norm(self.q_linear(xq).reshape(b, xq.shape[1], self.heads, self.head_dim))
        k, v = self.kv_linear(text).reshape(b, text.shape[1], 2, self.heads, self.head_dim).unbind(2)
        k = self.cross_k_norm(k)
        mask = None if text_mask is None else text_mask.bool()
        out = self.cross_proj(attention_op(q, k, v, mask=mask).reshape(b, xq.shape[1], c))
        if n_cond_tok > 0:
            out = torch.cat([out.new_zeros(b, n_cond_tok, c), out], dim=1)
        return out

    def forward(self, x, text, temb, text_mask, t_frames, rope, n_cond_tok=0, return_kv=False, kv_cache=None,
                skip_crs_attn=False):
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = self._mods(temb)
        x_m = self._modulate(x, t_frames, sh_a, sc_a)
        attn, new_kv = self.self_attention(x_m, rope, n_cond_tok, kv_cache, return_kv)
        x = self._gate(x, attn, t_frames, g_a)
        if not skip_crs_attn:
            x = x + self.cross_attention(self.pre_crs_attn_norm(x), text, text_mask, n_cond_tok)
        x_m = self._modulate(x, t_frames, sh_m, sc_m)
        ffn = self.ffn_w2(F.silu(self.ffn_w1(x_m)) * self.ffn_w3(x_m))
        x = self._gate(x, ffn, t_frames, g_m)
        return (x, new_kv) if return_kv else x


@transformer_registry.register("longcat.base", aliases=("longcat", "LongCatVideoTransformer3DModel"))
class LongCatVideoTransformer3DModel(nn.Module):
    config_class = LongCatConfig

    def __init__(self, cfg: LongCatConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.hidden_size
        pt, ph, pw = cfg.patch_size
        self.x_embedder = Linear(cfg.in_channels * pt * ph * pw, d, dtype=dtype)
        self.t_linear_1 = Linear(cfg.frequency_embedding_size, cfg.adaln_tembed_dim, dtype=dtype)
        self.t_linear_2 = Linear(cfg.adaln_tembed_dim, cfg.adaln_tembed_dim, dtype=dtype)
        self.y_linear_1 = Linear(cfg.caption_channels, d, dtype=dtype)
        self.y_linear_2 = Linear(d, d, dtype=dtype)
        self.blocks = nn.ModuleList([LongCatBlock(cfg, dtype=dtype) for _ in range(cfg.depth)])
        self.final_adaLN_linear = Linear(cfg.adaln_tembed_dim, 2 * d, dtype=dtype)
        self.final_linear = Linear(d, pt * ph * pw * cfg.out_channels, dtype=dtype)

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        pt, ph, pw = self.cfg.patch_size
        x = x.reshape(b, c, t // pt, pt, h // ph, ph, w // pw, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
        return x.reshape(b, (t // pt) * (h // ph) * (w // pw), c * pt * ph * pw)

    def unpatchify(self, tokens: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
        """``final_linear`` features are [pt, ph, pw, C], channel fastest, as
        the published checkpoint lays them out; the input side stays
        conv-ordered [C, pt, ph, pw]."""
        b = tokens.shape[0]
        pt, ph, pw = self.cfg.patch_size
        c = self.cfg.out_channels
        x = tokens.reshape(b, t // pt, h // ph, w // pw, pt, ph, pw, c).permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(b, c, t, h, w)

    def rope_tables(self, t_tok: int, h_tok: int, w_tok: int, device=None):
        """cos / sin [1, t·h·w, 1, D/2] over integer (t, h, w) ids, in float64
        numpy cast to f32, as JAX builds them."""
        ids = np.stack(np.meshgrid(np.arange(t_tok), np.arange(h_tok), np.arange(w_tok), indexing="ij"),
                       axis=-1).reshape(1, -1, 3)
        cos, sin = precompute_axial_freqs(ids, self.cfg.rope_dims, 10000.0)
        return (torch.from_numpy(cos)[:, :, None, :].to(device),
                torch.from_numpy(sin)[:, :, None, :].to(device))

    def forward(
        self,
        x: torch.Tensor,                 # [B, C, T, H, W] latents
        t: torch.Tensor,                 # [B] or [B, T_tok] timestep (0..1000)
        text: torch.Tensor,              # [B, L, caption_channels]
        text_mask: Optional[torch.Tensor] = None,
        num_cond_latents: int = 0,
        return_kv: bool = False,
        kv_cache: Optional[Sequence] = None,
        skip_crs_attn: bool = False,
        num_ctx_latents: int = 0,        # latent frames already in kv_cache
    ):
        cfg = self.cfg
        b, _, tt, hh, ww = x.shape
        pt, ph, pw = cfg.patch_size
        n_t, n_h, n_w = tt // pt, hh // ph, ww // pw

        if t.ndim == 1:
            t = t[:, None].expand(b, n_t)
        t_freq = timestep_embedding(t.reshape(-1).float(), cfg.frequency_embedding_size, flip_sin_to_cos=True)
        temb = self.t_linear_2(F.silu(self.t_linear_1(t_freq))).reshape(b, n_t, -1)

        tokens = self.x_embedder(self.patchify(x).to(self.dtype))
        y = self.y_linear_2(F.gelu(self.y_linear_1(text.to(self.dtype)), approximate="tanh"))
        if cfg.text_tokens_zero_pad and text_mask is not None:
            y = y * text_mask[..., None].to(y.dtype)
            text_mask = torch.ones_like(text_mask)

        rope = self.rope_tables(n_t + num_ctx_latents, n_h, n_w, device=tokens.device)
        n_cond_tok = num_cond_latents * n_h * n_w

        caches: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for i, blk in enumerate(self.blocks):
            out = blk(tokens, y, temb, text_mask, n_t, rope, n_cond_tok=n_cond_tok, return_kv=return_kv,
                      kv_cache=None if kv_cache is None else kv_cache[i], skip_crs_attn=skip_crs_attn)
            if return_kv:
                tokens, kv = out
                caches.append(kv)
            else:
                tokens = out

        shift, scale = self.final_adaLN_linear(F.silu(temb.float()))[:, :, None, :].chunk(2, dim=-1)
        n = tokens.shape[1]
        xf = layer_norm(tokens.reshape(b, n_t, n // n_t, -1).float(), eps=1e-6)
        xf = (xf * (1 + scale) + shift).reshape(b, n, -1)
        out = self.final_linear(xf.to(self.dtype))
        out = self.unpatchify(out, tt, hh, ww).float()
        return (out, caches) if return_kv else out
