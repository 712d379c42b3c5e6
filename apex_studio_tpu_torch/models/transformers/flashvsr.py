"""FlashVSR's streaming video super-resolution DiT (the Wan 2.1 1.3B
architecture), port of ``apex_studio_tpu/models/transformers/flashvsr.py``.

A one-step (DMD-distilled) Wan-style DiT that denoises video latents in causal
chunks (first 6 latent frames, then 2 a step) with a rolling self-attention
cache of the last ``kv_len`` chunks, and a cross-attention whose context K/V is
computed once (``context_kv``). The low-quality pixels enter through a causal
conv stack (``FVLQProj``, LQ_proj_in) whose per-layer Linear outputs are added
to the token stream before block 0.

- self-attention over ``[cache ‖ current]`` keys, dense and unmasked (the
  reference approximates it with a top-k block-sparse mask; the dense one is
  its exact version, as in JAX): one kernel launch a block; the new cache
  keeps the last ``kv_len``·2 latent frames of K/V
- RoPE tables on the host in float64 a chunk, time positions from ``f_start``
- Linear weights kept in f32 and computed in the compute dtype, as the JAX
  module keeps them (``FVLinear``)

``FVLinear``, ``FVRMSNorm``, ``FVLayerNorm`` and ``FVHead`` keep these names:
Ovi's DiT is built from them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.ops.attention import attention
from apex_studio_tpu_torch.ops.norms import layer_norm, rms_norm


@dataclasses.dataclass
class FlashVSRConfig:
    dim: int = 1536
    in_dim: int = 16
    ffn_dim: int = 8960
    out_dim: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    eps: float = 1e-6
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_heads: int = 12
    num_layers: int = 30
    lq4x_proj_in_dim: int = 3
    lq4x_proj_out_dim: int = 1536
    lq4x_proj_layer_num: int = 1
    lq_hidden_dim1: int = 2048
    lq_hidden_dim2: int = 3072
    kv_len: int = 3  # rolling cache: chunks of 2 latent frames kept as K/V

    @classmethod
    def from_dict(cls, cfg: dict) -> "FlashVSRConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "patch_size" in kw:
            kw["patch_size"] = tuple(kw["patch_size"])
        return cls(**kw)

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


class FVLinear(Linear):
    """A Linear whose weight is stored in f32 and computed in ``dtype``."""

    def __init__(self, cin: int, cout: int, bias: bool = True, *, dtype):
        super().__init__(cin, cout, use_bias=bias, dtype=dtype, param_dtype=torch.float32)


class FVRMSNorm(nn.Module):
    """RMSNorm with an affine weight, f32 statistics."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class FVLayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, affine: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32)) if affine else None
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32)) if affine else None
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def _rope_tables_3d(head_dim: int, f: int, h: int, w: int, f_start: int,
                    theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """Wan's 3D RoPE: the head dim's half split 2:1:1 over (t, h, w), time
    positions from ``f_start``. Returns (cos, sin), each [f·h·w, head_dim/2]
    in f32, computed in float64."""
    d_t, d_sp = head_dim - 2 * (head_dim // 3), head_dim // 3

    def freqs(dim):
        return 1.0 / theta ** (np.arange(0, dim, 2, np.float64)[: dim // 2] / dim)

    ang_t = np.outer(np.arange(f_start, f_start + f, dtype=np.float64), freqs(d_t))
    ang_h = np.outer(np.arange(h, dtype=np.float64), freqs(d_sp))
    ang_w = np.outer(np.arange(w, dtype=np.float64), freqs(d_sp))
    ang = np.concatenate([
        np.broadcast_to(ang_t[:, None, None, :], (f, h, w, ang_t.shape[1])),
        np.broadcast_to(ang_h[None, :, None, :], (f, h, w, ang_h.shape[1])),
        np.broadcast_to(ang_w[None, None, :, :], (f, h, w, ang_w.shape[1])),
    ], axis=-1).reshape(f * h * w, head_dim // 2)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, Dh]; adjacent pairs rotated as complex numbers, in f32."""
    b, s, h, dh = x.shape
    xr = x.float().reshape(b, s, h, dh // 2, 2)
    re, im = xr[..., 0], xr[..., 1]
    c, sn = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack([re * c - im * sn, re * sn + im * c], dim=-1).reshape(b, s, h, dh).to(x.dtype)


class FVSelfAttention(nn.Module):
    def __init__(self, cfg: FlashVSRConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.q, self.k, self.v, self.o = (FVLinear(d, d, dtype=dtype) for _ in range(4))
        self.norm_q = FVRMSNorm(d, cfg.eps)
        self.norm_k = FVRMSNorm(d, cfg.eps)
        self.cfg = cfg

    def forward(self, x, rope_cos, rope_sin, cache_k=None, cache_v=None):
        """x: [B, L, D]; cache_{k,v}: [B, L_c, D], normed and rotated. Returns
        (out, K, V) with K/V the whole [cache ‖ current] (the caller trims)."""
        cfg = self.cfg
        b, l, d = x.shape
        q = _apply_rope(self.norm_q(self.q(x)).reshape(b, l, cfg.num_heads, cfg.head_dim), rope_cos, rope_sin)
        k = _apply_rope(self.norm_k(self.k(x)).reshape(b, l, cfg.num_heads, cfg.head_dim), rope_cos, rope_sin)
        k, v = k.reshape(b, l, d), self.v(x)
        if cache_k is not None:
            k, v = torch.cat([cache_k, k], dim=1), torch.cat([cache_v, v], dim=1)
        out = attention(q, k.reshape(b, -1, cfg.num_heads, cfg.head_dim), v.reshape(b, -1, cfg.num_heads, cfg.head_dim))
        return self.o(out.reshape(b, l, d)), k, v


class FVCrossAttention(nn.Module):
    def __init__(self, cfg: FlashVSRConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.q, self.k, self.v, self.o = (FVLinear(d, d, dtype=dtype) for _ in range(4))
        self.norm_q = FVRMSNorm(d, cfg.eps)
        self.norm_k = FVRMSNorm(d, cfg.eps)
        self.cfg = cfg

    def kv_from_context(self, ctx):
        """The persistent context K/V."""
        return self.norm_k(self.k(ctx)), self.v(ctx)

    def forward(self, x, ctx_k, ctx_v):
        cfg = self.cfg
        b, l, d = x.shape
        q = self.norm_q(self.q(x)).reshape(b, l, cfg.num_heads, cfg.head_dim)
        out = attention(q, ctx_k.reshape(b, -1, cfg.num_heads, cfg.head_dim),
                        ctx_v.reshape(b, -1, cfg.num_heads, cfg.head_dim))
        return self.o(out.reshape(b, l, d))


class FVBlock(nn.Module):
    def __init__(self, cfg: FlashVSRConfig, *, dtype):
        super().__init__()
        self.self_attn = FVSelfAttention(cfg, dtype=dtype)
        self.cross_attn = FVCrossAttention(cfg, dtype=dtype)
        self.norm1 = FVLayerNorm(cfg.dim, cfg.eps, affine=False)
        self.norm2 = FVLayerNorm(cfg.dim, cfg.eps, affine=False)
        self.norm3 = FVLayerNorm(cfg.dim, cfg.eps, affine=True)
        self.ffn_0 = FVLinear(cfg.dim, cfg.ffn_dim, dtype=dtype)
        self.ffn_2 = FVLinear(cfg.ffn_dim, cfg.dim, dtype=dtype)
        self.modulation = nn.Parameter(torch.empty(1, 6, cfg.dim, dtype=torch.float32))  # from the checkpoint

    def forward(self, x, t_mod, rope_cos, rope_sin, ctx_k, ctx_v, cache_k=None, cache_v=None):
        mod = self.modulation + t_mod.float()  # [B, 6, D]
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = (mod[:, i][:, None].to(x.dtype) for i in range(6))
        attn, new_k, new_v = self.self_attn(self.norm1(x) * (1 + sc_msa) + sh_msa, rope_cos, rope_sin,
                                            cache_k, cache_v)
        x = x + attn * g_msa
        x = x + self.cross_attn(self.norm3(x), ctx_k, ctx_v)
        h = self.ffn_2(F.gelu(self.ffn_0(self.norm2(x) * (1 + sc_mlp) + sh_mlp), approximate="tanh"))
        return x + h * g_mlp, new_k, new_v


class FVHead(nn.Module):
    def __init__(self, cfg: FlashVSRConfig, *, dtype):
        super().__init__()
        self.norm = FVLayerNorm(cfg.dim, cfg.eps, affine=False)
        self.head = FVLinear(cfg.dim, cfg.out_dim * int(np.prod(cfg.patch_size)), dtype=dtype)
        self.modulation = nn.Parameter(torch.empty(1, 2, cfg.dim, dtype=torch.float32))  # from the checkpoint

    def forward(self, x, t):
        mod = self.modulation + t.float()[:, None]  # [B, 2, D]
        shift, scale = mod[:, 0][:, None], mod[:, 1][:, None]
        return self.head((self.norm(x) * (1 + scale) + shift).to(x.dtype))


class FVCausalConv3d(nn.Module):
    """A causal Conv3d that pads by replicating the edge on every padded side
    (2 frames at the temporal head when ``pad_head``, one pixel around);
    without ``pad_head`` a valid temporal conv. [B, C, T, H, W]."""

    def __init__(self, cin, cout, kernel, stride, pad_head: bool = True, *, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=torch.float32))
        self.stride = tuple(stride)
        self.pad_head = pad_head
        self.dtype = dtype

    def forward(self, x):
        x = F.pad(x, (1, 1, 1, 1, 2 if self.pad_head else 0, 0), mode="replicate")
        y = F.conv3d(x.to(self.dtype), self.weight.to(self.dtype), stride=self.stride)
        return y + self.bias.to(y.dtype)[:, None, None, None]


class FVChannelRMS(nn.Module):
    """RMS norm over the channels (dim 1) with a √C scale and a gamma."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.scale = float(dim) ** 0.5

    def forward(self, x):  # [B, C, ...]
        x32 = x.float()
        n = torch.linalg.vector_norm(x32, dim=1, keepdim=True)
        gamma = self.gamma.reshape(-1, *([1] * (x.ndim - 2)))
        return (x32 / n.clamp_min(1e-12) * self.scale * gamma).to(x.dtype)


class FVLQProj(nn.Module):
    """The LQ projector (Causal_LQ4x_Proj) over the whole clip: three copies of
    the first frame at the head, PixelShuffle3d(1, 16, 16) to channels, a causal
    strided conv (a 2-frame replicate head pad), a valid strided conv, then one
    Linear a layer; the chunked stream with conv caches computes the same."""

    def __init__(self, cfg: FlashVSRConfig, *, dtype):
        super().__init__()
        c_in = cfg.lq4x_proj_in_dim * 16 * 16
        self.conv1 = FVCausalConv3d(c_in, cfg.lq_hidden_dim1, (4, 3, 3), (2, 1, 1), pad_head=True, dtype=dtype)
        self.norm1 = FVChannelRMS(cfg.lq_hidden_dim1)
        self.conv2 = FVCausalConv3d(cfg.lq_hidden_dim1, cfg.lq_hidden_dim2, (4, 3, 3), (2, 1, 1), pad_head=False,
                                    dtype=dtype)
        self.norm2 = FVChannelRMS(cfg.lq_hidden_dim2)
        self.linear_layers = nn.ModuleList([FVLinear(cfg.lq_hidden_dim2, cfg.lq4x_proj_out_dim, dtype=dtype)
                                            for _ in range(cfg.lq4x_proj_layer_num)])

    def forward(self, video: torch.Tensor) -> List[torch.Tensor]:
        """video: [B, 3, F, H, W] in [-1, 1], F + 3 a multiple of 4. Returns one
        [B, (F+3)/4·(H/16)·(W/16), out_dim] token feature a layer, one latent
        frame to 4 video frames."""
        x = video.float()
        x = torch.cat([x[:, :, :1].expand(-1, -1, 3, -1, -1), x], dim=2)
        b, c, t, h, w = x.shape
        # PixelShuffle3d(1, 16, 16): space to channels in torch's order (c, ph, pw)
        x = x.reshape(b, c, t, h // 16, 16, w // 16, 16).permute(0, 1, 4, 6, 2, 3, 5)
        x = x.reshape(b, c * 256, t, h // 16, w // 16)
        y = F.silu(self.norm1(self.conv1(x)))
        z = F.silu(self.norm2(self.conv2(y)))
        tokens = z.permute(0, 2, 3, 4, 1).reshape(b, -1, z.shape[1])
        return [lin(tokens) for lin in self.linear_layers]


@transformer_registry.register("wan.flashvsr", aliases=("flashvsr", "FlashVSRModel"))
class FlashVSRTransformer3DModel(nn.Module):
    config_class = FlashVSRConfig

    def __init__(self, cfg: Optional[FlashVSRConfig] = None, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg = cfg or FlashVSRConfig()
        self.dtype = dtype
        p = int(np.prod(cfg.patch_size))
        self.patch_embedding = FVLinear(cfg.in_dim * p, cfg.dim, dtype=dtype)
        self.text_embedding_0 = FVLinear(cfg.text_dim, cfg.dim, dtype=dtype)
        self.text_embedding_2 = FVLinear(cfg.dim, cfg.dim, dtype=dtype)
        self.time_embedding_0 = FVLinear(cfg.freq_dim, cfg.dim, dtype=dtype)
        self.time_embedding_2 = FVLinear(cfg.dim, cfg.dim, dtype=dtype)
        self.time_projection_1 = FVLinear(cfg.dim, cfg.dim * 6, dtype=dtype)
        self.blocks = nn.ModuleList([FVBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.head = FVHead(cfg, dtype=dtype)
        self.LQ_proj_in = FVLQProj(cfg, dtype=dtype)

    def time_embed(self, timestep: float, batch: int = 1):
        """t [B, dim] and t_mod [B, 6, dim] for the fixed one-step timestep; the
        sinusoid on the host in float64."""
        half = self.cfg.freq_dim // 2
        ang = timestep * np.power(10000.0, -np.arange(half, dtype=np.float64) / half)
        emb = np.concatenate([np.cos(ang), np.sin(ang)]).astype(np.float32)
        emb = torch.from_numpy(np.tile(emb[None], (batch, 1))).to(self.patch_embedding.weight.device)
        t = self.time_embedding_2(F.silu(self.time_embedding_0(emb)))
        return t, self.time_projection_1(F.silu(t)).reshape(batch, 6, self.cfg.dim)

    def context_kv(self, context: torch.Tensor):
        """Each block's persistent context K/V."""
        ctx = self.text_embedding_2(F.gelu(self.text_embedding_0(context), approximate="tanh"))
        return [blk.cross_attn.kv_from_context(ctx) for blk in self.blocks]

    def rope_for_chunk(self, f: int, h_tok: int, w_tok: int, f_start: int):
        dev = self.patch_embedding.weight.device
        cos, sin = _rope_tables_3d(self.cfg.head_dim, f, h_tok, w_tok, f_start)
        return torch.from_numpy(cos).to(dev), torch.from_numpy(sin).to(dev)

    def patchify(self, x: torch.Tensor):
        """[B, C, f, H, W] → tokens [B, f·h·w, dim] (features (C, pt, ph, pw),
        the conv's flatten) and the grid."""
        pt, ph, pw = self.cfg.patch_size
        b, c, f, hh, ww = x.shape
        h, w = hh // ph, ww // pw
        x = x.reshape(b, c, f // pt, pt, h, ph, w, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
        return self.patch_embedding(x.reshape(b, (f // pt) * h * w, c * pt * ph * pw)), (f // pt, h, w)

    def unpatchify(self, tokens: torch.Tensor, grid) -> torch.Tensor:
        f, h, w = grid
        pt, ph, pw = self.cfg.patch_size
        c = self.cfg.out_dim
        x = tokens.reshape(tokens.shape[0], f, h, w, pt, ph, pw, c).permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(tokens.shape[0], c, f * pt, h * ph, w * pw)

    def forward(self, x, t, t_mod, rope_cos, rope_sin, ctx_kv, lq_tokens: Optional[List[torch.Tensor]] = None,
                caches: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None):
        """One streaming chunk. Returns (noise prediction, the new caches), each
        cache trimmed to its last ``kv_len``·2 latent frames of K/V."""
        tokens, grid = self.patchify(x)
        _, h, w = grid
        keep = self.cfg.kv_len * 2 * h * w
        new_caches = []
        for i, blk in enumerate(self.blocks):
            if lq_tokens is not None and i < len(lq_tokens):
                tokens = tokens + lq_tokens[i]
            ck, cv = caches[i] if caches is not None else (None, None)
            tokens, nk, nv = blk(tokens, t_mod, rope_cos, rope_sin, *ctx_kv[i], ck, cv)
            new_caches.append((nk[:, -keep:], nv[:, -keep:]))
        return self.unpatchify(self.head(tokens, t), grid), new_caches
