"""HunyuanImage 3.0 causal multimodal MoE backbone as a diffusion denoiser,
port of ``apex_studio_tpu/models/transformers/hunyuanimage3.py``.

One causal-LM transformer serves the text prefix and the image latent
tokens. The sequence is ``[text tokens …, <timestep>, <img>×N, trailing
tokens]``: the <timestep> slot holds ``timestep_emb(t)`` and the <img> slots
the UNet patch embedding of the latents.

- ``_UNetDown`` / ``_UNetUp`` patch embed and final layer: conv3x3 stem,
  timestep-modulated ResBlocks (GroupNorm 32, avgpool down / nearest up, an
  adaptive norm into a zero-init conv), NCHW here where JAX runs NHWC
- decoder layers: RMSNorm → fused-QKV GQA attention → RMSNorm → MLP or MoE.
  The fused qkv unpacks per-KV-head groups ``(kv, groups+2, hd)``; 2-D
  rotate-half RoPE runs before the optional per-head QK RMSNorm; K and V
  are repeated to the query heads
- the MoE is dense, as in JAX: softmax gates in f32 (optionally
  group-limited), top-k, renormalised or scaled; every expert runs on every
  token and the results add up in f32 in expert order, the shared MLP last
- SwiGLU gates on the second chunk: ``down(x1 * silu(x2))``
- no final backbone norm: ``time_embed_2`` modulates the UNetUp final layer

The attention mask is causal everywhere and full inside the image span. JAX
builds it as an ``[S, S]`` boolean mask, which its front sends to XLA; here
each layer splits the attention into two kernel launches that compute the
same rows (``span_attention``), and no ``[S, S]`` mask is built.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.models.vaes.autoencoder_kl import Conv2d, GroupNorm
from apex_studio_tpu_torch.ops.attention import attention


@dataclasses.dataclass
class HunyuanImage3Config:
    vocab_size: int = 128000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    moe_intermediate_size: Optional[int] = None
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    attention_head_dim: Optional[int] = None
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    attention_bias: bool = False
    mlp_bias: bool = False
    use_qk_norm: bool = False
    norm_type: str = "hf_rms"
    # MoE
    num_experts: int = 1
    use_mixed_mlp_moe: bool = False
    num_shared_expert: int = 1
    moe_topk: int = 1
    moe_layer_num_skipped: int = 0
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    group_limited_greedy: bool = False
    n_group: Optional[int] = None
    topk_group: Optional[int] = None
    # image branch (img_proj_type == "unet")
    img_in_channels: int = 32
    img_out_channels: int = 32
    patch_size: int = 1
    patch_embed_hidden_dim: int = 1024

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.attention_head_dim is None:
            self.attention_head_dim = self.hidden_size // self.num_attention_heads

    @classmethod
    def from_dict(cls, cfg: dict) -> "HunyuanImage3Config":
        cfg = dict(cfg)
        vae = cfg.get("vae")
        if isinstance(vae, dict) and "latent_channels" in vae:
            cfg.setdefault("img_in_channels", vae["latent_channels"])
            cfg.setdefault("img_out_channels", vae["latent_channels"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in known})


def _timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """cos-first sinusoid, in f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class _TimestepEmbedder(nn.Module):
    """Sinusoid → Linear → GELU (erf) → Linear."""

    def __init__(self, hidden_size: int, *, freq_size: int = 256, dtype):
        super().__init__()
        self.mlp_0 = Linear(freq_size, hidden_size, dtype=dtype)
        self.mlp_2 = Linear(hidden_size, hidden_size, dtype=dtype)
        self.freq_size = freq_size

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        h = self.mlp_0(_timestep_embedding(t, self.freq_size).to(self.mlp_0.dtype))
        return self.mlp_2(F.gelu(h, approximate="none"))


class _ResBlock(nn.Module):
    """GroupNorm32 → SiLU → (avgpool down / nearest up) → conv3x3, then the
    adaptive GroupNorm ``norm(h)·(1+scale)+shift`` → SiLU → conv3x3, plus a
    1x1-conv (or identity) skip. NCHW."""

    def __init__(self, cin: int, emb: int, cout: Optional[int] = None, *, up: bool = False,
                 down: bool = False, dtype):
        super().__init__()
        cout = cout or cin
        self.in_norm = GroupNorm(cin, 32, eps=1e-5)
        self.in_conv = Conv2d(cin, cout, dtype=dtype)
        self.emb_layers = Linear(emb, 2 * cout, dtype=dtype)
        self.out_norm = GroupNorm(cout, 32, eps=1e-5)
        self.out_conv = Conv2d(cout, cout, dtype=dtype)
        self.skip_connection = None if cout == cin else Conv2d(cin, cout, kernel=1, padding=0, dtype=dtype)
        self.up, self.down = up, down

    @staticmethod
    def _avgpool(x):
        b, c, h, w = x.shape
        return x.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))

    @staticmethod
    def _nearest2x(x):
        return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.in_norm(x))
        if self.down:
            h, x = self._avgpool(h), self._avgpool(x)
        elif self.up:
            h, x = self._nearest2x(h), self._nearest2x(x)
        h = self.in_conv(h)
        scale, shift = self.emb_layers(F.silu(emb))[:, :, None, None].chunk(2, dim=1)
        h = self.out_norm(h) * (1.0 + scale) + shift
        h = self.out_conv(F.silu(h))
        skip = x if self.skip_connection is None else self.skip_connection(x)
        return skip + h


class _OutConv(nn.Module):
    """UNetUp's trailing norm → SiLU → conv3x3."""

    def __init__(self, cin: int, cout: int, *, dtype):
        super().__init__()
        self.norm = GroupNorm(cin, 32, eps=1e-5)
        self.conv = Conv2d(cin, cout, dtype=dtype)

    def forward(self, x):
        return self.conv(F.silu(self.norm(x)))


class _UNetDown(nn.Module):
    """Latents (NCHW) → token sequence; ``model`` is [conv3x3, ResBlock…]."""

    def __init__(self, patch_size: int, in_ch: int, emb: int, hidden: int, out: int, *, dtype):
        super().__init__()
        assert patch_size in (1, 2, 4, 8)
        mods = [Conv2d(in_ch, hidden, dtype=dtype)]
        if patch_size == 1:
            mods.append(_ResBlock(hidden, emb, out, dtype=dtype))
        else:
            for i in range(patch_size // 2):
                mods.append(_ResBlock(hidden, emb, hidden if (i + 1) * 2 != patch_size else out, down=True,
                                      dtype=dtype))
        self.model = nn.ModuleList(mods)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor):
        for m in self.model:
            x = m(x, t_emb) if isinstance(m, _ResBlock) else m(x)
        b, c, th, tw = x.shape
        return x.reshape(b, c, th * tw).transpose(1, 2), th, tw


class _UNetUp(nn.Module):
    """Token sequence → latents (NCHW), with the trailing norm and conv."""

    def __init__(self, patch_size: int, in_ch: int, emb: int, hidden: int, out: int, *, dtype):
        super().__init__()
        assert patch_size in (1, 2, 4, 8)
        mods = []
        if patch_size == 1:
            mods.append(_ResBlock(in_ch, emb, hidden, dtype=dtype))
        else:
            for i in range(patch_size // 2):
                mods.append(_ResBlock(in_ch if i == 0 else hidden, emb, hidden, up=True, dtype=dtype))
        mods.append(_OutConv(hidden, out, dtype=dtype))
        self.model = nn.ModuleList(mods)

    def forward(self, tok: torch.Tensor, t_emb: torch.Tensor, th: int, tw: int):
        b, s, c = tok.shape
        x = tok.transpose(1, 2).reshape(b, c, th, tw)
        for m in self.model:
            x = m(x, t_emb) if isinstance(m, _ResBlock) else m(x)
        return x


class _HYMLP(nn.Module):
    """SwiGLU on the fused gate_and_up layout, gated on the second chunk."""

    def __init__(self, dim: int, hidden: int, *, use_bias: bool, dtype):
        super().__init__()
        self.gate_and_up_proj = Linear(dim, 2 * hidden, use_bias=use_bias, dtype=dtype)
        self.down_proj = Linear(hidden, dim, use_bias=use_bias, dtype=dtype)

    def forward(self, x):
        x1, x2 = self.gate_and_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(x1 * F.silu(x2))


class _HYGate(nn.Module):
    """Router: f32 softmax gates → optional group-limited greedy mask →
    top-k → renormalised (or scaled) weights, zero outside the top-k.

    Where gates tie, ``torch.topk`` and ``jax.lax.top_k`` may pick different
    experts; after the group mask a tie is among zero weights, which add
    nothing either way."""

    def __init__(self, cfg: HunyuanImage3Config):
        super().__init__()
        self.wg = Linear(cfg.hidden_size, cfg.num_experts, use_bias=False, dtype=torch.float32)
        self.cfg = cfg

    def forward(self, x):
        cfg = self.cfg
        gates = torch.softmax(self.wg(x.float()), dim=-1)
        if cfg.group_limited_greedy:
            g, e = cfg.n_group, gates.shape[-1]
            group_scores = gates.reshape(*gates.shape[:-1], g, e // g).amax(dim=-1)
            kth = torch.sort(group_scores, dim=-1).values[..., g - cfg.topk_group]
            keep = (group_scores >= kth[..., None]).repeat_interleave(e // g, dim=-1)
            gates = torch.where(keep, gates, torch.zeros_like(gates))
        topw, topi = torch.topk(gates, cfg.moe_topk, dim=-1)
        if cfg.norm_topk_prob and cfg.moe_topk > 1:
            topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-8)
        else:
            topw = topw * cfg.routed_scaling_factor
        return torch.zeros_like(gates).scatter(-1, topi, topw)


class _HYMoE(nn.Module):
    def __init__(self, cfg: HunyuanImage3Config, *, dtype):
        super().__init__()
        d = cfg.hidden_size
        moe_hid = cfg.moe_intermediate_size or cfg.intermediate_size
        self.gate = _HYGate(cfg)
        self.shared_mlp = (_HYMLP(d, moe_hid * cfg.num_shared_expert, use_bias=cfg.mlp_bias, dtype=dtype)
                           if cfg.use_mixed_mlp_moe else None)
        self.experts = nn.ModuleList([_HYMLP(d, moe_hid, use_bias=cfg.mlp_bias, dtype=dtype)
                                      for _ in range(cfg.num_experts)])

    def forward(self, x):
        w_full = self.gate(x)
        out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for e, expert in enumerate(self.experts):
            out = out + w_full[..., e:e + 1] * expert(x).float()
        if self.shared_mlp is not None:
            out = out + self.shared_mlp(x).float()
        return out.to(x.dtype)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def span_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, img_begin: int, n_img: int) -> torch.Tensor:
    """Attention under the mask "causal everywhere, full inside the image span
    [img_begin, img_begin + n_img)", as two kernel launches (BSHD):

    - the rows outside the span: one causal launch (Sq == Sk) over the tokens
      up to the span's start when the span ends the sequence, else over the
      whole sequence (a trailing row sees every key before it, the span too);
    - the span's rows: one unmasked launch of its queries against the keys
      up to the span's end (every key on the engine's layout).

    Each row gets exactly the keys the mask gives it."""
    s = q.shape[1]
    end = img_begin + n_img
    span = attention(q[:, img_begin:end], k[:, :end], v[:, :end])
    if end == s:
        head = attention(q[:, :img_begin], k[:, :img_begin], v[:, :img_begin], is_causal=True)
        return torch.cat([head, span], dim=1)
    rows = attention(q, k, v, is_causal=True)
    return torch.cat([rows[:, :img_begin], span, rows[:, end:]], dim=1)


class _HYAttention(nn.Module):
    """Fused-QKV GQA: qkv unpacks per-KV-head ``(groups+2)`` slots; RoPE
    precedes the optional QK norm; the image-span mask on the kernel."""

    def __init__(self, cfg: HunyuanImage3Config, *, dtype):
        super().__init__()
        h, kv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.attention_head_dim
        self.qkv_proj = Linear(cfg.hidden_size, (h + 2 * kv) * hd, use_bias=cfg.attention_bias, dtype=dtype)
        self.o_proj = Linear(h * hd, cfg.hidden_size, use_bias=cfg.attention_bias, dtype=dtype)
        if cfg.use_qk_norm:
            self.query_layernorm = RMSNorm(hd, eps=cfg.rms_norm_eps)
            self.key_layernorm = RMSNorm(hd, eps=cfg.rms_norm_eps)
        else:
            self.query_layernorm = self.key_layernorm = None
        self.heads, self.kv_heads, self.hd = h, kv, hd

    def forward(self, x, cos, sin, img_begin: int, n_img: int):
        b, s, _ = x.shape
        groups = self.heads // self.kv_heads
        qkv = self.qkv_proj(x).reshape(b, s, self.kv_heads, groups + 2, self.hd)
        q = qkv[:, :, :, :groups].reshape(b, s, self.heads, self.hd)
        k = qkv[:, :, :, groups]
        v = qkv[:, :, :, groups + 1]
        q = q * cos[:, :, None, :] + _rotate_half(q) * sin[:, :, None, :]
        k = k * cos[:, :, None, :] + _rotate_half(k) * sin[:, :, None, :]
        if self.query_layernorm is not None:
            q = self.query_layernorm(q).to(x.dtype)
            k = self.key_layernorm(k).to(x.dtype)
        if groups > 1:
            k = k.repeat_interleave(groups, dim=2)
            v = v.repeat_interleave(groups, dim=2)
        out = span_attention(q.to(v.dtype), k.to(v.dtype), v, img_begin, n_img)
        return self.o_proj(out.reshape(b, s, -1))


class _HYLayer(nn.Module):
    def __init__(self, cfg: HunyuanImage3Config, moe: bool, *, dtype):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps)
        self.self_attn = _HYAttention(cfg, dtype=dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps)
        self.mlp = (_HYMoE(cfg, dtype=dtype) if moe
                    else _HYMLP(cfg.hidden_size, cfg.intermediate_size, use_bias=cfg.mlp_bias, dtype=dtype))

    def forward(self, x, cos, sin, img_begin: int, n_img: int):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, img_begin, n_img)
        return x + self.mlp(self.post_attention_layernorm(x))


def _build_2d_rope(seq_len: int, n_elem: int, img_begin: int, gh: int, gw: int,
                   theta_base: float) -> Tuple[np.ndarray, np.ndarray]:
    """cos / sin ``[S, n_elem]`` in float64 on the host: text takes diagonal
    (p, p) positions; the image grid starts at the centred offsets
    ``L + (wh − h)/2``, ``L + (wh − w)/2`` with L = img_begin; trailing text
    resumes at ``L + wh``; theta pairs alternate (y, x); the half-angle
    vector is tiled twice (rotate-half)."""
    assert n_elem % 4 == 0
    L, wh = img_begin, gh * gw
    pre = np.arange(0, L, dtype=np.float64)
    by, bx = L + (wh - gh) / 2.0, L + (wh - gw) / 2.0
    gy, gx = np.meshgrid(np.arange(gh, dtype=np.float64), np.arange(gw, dtype=np.float64), indexing="ij")
    post = np.arange(L + wh, seq_len, dtype=np.float64)
    y = np.concatenate([pre, (gy + by).reshape(-1), post])[:seq_len]
    x = np.concatenate([pre, (gx + bx).reshape(-1), post])[:seq_len]
    theta = 1.0 / (theta_base ** (np.arange(0, n_elem, 2, dtype=np.float64) / n_elem))
    theta = theta.reshape(n_elem // 4, 2)
    pos = np.stack([y, x], axis=-1)
    ang = (pos[:, None, :] * theta[None]).reshape(seq_len, n_elem // 2)
    ang = np.tile(ang, (1, 2))
    return np.cos(ang), np.sin(ang)


@transformer_registry.register("hunyuanimage3.base", aliases=("hunyuanimage3", "HunyuanImage3ForCausalMM"))
class HunyuanImage3ForCausalMM(nn.Module):
    config_class = HunyuanImage3Config

    def __init__(self, cfg: HunyuanImage3Config, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, dtype=dtype))
        self.timestep_emb = _TimestepEmbedder(cfg.hidden_size, dtype=dtype)
        self.time_embed = _TimestepEmbedder(cfg.hidden_size, dtype=dtype)
        self.time_embed_2 = _TimestepEmbedder(cfg.hidden_size, dtype=dtype)
        self.patch_embed = _UNetDown(cfg.patch_size, cfg.img_in_channels, cfg.hidden_size,
                                     cfg.patch_embed_hidden_dim, cfg.hidden_size, dtype=dtype)
        self.final_layer = _UNetUp(cfg.patch_size, cfg.hidden_size, cfg.hidden_size,
                                   cfg.patch_embed_hidden_dim, cfg.img_out_channels, dtype=dtype)
        moe = (cfg.num_experts or 1) > 1
        self.layers = nn.ModuleList([_HYLayer(cfg, moe and i >= cfg.moe_layer_num_skipped, dtype=dtype)
                                     for i in range(cfg.num_hidden_layers)])

    def forward(self, img: torch.Tensor, t: torch.Tensor, input_ids: torch.Tensor,
                img_begin: Optional[int] = None) -> torch.Tensor:
        """img: (B, C, H', W') latents; t: (B,) flow timestep; input_ids:
        (B, L) tokens. With ``img_begin=None`` the sequence is
        ``[ids, <timestep>, <img>×N]``; otherwise the ids hold placeholder
        slots, the image span starts at ``img_begin`` and the timestep token
        sits at ``img_begin - 1``. Returns the velocity at the latent shape
        in f32."""
        cfg = self.cfg
        b, c, hh, ww = img.shape
        gh, gw = hh // cfg.patch_size, ww // cfg.patch_size
        n_img = gh * gw

        t_emb = self.time_embed(t)
        img_tok, th, tw = self.patch_embed(img.to(self.dtype), t_emb)
        ts_tok = self.timestep_emb(t)[:, None]

        embeds = self.wte[input_ids.long()].to(self.dtype)
        if img_begin is None:
            img_begin = int(input_ids.shape[1]) + 1
            seq = torch.cat([embeds, ts_tok.to(self.dtype), img_tok.to(self.dtype)], dim=1)
        else:
            seq = embeds.clone()
            seq[:, img_begin:img_begin + n_img] = img_tok.to(self.dtype)
            seq[:, img_begin - 1:img_begin] = ts_tok.to(self.dtype)
        S = seq.shape[1]

        cos_np, sin_np = _build_2d_rope(S, cfg.attention_head_dim, img_begin, gh, gw, cfg.rope_theta)
        cos = torch.from_numpy(cos_np).float().to(seq.device)[None]
        sin = torch.from_numpy(sin_np).float().to(seq.device)[None]

        for layer in self.layers:
            seq = layer(seq, cos, sin, img_begin, n_img)

        image_hidden = seq[:, img_begin:img_begin + n_img]
        pred = self.final_layer(image_hidden, self.time_embed_2(t), th, tw)
        return pred.float()
