"""Mochi-1 AsymmDiT, port of ``apex_studio_tpu/models/transformers/mochi.py``
(48 layers, 24 heads of 128, T5 4096 → a 1536-wide text stream by default).

- video stream at ``dim = heads·head_dim`` (3072), text stream at
  ``pooled_projection_dim`` (1536); the joint attention projects the text
  into the video width (``add_q/k/v_proj``) and back (``to_add_out``); the
  last block drops the text update
- conditioning: sinusoidal timestep embedding plus an attention-pooled
  caption embedding (one query over ``[mean | text]``, the padded text keys
  masked by a key bias), summed into one ``temb``
- scale-only modulation: silu(temb) → (scale_attn, gate_attn, scale_mlp,
  gate_mlp), residuals gated by tanh(gate)·rms(out), param-free RMS norms
- per-head learned-frequency 3D RoPE over (t, y, x) token coordinates, the
  spatial ones bin centres rescaled to a 192² token area; interleaved pairs
  rotated in f32
- the joint attention is ONE unmasked kernel launch over
  ``[video | text]``: the padded text keys are attended as JAX attends them
- FFN: SwiGLU with inner width (4·d·2)//3 per stream; final: LayerNorm with
  (scale, shift) from temb → projection to p²·out_channels
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear, TimestepEmbedder
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.ops.attention import attention
from apex_studio_tpu_torch.ops.norms import layer_norm, rms_norm


@dataclasses.dataclass
class MochiConfig:
    patch_size: int = 2
    num_attention_heads: int = 24
    attention_head_dim: int = 128
    num_layers: int = 48
    in_channels: int = 12
    out_channels: int = 12
    text_embed_dim: int = 4096
    pooled_projection_dim: int = 1536
    time_embed_dim: int = 256
    ff_mult: int = 4  # nominal; actual inner = (mult·dim·2)//3 (LLaMA-style)

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def from_dict(cls, cfg: dict) -> "MochiConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in known})


class MochiSwiGLU(nn.Module):
    def __init__(self, dim: int, inner: int, *, dtype):
        super().__init__()
        self.proj_in = Linear(dim, 2 * inner, use_bias=False, dtype=dtype)
        self.proj_out = Linear(inner, dim, use_bias=False, dtype=dtype)

    def forward(self, x):
        a, g = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(a * F.silu(g))


class MochiAttentionPool(nn.Module):
    """Masked attention pooling of the text features → conditioning vector."""

    def __init__(self, text_dim: int, out_dim: int, heads: int = 8, *, dtype):
        super().__init__()
        self.to_q = Linear(text_dim, text_dim, dtype=dtype)
        self.to_kv = Linear(text_dim, 2 * text_dim, dtype=dtype)
        self.to_out = Linear(text_dim, out_dim, dtype=dtype)
        self.heads = heads
        self.head_dim = text_dim // heads

    def forward(self, txt, mask):
        b, n, d = txt.shape
        mask = mask.float()
        mean = (txt * mask[..., None]).sum(dim=1, keepdim=True) / mask.sum(dim=1, keepdim=True)[..., None].clamp_min(
            1.0)
        q = self.to_q(mean).reshape(b, 1, self.heads, self.head_dim)
        # to_kv packs [k(D) | v(D)] as two D-sized halves, not per-head pairs
        k, v = self.to_kv(torch.cat([mean.to(txt.dtype), txt], dim=1)).chunk(2, dim=-1)
        k = k.reshape(b, n + 1, self.heads, self.head_dim)
        v = v.reshape(b, n + 1, self.heads, self.head_dim)
        keep = torch.cat([torch.ones_like(mask[:, :1]), mask], dim=1).bool()
        bias = torch.where(keep, torch.zeros((), device=keep.device), torch.full((), -1e9, device=keep.device))
        out = attention(q, k, v, bias=bias[:, None, None, :])
        return self.to_out(out.reshape(b, d))


class MochiRoPE(nn.Module):
    """Per-head learned-frequency 3D RoPE over centred (t, y, x) coordinates."""

    # spatial positions are bin CENTRES of a grid rescaled to the 192x192
    # token target area: the learned pos_frequencies were trained on them
    TARGET_AREA = 192 * 192

    def __init__(self, heads: int, head_dim: int):
        super().__init__()
        self.pos_frequencies = nn.Parameter(torch.empty(3, heads, head_dim // 2, dtype=torch.float32))

    def tables(self, t: int, h: int, w: int):
        scale = (self.TARGET_AREA / (h * w)) ** 0.5

        def centers(num):
            return scale * (np.arange(num, dtype=np.float64) + 0.5 - num / 2.0)

        ids = np.stack(np.meshgrid(np.arange(t, dtype=np.float64), centers(h), centers(w), indexing="ij"),
                       axis=-1).reshape(-1, 3).astype(np.float32)
        freqs = self.pos_frequencies.float()
        angles = torch.einsum("nd,dhf->nhf", torch.from_numpy(ids).to(freqs.device), freqs)
        return torch.cos(angles), torch.sin(angles)  # [N, H, D/2]


def _rope_rotate(x, cos, sin):
    # x [B, N, H, D]; cos / sin [N, H, D/2]; interleaved pairs, in f32
    x32 = x.float()
    xr, xi = x32[..., 0::2], x32[..., 1::2]
    return torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1).reshape(x.shape).to(x.dtype)


class MochiJointAttention(nn.Module):
    def __init__(self, cfg: MochiConfig, last: bool, *, dtype):
        super().__init__()
        d, td = cfg.dim, cfg.pooled_projection_dim
        self.to_q = Linear(d, d, use_bias=False, dtype=dtype)
        self.to_k = Linear(d, d, use_bias=False, dtype=dtype)
        self.to_v = Linear(d, d, use_bias=False, dtype=dtype)
        self.add_q_proj = Linear(td, d, use_bias=False, dtype=dtype)
        self.add_k_proj = Linear(td, d, use_bias=False, dtype=dtype)
        self.add_v_proj = Linear(td, d, use_bias=False, dtype=dtype)
        self.to_out = Linear(d, d, dtype=dtype)
        self.to_add_out = None if last else Linear(d, td, dtype=dtype)
        hd = cfg.attention_head_dim
        self.norm_q = nn.Parameter(torch.ones(hd, dtype=torch.float32))
        self.norm_k = nn.Parameter(torch.ones(hd, dtype=torch.float32))
        self.norm_added_q = nn.Parameter(torch.ones(hd, dtype=torch.float32))
        self.norm_added_k = nn.Parameter(torch.ones(hd, dtype=torch.float32))
        self.heads = cfg.num_attention_heads
        self.head_dim = hd

    def forward(self, vid, txt, cos, sin):
        b, nv, _ = vid.shape
        nt = txt.shape[1]

        def split(x, n):
            return x.reshape(b, n, self.heads, self.head_dim)

        q = _rope_rotate(rms_norm(split(self.to_q(vid), nv), self.norm_q), cos, sin)
        k = _rope_rotate(rms_norm(split(self.to_k(vid), nv), self.norm_k), cos, sin)
        v = split(self.to_v(vid), nv)
        tq = rms_norm(split(self.add_q_proj(txt), nt), self.norm_added_q)
        tk = rms_norm(split(self.add_k_proj(txt), nt), self.norm_added_k)
        tv = split(self.add_v_proj(txt), nt)
        # one launch over [video | text], no mask over the padded text keys (as JAX)
        out = attention(torch.cat([q, tq], dim=1), torch.cat([k, tk], dim=1),
                        torch.cat([v, tv], dim=1)).reshape(b, nv + nt, -1)
        vid_out = self.to_out(out[:, :nv])
        txt_out = self.to_add_out(out[:, nv:]) if self.to_add_out is not None else None
        return vid_out, txt_out


class MochiBlock(nn.Module):
    def __init__(self, cfg: MochiConfig, last: bool, *, dtype):
        super().__init__()
        d, td = cfg.dim, cfg.pooled_projection_dim
        self.mod_x = Linear(d, 4 * d, dtype=dtype)
        self.mod_y = Linear(d, (1 if last else 4) * td, dtype=dtype)
        self.attn = MochiJointAttention(cfg, last, dtype=dtype)
        self.ff_x = MochiSwiGLU(d, (cfg.ff_mult * d * 2) // 3, dtype=dtype)
        self.ff_y = None if last else MochiSwiGLU(td, (cfg.ff_mult * td * 2) // 3, dtype=dtype)
        self.last = last

    def forward(self, vid, txt, temb, cos, sin):
        sa_x, ga_x, sm_x, gm_x = self.mod_x(F.silu(temb))[:, None, :].chunk(4, dim=-1)
        mods_y = self.mod_y(F.silu(temb))[:, None, :]
        if self.last:
            sa_y, ga_y, sm_y, gm_y = mods_y, None, None, None
        else:
            sa_y, ga_y, sm_y, gm_y = mods_y.chunk(4, dim=-1)
        # the block norms take eps 1e-6; the attention's qk norms 1e-5
        a_v, a_t = self.attn(rms_norm(vid, eps=1e-6) * (1 + sa_x), rms_norm(txt, eps=1e-6) * (1 + sa_y), cos, sin)
        vid = vid + torch.tanh(ga_x) * rms_norm(a_v, eps=1e-6)
        if a_t is not None:
            txt = txt + torch.tanh(ga_y) * rms_norm(a_t, eps=1e-6)
        vid = vid + torch.tanh(gm_x) * rms_norm(self.ff_x(rms_norm(vid, eps=1e-6) * (1 + sm_x)), eps=1e-6)
        if self.ff_y is not None:
            txt = txt + torch.tanh(gm_y) * rms_norm(self.ff_y(rms_norm(txt, eps=1e-6) * (1 + sm_y)), eps=1e-6)
        return vid, txt


@transformer_registry.register("mochi.base", aliases=("mochi", "MochiTransformer3DModel"))
class MochiTransformer3DModel(nn.Module):
    config_class = MochiConfig

    def __init__(self, cfg: MochiConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        p = cfg.patch_size
        self.patch_proj = Linear(cfg.in_channels * p * p, cfg.dim, dtype=dtype)
        self.time_embed = TimestepEmbedder(cfg.dim, freq_size=cfg.time_embed_dim, dtype=dtype)
        self.pooler = MochiAttentionPool(cfg.text_embed_dim, cfg.dim, dtype=dtype)
        self.caption_proj = Linear(cfg.text_embed_dim, cfg.pooled_projection_dim, dtype=dtype)
        self.rope = MochiRoPE(cfg.num_attention_heads, cfg.attention_head_dim)
        self.blocks = nn.ModuleList([MochiBlock(cfg, last=i == cfg.num_layers - 1, dtype=dtype)
                                     for i in range(cfg.num_layers)])
        # AdaLayerNormContinuous: linear(silu(temb)) → (scale, shift), scale first
        self.norm_out_linear = Linear(cfg.dim, 2 * cfg.dim, dtype=dtype)
        self.proj_out = Linear(cfg.dim, p * p * cfg.out_channels, dtype=dtype)

    def pack_latents(self, x: torch.Tensor) -> torch.Tensor:
        p = self.cfg.patch_size
        b, c, t, h, w = x.shape
        x = x.reshape(b, c, t, h // p, p, w // p, p)
        return x.permute(0, 2, 3, 5, 1, 4, 6).reshape(b, t * (h // p) * (w // p), c * p * p)

    def unpack_latents(self, tokens: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
        """proj_out features are ordered [p1, p2, C], channel fastest; the
        input side stays conv-ordered [C, p, p]."""
        p = self.cfg.patch_size
        b, n, d = tokens.shape
        x = tokens.reshape(b, t, h // p, w // p, p, p, d // (p * p))
        return x.permute(0, 6, 1, 2, 4, 3, 5).reshape(b, -1, t, h, w)

    def forward(self, hidden_states: torch.Tensor, timestep: torch.Tensor, encoder_hidden_states: torch.Tensor,
                encoder_attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """hidden_states [B, C, T, H, W], timestep [B] in [0, 1000), the text
        [B, N_txt, text_embed_dim] and its mask [B, N_txt] → [B, C, T, H, W]."""
        b, c, t, h, w = hidden_states.shape
        p = self.cfg.patch_size
        if encoder_attention_mask is None:
            encoder_attention_mask = torch.ones(encoder_hidden_states.shape[:2], device=encoder_hidden_states.device)
        text = encoder_hidden_states.to(self.dtype)
        temb = self.time_embed(timestep.float()) + self.pooler(text, encoder_attention_mask)
        vid = self.patch_proj(self.pack_latents(hidden_states).to(self.dtype))
        txt = self.caption_proj(text)
        cos, sin = self.rope.tables(t, h // p, w // p)
        for blk in self.blocks:
            vid, txt = blk(vid, txt, temb, cos, sin)
        scale, shift = self.norm_out_linear(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        vid = layer_norm(vid, eps=1e-6) * (1 + scale) + shift
        return self.unpack_latents(self.proj_out(vid), t, h, w)
