"""Wan SCAIL DiT (pose-driven character video), port of
``apex_studio_tpu/models/transformers/wan_scail.py``: one self-attention
sequence over three token streams,

- the reference image's latents (one frame, RoPE t = 0, all-ones mask
  channels),
- the noisy video's latents (RoPE t from 1 + ``rope_t_shift``, all-zeros
  mask channels),
- the pose video's latents at half resolution through their own patch
  embedding, their h / w RoPE tables the pairwise averages of the full
  resolution's cos and sin from ``pose_rope_shift`` on (the t table as the
  video's);

and a cross-attention that splits its context into the projected CLIP
tokens (their own ``k_img`` / ``v_img``, 257 keys) and the text (512 keys):
two flash launches over one set of queries, summed. RoPE tables come from
float64 numpy, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import GELUMLP, LayerNorm, Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.models.transformers.wan import _patchify
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import apply_rope


@dataclasses.dataclass
class WanScailConfig:
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    in_dim: int = 20  # 16 latent + 4 mask channels
    dim: int = 5120
    ffn_dim: int = 13824
    freq_dim: int = 256
    text_dim: int = 4096
    text_len: int = 512
    out_dim: int = 16
    num_heads: int = 40
    num_layers: int = 40
    cross_attn_norm: bool = True
    eps: float = 1e-6
    image_dim: int = 1280
    pose_rope_shift: Tuple[int, int, int] = (0, 512, 512)

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def rope_axes_dims(self) -> Tuple[int, int, int]:
        d = self.head_dim
        h = w = 2 * (d // 6)
        return (d - 2 * h, h, w)

    @classmethod
    def from_dict(cls, cfg: dict) -> "WanScailConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        for key in ("patch_size", "pose_rope_shift"):
            if key in kw:
                kw[key] = tuple(kw[key])
        return cls(**kw)


class ScailBlock(nn.Module):
    def __init__(self, cfg: WanScailConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        for name in ("to_q", "to_k", "to_v", "to_o", "c_to_q", "c_to_k", "c_to_v", "c_to_o", "k_img", "v_img"):
            setattr(self, name, Linear(d, d, dtype=dtype))
        for name in ("norm_q", "norm_k", "c_norm_q", "c_norm_k", "norm_k_img"):
            setattr(self, name, RMSNorm(d, eps=cfg.eps))
        if cfg.cross_attn_norm:
            self.norm3_weight = nn.Parameter(torch.ones(d, dtype=torch.float32))
            self.norm3_bias = nn.Parameter(torch.zeros(d, dtype=torch.float32))
        else:
            self.norm3_weight = self.norm3_bias = None
        self.ffn = GELUMLP(d, cfg.ffn_dim, approximate=True, dtype=dtype)
        self.modulation = nn.Parameter(torch.empty(1, 6, d, dtype=torch.float32))
        self.heads, self.head_dim, self.eps = cfg.num_heads, cfg.head_dim, cfg.eps

    def _heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.heads, self.head_dim)

    def forward(self, x, e6, context, n_clip, rope_cos, rope_sin):
        mods = (self.modulation + e6).to(x.dtype)
        sh, sc, g = mods[:, 0:1], mods[:, 1:2], mods[:, 2:3]
        fsh, fsc, fg = mods[:, 3:4], mods[:, 4:5], mods[:, 5:6]
        b, s, c = x.shape

        norm_x = layer_norm(x, eps=self.eps) * (1 + sc) + sh
        q = apply_rope(self._heads(self.norm_q(self.to_q(norm_x))), rope_cos, rope_sin)
        k = apply_rope(self._heads(self.norm_k(self.to_k(norm_x))), rope_cos, rope_sin)
        v = self._heads(self.to_v(norm_x))
        x = x + self.to_o(attention_op(q, k, v).reshape(b, s, c)) * g

        norm_x = (layer_norm(x, self.norm3_weight, self.norm3_bias, self.eps)
                  if self.norm3_weight is not None else x)
        # the i2v cross-attention: the CLIP tokens carry their own keys and values
        ctx_img, ctx_txt = context[:, :n_clip], context[:, n_clip:]
        qc = self._heads(self.c_norm_q(self.c_to_q(norm_x)))
        out = attention_op(qc, self._heads(self.c_norm_k(self.c_to_k(ctx_txt))), self._heads(self.c_to_v(ctx_txt)))
        out = out + attention_op(qc, self._heads(self.norm_k_img(self.k_img(ctx_img))),
                                 self._heads(self.v_img(ctx_img)))
        x = x + self.c_to_o(out.reshape(b, s, c))

        norm_x = layer_norm(x, eps=self.eps) * (1 + fsc) + fsh
        return x + self.ffn(norm_x) * fg


def _seg_tables(axes_dims, t_pos, h_pos, w_pos, downsample_hw=False):
    """cos / sin [f·h·w, head_dim/2] for one stream; with ``downsample_hw``
    the h / w tables average consecutive pairs of positions."""
    dt, dh, dw = axes_dims

    def table(pos, dim, avg):
        inv = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        ang = np.asarray(pos, np.float64)[:, None] * inv
        c, s = np.cos(ang), np.sin(ang)
        if avg:
            c, s = 0.5 * (c[0::2] + c[1::2]), 0.5 * (s[0::2] + s[1::2])
        return c.astype(np.float32), s.astype(np.float32)

    tabs = [table(t_pos, dt, False), table(h_pos, dh, downsample_hw), table(w_pos, dw, downsample_hw)]
    f, h, w = (len(c) for c, _ in tabs)

    def grid(i):
        return [np.broadcast_to(tabs[0][i][:, None, None], (f, h, w, tabs[0][i].shape[-1])),
                np.broadcast_to(tabs[1][i][None, :, None], (f, h, w, tabs[1][i].shape[-1])),
                np.broadcast_to(tabs[2][i][None, None, :], (f, h, w, tabs[2][i].shape[-1]))]

    return (np.concatenate(grid(0), axis=-1).reshape(f * h * w, -1),
            np.concatenate(grid(1), axis=-1).reshape(f * h * w, -1))


@transformer_registry.register("wan.scail", aliases=("SCAILModel", "wan_scail"))
class SCAILModel(nn.Module):
    config_class = WanScailConfig

    def __init__(self, cfg: WanScailConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        patch = int(np.prod(cfg.patch_size))
        self.patch_embedding = Linear(cfg.in_dim * patch, d, dtype=dtype)
        self.patch_embedding_pose = Linear(cfg.in_dim * patch, d, dtype=dtype)
        self.text_embedding_1 = Linear(cfg.text_dim, d, dtype=dtype)
        self.text_embedding_2 = Linear(d, d, dtype=dtype)
        self.time_embedding_1 = Linear(cfg.freq_dim, d, dtype=dtype)
        self.time_embedding_2 = Linear(d, d, dtype=dtype)
        self.time_projection = Linear(d, 6 * d, dtype=dtype)
        self.img_norm_in = LayerNorm(cfg.image_dim, eps=1e-5)
        self.img_linear_1 = Linear(cfg.image_dim, cfg.image_dim, dtype=dtype)
        self.img_linear_2 = Linear(cfg.image_dim, d, dtype=dtype)
        self.img_norm_out = LayerNorm(d, eps=1e-5)
        self.blocks = nn.ModuleList([ScailBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.head_norm_mod = nn.Parameter(torch.empty(1, 2, d, dtype=torch.float32))
        self.head = Linear(d, cfg.out_dim * patch, dtype=dtype)
        self._tables = {}

    def rope_tables(self, n_t, n_h, n_w, t_shift: int = 0, device=None):
        """(cos, sin) [1, S, 1, head_dim/2] over [reference | video | pose]."""
        key = (n_t, n_h, n_w, t_shift, str(device))
        if key not in self._tables:
            axes, gs = self.cfg.rope_axes_dims, self.cfg.pose_rope_shift
            times = np.arange(1 + t_shift, 1 + t_shift + n_t)
            segs = [_seg_tables(axes, [0], np.arange(n_h), np.arange(n_w)),
                    _seg_tables(axes, times, np.arange(n_h), np.arange(n_w)),
                    _seg_tables(axes, times, np.arange(gs[1], gs[1] + n_h), np.arange(gs[2], gs[2] + n_w),
                                downsample_hw=True)]
            self._tables[key] = tuple(torch.from_numpy(np.concatenate([seg[i] for seg in segs]))[None, :, None, :]
                                      .to(device) for i in (0, 1))
        return self._tables[key]

    def forward(
        self,
        x: torch.Tensor,                  # [B, 16, T, H, W] noisy latents
        t: torch.Tensor,                  # [B]
        context: torch.Tensor,            # [B, L, text_dim]
        pose_latents: torch.Tensor,       # [B, 16, T, H/2, W/2]
        reference_latents: torch.Tensor,  # [B, 16, 1, H, W]
        clip_embeds: torch.Tensor,        # [B, 257, image_dim]
        rope_t_shift: int = 0,
    ) -> torch.Tensor:
        cfg = self.cfg
        b, _, tt, hh, ww = x.shape
        pt, ph, pw = cfg.patch_size
        n_t, n_h, n_w = tt // pt, hh // ph, ww // pw

        def with_mask(v, fill):
            mask = torch.full((v.shape[0], cfg.in_dim - v.shape[1], *v.shape[2:]), fill, dtype=v.dtype,
                              device=v.device)
            return _patchify(torch.cat([v, mask], dim=1), cfg.patch_size).to(self.dtype)

        ref_tok = self.patch_embedding(with_mask(reference_latents, 1.0))
        vid_tok = self.patch_embedding(with_mask(x, 0.0))
        pose_tok = self.patch_embedding_pose(with_mask(pose_latents, 1.0))
        n_ref, n_vid = ref_tok.shape[1], vid_tok.shape[1]
        seq = torch.cat([ref_tok, vid_tok, pose_tok], dim=1)

        freq = timestep_embedding(t.float(), cfg.freq_dim, flip_sin_to_cos=True)
        e = self.time_embedding_2(F.silu(self.time_embedding_1(freq.to(self.dtype)))).float()
        e6 = self.time_projection(F.silu(e.to(self.dtype))).reshape(b, 6, cfg.dim).float()

        L = context.shape[1]  # the text padded or cut to text_len
        context = (F.pad(context, (0, 0, 0, cfg.text_len - L)) if L < cfg.text_len else context[:, :cfg.text_len])
        ctx = self.text_embedding_2(F.gelu(self.text_embedding_1(context.to(self.dtype)), approximate="tanh"))
        y = self.img_norm_in(clip_embeds.to(self.dtype))
        ctx_clip = self.img_norm_out(self.img_linear_2(F.gelu(self.img_linear_1(y))))
        full_ctx = torch.cat([ctx_clip, ctx], dim=1)

        rope_cos, rope_sin = self.rope_tables(n_t, n_h, n_w, rope_t_shift, device=seq.device)
        for blk in self.blocks:
            seq = blk(seq, e6, full_ctx, ctx_clip.shape[1], rope_cos, rope_sin)

        vid = seq[:, n_ref:n_ref + n_vid]
        mods = self.head_norm_mod + e[:, None, :]
        shift, scale = mods[:, 0:1], mods[:, 1:2]
        out = (layer_norm(vid.float(), eps=cfg.eps) * (1 + scale) + shift).to(self.dtype)
        out = self.head(out).reshape(b, n_t, n_h, n_w, cfg.out_dim, pt, ph, pw)
        return out.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, cfg.out_dim, tt, hh, ww)
