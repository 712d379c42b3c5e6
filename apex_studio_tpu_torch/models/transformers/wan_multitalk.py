"""Wan MultiTalk / InfiniteTalk DiT (multi-person audio-driven i2v), port of
``apex_studio_tpu/models/transformers/wan_multitalk.py``.

The Wan 2.1 i2v backbone (36 input channels, CLIP-vision keys beside the
text in the cross-attention) plus, after every cross-attention, a
**per-frame audio cross-attention**: each latent frame's tokens attend to
that frame's 32 audio context tokens a speaker (``AudioProjModel``: windowed
wav2vec2 states of the first pixel frame and of the four behind each later
latent frame), the frames as the batch, one flash launch.

With two speakers the audio queries are routed by **L-RoPE**: every
self-attention also measures how much of each visual token's attention falls
on each speaker's masked region of the first latent frame
(``ref_attn_maps``); the winning speaker's map places a 1-D rotary position
on the token's audio query (speaker 1 in [0, 4), speaker 2 in [20, 24),
background 12), while each speaker's audio keys sit at its band's centre.

``ref_attn_maps`` is computed in query-row chunks of ``REF_ATTN_ROWS`` over
the first frame's keys; the JAX function builds the whole ``[B, H, M, R]``
f32 score tensor (8.2 GB at 81 frames of 480x832 and 40 heads, in each of the
40 blocks). The softmax runs over R, so each row is whole within a chunk and
the sums are the same. The map is plain PyTorch, as the JAX package computes
it in XLA outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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
from apex_studio_tpu_torch.ops.rope import apply_rope, precompute_axial_freqs

# query rows a chunk of ref_attn_maps: 40 heads x 2048 rows x 1560 keys of f32
# scores are 0.5 GB
REF_ATTN_ROWS = 2048


@dataclasses.dataclass
class WanMultiTalkConfig:
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_attention_heads: int = 40
    attention_head_dim: int = 128
    in_channels: int = 36
    out_channels: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    ffn_dim: int = 13824
    num_layers: int = 40
    cross_attn_norm: bool = True
    eps: float = 1e-6
    image_dim: Optional[int] = 1280
    added_kv_proj_dim: Optional[int] = 1280
    # audio conditioning
    audio_window: int = 5
    vae_scale: int = 4
    audio_blocks: int = 12           # wav2vec2 hidden states stacked
    audio_channels: int = 768
    intermediate_dim: int = 512
    audio_output_dim: int = 768
    context_tokens: int = 32
    norm_output_audio: bool = True
    norm_input_visual: bool = True
    class_range: int = 24
    class_interval: int = 4

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def rope_axes_dims(self) -> Tuple[int, int, int]:
        d = self.attention_head_dim
        h = w = 2 * (d // 6)
        return (d - 2 * h, h, w)

    @classmethod
    def from_dict(cls, cfg: dict) -> "WanMultiTalkConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "patch_size" in kw:
            kw["patch_size"] = tuple(kw["patch_size"])
        return cls(**kw)


class AudioProjModel(nn.Module):
    """Windowed wav2vec2 states → ``context_tokens`` tokens a latent frame,
    f32 throughout."""

    def __init__(self, cfg: WanMultiTalkConfig):
        super().__init__()
        mid = cfg.audio_window // 2
        seq_len_vf = (mid + 1) + (cfg.vae_scale - 2) + (cfg.audio_window - mid)
        per_row = cfg.audio_blocks * cfg.audio_channels
        self.proj1 = Linear(cfg.audio_window * per_row, cfg.intermediate_dim, dtype=torch.float32)
        self.proj1_vf = Linear(seq_len_vf * per_row, cfg.intermediate_dim, dtype=torch.float32)
        self.proj2 = Linear(cfg.intermediate_dim, cfg.intermediate_dim, dtype=torch.float32)
        self.proj3 = Linear(cfg.intermediate_dim, cfg.context_tokens * cfg.audio_output_dim, dtype=torch.float32)
        self.norm = LayerNorm(cfg.audio_output_dim, eps=1e-5) if cfg.norm_output_audio else None
        self.cfg = cfg

    def forward(self, first, latter_windows):
        """first [H, 1, W, blocks, C]; latter [H, F-1, W_vf, blocks, C] →
        [H, F, context_tokens, out_dim]."""
        b = first.shape[0]
        x1 = F.relu(self.proj1(first.reshape(b, 1, -1).float()))
        xf = F.relu(self.proj1_vf(latter_windows.reshape(b, latter_windows.shape[1], -1).float()))
        x = F.relu(self.proj2(torch.cat([x1, xf], dim=1)))
        tok = self.proj3(x).reshape(b, x.shape[1], self.cfg.context_tokens, self.cfg.audio_output_dim)
        return self.norm(tok) if self.norm is not None else tok


def rope_1d_pairs(x: torch.Tensor, positions: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Interleaved-pair 1-D RoPE at float positions [S] over x [B, S, H, D]."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=x.device) / head_dim))
    ang = positions.float()[..., None] * inv
    return apply_rope(x, torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :])


def ref_attn_maps(q: torch.Tensor, k_ref: torch.Tensor, masks: torch.Tensor):
    """Each class's share of every visual token's attention over the masked
    first-frame keys, averaged over heads: q [B, M, H, D], k_ref [B, R, H, D],
    masks [C, R] → [C, M] (batch 0, as in JAX). f32 scores in query-row
    chunks of ``REF_ATTN_ROWS``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    kf = k_ref.float().permute(0, 2, 3, 1)  # [B, H, D, R]
    m = masks.float()
    counts = m.sum(-1).clamp(min=1.0)
    out = []
    for start in range(0, q.shape[1], REF_ATTN_ROWS):
        qf = q[:, start:start + REF_ATTN_ROWS].float().transpose(1, 2) * scale  # [B, H, m, D]
        attn = torch.softmax(qf @ kf, dim=-1)  # [B, H, m, R]
        per_class = torch.einsum("bhmr,cr->cbhm", attn, m) / counts[:, None, None, None]
        out.append(per_class.mean(dim=2)[:, 0])
    return torch.cat(out, dim=1)


class MultiTalkBlock(nn.Module):
    def __init__(self, cfg: WanMultiTalkConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        for name in ("to_q", "to_k", "to_v", "to_out", "c_to_q", "c_to_k", "c_to_v", "c_to_out"):
            setattr(self, name, Linear(d, d, dtype=dtype))
        for name in ("norm_q", "norm_k", "c_norm_q", "c_norm_k"):
            setattr(self, name, RMSNorm(d, eps=cfg.eps))
        if cfg.added_kv_proj_dim is not None:
            self.add_k_proj = Linear(cfg.added_kv_proj_dim, d, dtype=dtype)
            self.add_v_proj = Linear(cfg.added_kv_proj_dim, d, dtype=dtype)
            self.norm_added_k = RMSNorm(d, eps=cfg.eps)
        else:
            self.add_k_proj = self.add_v_proj = self.norm_added_k = None
        if cfg.cross_attn_norm:
            self.norm2_weight = nn.Parameter(torch.ones(d, dtype=torch.float32))
            self.norm2_bias = nn.Parameter(torch.zeros(d, dtype=torch.float32))
        else:
            self.norm2_weight = self.norm2_bias = None
        self.a_q_linear = Linear(d, d, dtype=dtype)
        self.a_kv_linear = Linear(cfg.audio_output_dim, 2 * d, dtype=dtype)
        self.a_proj = Linear(d, d, dtype=dtype)
        if cfg.norm_input_visual:
            self.norm_x_weight = nn.Parameter(torch.ones(d, dtype=torch.float32))
            self.norm_x_bias = nn.Parameter(torch.zeros(d, dtype=torch.float32))
        else:
            self.norm_x_weight = self.norm_x_bias = None
        self.ffn = GELUMLP(d, cfg.ffn_dim, approximate=True, dtype=dtype)
        self.scale_shift_table = nn.Parameter(torch.empty(1, 6, d, dtype=torch.float32))
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim
        self.cfg = cfg

    def _heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.heads, self.head_dim)

    def _audio_attn(self, x, audio_tokens, shape, x_ref_map, human_num):
        """Each latent frame's tokens against its audio tokens ([B, F, n, C_a]),
        L-RoPE-routed with two speakers."""
        cfg = self.cfg
        n_t, n_h, n_w = shape
        b, n, c = x.shape
        s = n_h * n_w
        q = self._heads(self.a_q_linear(x.reshape(b * n_t, s, c)))
        n_tok = audio_tokens.shape[2]
        kv = self.a_kv_linear(audio_tokens.reshape(b * n_t, n_tok, -1).to(x.dtype))
        kv = kv.reshape(b * n_t, n_tok, 2, self.heads, self.head_dim)
        k, v = kv[:, :, 0], kv[:, :, 1]
        if human_num > 1 and x_ref_map is not None:

            def band(m, lo, hi):
                mn, mx = m.min(), m.max()
                return (m - mn) / (mx - mn + 1e-8) * (hi - lo) + lo

            h1 = band(x_ref_map[0], 0.0, cfg.class_interval)
            h2 = band(x_ref_map[1], cfg.class_range - cfg.class_interval, cfg.class_range)
            pos = torch.where(torch.argmax(x_ref_map[:2], dim=0) == 0, h1, h2)
            if x_ref_map.shape[0] > 2:
                pos = torch.where(torch.argmax(x_ref_map, dim=0) == 2,
                                  torch.full_like(h1, cfg.class_range // 2), pos)
            q = rope_1d_pairs(q.reshape(b, n_t * s, self.heads, self.head_dim), pos, self.head_dim)
            q = q.reshape(b * n_t, s, self.heads, self.head_dim)
            per = n_tok // 2
            k_pos = torch.cat([torch.full((per,), (0.0 + cfg.class_interval) / 2.0),
                               torch.full((n_tok - per,), (2 * cfg.class_range - cfg.class_interval) / 2.0)])
            k = rope_1d_pairs(k, k_pos.to(k.device), self.head_dim)
        out = attention_op(q, k.contiguous(), v.contiguous()).reshape(b * n_t, s, c)
        return self.a_proj(out).reshape(b, n, c)

    def forward(self, x, context, context_image, temb6, rope_cos, rope_sin, audio_tokens, shape, ref_masks,
                human_num):
        mods = (self.scale_shift_table + temb6).to(x.dtype)
        sh, sc, g, csh, csc, cg = (mods[:, i:i + 1] for i in range(6))
        n_t, n_h, n_w = shape
        b, n, c = x.shape

        norm_x = layer_norm(x, eps=self.cfg.eps) * (1 + sc) + sh
        q = apply_rope(self._heads(self.norm_q(self.to_q(norm_x))), rope_cos, rope_sin)
        k = apply_rope(self._heads(self.norm_k(self.to_k(norm_x))), rope_cos, rope_sin)
        v = self._heads(self.to_v(norm_x))
        attn = attention_op(q, k, v).reshape(b, n, c)
        x_ref_map = None
        if human_num > 1 and ref_masks is not None:
            x_ref_map = ref_attn_maps(q, k[:, :n_h * n_w], ref_masks)
        del q, k, v
        x = x + self.to_out(attn) * g

        norm_x = (layer_norm(x, self.norm2_weight, self.norm2_bias, self.cfg.eps)
                  if self.norm2_weight is not None else x)
        qc = self._heads(self.c_norm_q(self.c_to_q(norm_x)))
        cross = attention_op(qc, self._heads(self.c_norm_k(self.c_to_k(context))), self._heads(self.c_to_v(context)))
        if context_image is not None and self.add_k_proj is not None:
            ki = self._heads(self.norm_added_k(self.add_k_proj(context_image)))
            cross = cross + attention_op(qc, ki, self._heads(self.add_v_proj(context_image)))
        x = x + self.c_to_out(cross.reshape(b, n, c))

        norm_x = (layer_norm(x, self.norm_x_weight, self.norm_x_bias, self.cfg.eps)
                  if self.norm_x_weight is not None else x)
        x = x + self._audio_attn(norm_x, audio_tokens, shape, x_ref_map, human_num)

        norm_x = layer_norm(x, eps=self.cfg.eps) * (1 + csc) + csh
        return x + self.ffn(norm_x) * cg


@transformer_registry.register("wan.multitalk", aliases=("WanMultiTalkTransformer3DModel", "wan_multitalk"))
class WanMultiTalkTransformer3DModel(nn.Module):
    config_class = WanMultiTalkConfig

    def __init__(self, cfg: WanMultiTalkConfig, *, dtype=torch.bfloat16):
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
        if cfg.image_dim is not None:
            self.img_norm1 = nn.Parameter(torch.ones(cfg.image_dim, dtype=torch.float32))
            self.img_norm1_bias = nn.Parameter(torch.zeros(cfg.image_dim, dtype=torch.float32))
            self.img_ff1 = Linear(cfg.image_dim, cfg.image_dim, dtype=dtype)
            self.img_ff2 = Linear(cfg.image_dim, d, dtype=dtype)
            self.img_norm2 = nn.Parameter(torch.ones(d, dtype=torch.float32))
            self.img_norm2_bias = nn.Parameter(torch.zeros(d, dtype=torch.float32))
        self.audio_proj = AudioProjModel(cfg)
        self.blocks = nn.ModuleList([MultiTalkBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.norm_out_scale_shift = nn.Parameter(torch.empty(1, 2, d, dtype=torch.float32))
        self.proj_out = Linear(d, cfg.out_channels * patch, dtype=dtype)
        self._rope = {}

    def rope_tables(self, t_tok: int, h_tok: int, w_tok: int, device=None):
        key = (t_tok, h_tok, w_tok, str(device))
        if key not in self._rope:
            ids = np.stack(np.meshgrid(np.arange(t_tok), np.arange(h_tok), np.arange(w_tok), indexing="ij"),
                           axis=-1).reshape(1, -1, 3)
            cos, sin = precompute_axial_freqs(ids, self.cfg.rope_axes_dims, 10000.0)
            self._rope = {key: tuple(torch.from_numpy(a[:, :, None, :]).to(device) for a in (cos, sin))}
        return self._rope[key]

    def windowed_audio(self, audio_cond: torch.Tensor):
        """[H, F_pix, W, blocks, C] per-speaker windows → the first pixel
        frame's window and, for each later latent frame, the rows of its
        ``vae_scale`` pixel frames' windows that ``AudioProjModel`` takes."""
        cfg = self.cfg
        mid = cfg.audio_window // 2
        first, latter = audio_cond[:, :1], audio_cond[:, 1:]
        h, f_rest, w, bl, c = latter.shape
        groups = latter.reshape(h, f_rest // cfg.vae_scale, cfg.vae_scale, w, bl, c)
        n = groups.shape[1]
        latter_w = torch.cat([groups[:, :, :1, :mid + 1].reshape(h, n, -1, bl, c),
                              groups[:, :, 1:-1, mid:mid + 1].reshape(h, n, -1, bl, c),
                              groups[:, :, -1:, mid:].reshape(h, n, -1, bl, c)], dim=2)
        return first, latter_w

    def forward(
        self,
        x: torch.Tensor,                                   # [B, C_in, T, H, W] (noise ‖ condition)
        t: torch.Tensor,                                   # [B]
        text: torch.Tensor,                                # [B, L, text_dim]
        image_embeds: Optional[torch.Tensor],              # [B, L_img, image_dim]
        audio_cond: torch.Tensor,                          # [humans, F_pix, W, blocks, C_a]
        ref_target_masks: Optional[torch.Tensor] = None,   # [C, n_h·n_w]
    ) -> torch.Tensor:
        cfg = self.cfg
        b, _, tt, hh, ww = x.shape
        pt, ph, pw = cfg.patch_size
        n_t, n_h, n_w = tt // pt, hh // ph, ww // pw
        human_num = int(audio_cond.shape[0])

        t_freq = timestep_embedding(t.float(), cfg.freq_dim, flip_sin_to_cos=True)
        temb = self.time_embedder_linear_2(F.silu(self.time_embedder_linear_1(t_freq.to(self.dtype))))
        temb6 = self.time_proj(F.silu(temb)).reshape(b, 6, cfg.dim)
        ctx = self.text_embedder_linear_2(F.gelu(self.text_embedder_linear_1(text.to(self.dtype)),
                                                 approximate="tanh"))
        ctx_img = None
        if image_embeds is not None and cfg.image_dim is not None:
            y = layer_norm(image_embeds.to(self.dtype), self.img_norm1, self.img_norm1_bias, 1e-5)
            y = self.img_ff2(F.gelu(self.img_ff1(y)))
            ctx_img = layer_norm(y, self.img_norm2, self.img_norm2_bias, 1e-5)

        # audio tokens a latent frame, the speakers' side by side
        tok = self.audio_proj(*self.windowed_audio(audio_cond))  # [humans, F_lat, n, C_a]
        tok = torch.cat(torch.chunk(tok, human_num, dim=0), dim=2)

        tokens = self.patch_embedding(_patchify(x, cfg.patch_size).to(self.dtype))
        rope_cos, rope_sin = self.rope_tables(n_t, n_h, n_w, device=tokens.device)
        for blk in self.blocks:
            tokens = blk(tokens, ctx, ctx_img, temb6, rope_cos, rope_sin, tok, (n_t, n_h, n_w), ref_target_masks,
                         human_num)

        shift, scale = (self.norm_out_scale_shift + temb.float()[:, None, :]).chunk(2, dim=1)
        out = layer_norm(tokens, eps=cfg.eps) * (1 + scale.to(tokens.dtype)) + shift.to(tokens.dtype)
        out = self.proj_out(out)
        out = out.reshape(b, n_t, n_h, n_w, cfg.out_channels, pt, ph, pw).permute(0, 4, 1, 5, 2, 6, 3, 7)
        return out.reshape(b, cfg.out_channels, tt, hh, ww)
