"""Wan HuMo DiT (human video from text, audio and reference images), port of
``apex_studio_tpu/models/transformers/wan_humo.py``.

The Wan t2v backbone (dim 5120, 40 blocks, 40 heads of 128) whose every
block adds a **per-frame audio cross-attention** between the text
cross-attention and the FFN:

- ``HuMoAudioProj`` maps each latent frame's window of stacked wav2vec2
  hidden states (8 rows × 13 states × 768) through three Linears (ReLU) to 16
  audio tokens of 1536, layer-normed; f32 throughout;
- in each block the video tokens of latent frame f attend only to frame f's
  16 audio tokens: queries ``[B·F, H·W, heads, 128]`` against keys
  ``[B·F_a, 16, heads, 128]``, one batched launch, truncated to the shorter
  of the two and zero-filled past the audio;
- the reference latents and the 4-channel mask come in as ``y`` on the
  channels (16 noise + 4 mask + 16 condition = 36);
- the modulation is the learned table plus the time projection, in f32; the
  self-attention's q/k RMS norm runs across heads, with 3-axis RoPE
  (θ = 10000) as Wan's; the head is Wan's, channel fastest.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class WanHuMoConfig:
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    in_dim: int = 36                    # 16 noise + 4 mask + 16 cond latents
    dim: int = 5120
    ffn_dim: int = 13824
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 40
    num_layers: int = 40
    cross_attn_norm: bool = True
    eps: float = 1e-6
    insert_audio: bool = True
    audio_token_num: int = 16
    audio_kv_dim: int = 1536
    audio_window: int = 8               # rows per latent-frame window
    audio_blocks: int = 13              # wav2vec2 hidden states stacked
    audio_channels: int = 768
    audio_intermediate_dim: int = 512

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def rope_axes_dims(self) -> Tuple[int, int, int]:
        d = self.head_dim
        h = w = 2 * (d // 6)
        return (d - 2 * h, h, w)

    @classmethod
    def from_dict(cls, cfg: dict) -> "WanHuMoConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "patch_size" in kw:
            kw["patch_size"] = tuple(kw["patch_size"])
        return cls(**kw)


class HuMoAudioProj(nn.Module):
    """[B, F, window, blocks, C] wav2vec2 windows → [B, F, 16, kv_dim]."""

    def __init__(self, cfg: WanHuMoConfig):
        super().__init__()
        in_dim = cfg.audio_window * cfg.audio_blocks * cfg.audio_channels
        self.glob_1 = Linear(in_dim, cfg.audio_intermediate_dim, dtype=torch.float32)
        self.glob_2 = Linear(cfg.audio_intermediate_dim, cfg.audio_intermediate_dim, dtype=torch.float32)
        self.glob_3 = Linear(cfg.audio_intermediate_dim, cfg.audio_token_num * cfg.audio_kv_dim,
                             dtype=torch.float32)
        self.glob_norm = LayerNorm(cfg.audio_kv_dim, eps=1e-5)
        self.cfg = cfg

    def forward(self, windows):
        b, f = windows.shape[:2]
        x = F.relu(self.glob_1(windows.reshape(b * f, -1).float()))
        x = F.relu(self.glob_2(x))
        return self.glob_norm(self.glob_3(x).reshape(b, f, self.cfg.audio_token_num, self.cfg.audio_kv_dim))


class HuMoBlock(nn.Module):
    def __init__(self, cfg: WanHuMoConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        for prefix in ("", "c_"):
            for name in ("to_q", "to_k", "to_v", "to_o"):
                setattr(self, prefix + name, Linear(d, d, dtype=dtype))
            setattr(self, prefix + "norm_q", RMSNorm(d, eps=cfg.eps))
            setattr(self, prefix + "norm_k", RMSNorm(d, eps=cfg.eps))
        if cfg.cross_attn_norm:
            self.norm3_weight = nn.Parameter(torch.ones(d, dtype=torch.float32))
            self.norm3_bias = nn.Parameter(torch.zeros(d, dtype=torch.float32))
        else:
            self.norm3_weight = self.norm3_bias = None
        if cfg.insert_audio:
            self.a_to_q = Linear(d, d, dtype=dtype)
            self.a_to_k = Linear(cfg.audio_kv_dim, d, dtype=dtype)
            self.a_to_v = Linear(cfg.audio_kv_dim, d, dtype=dtype)
            self.a_to_o = Linear(d, d, dtype=dtype)
            self.a_norm_q = RMSNorm(d, eps=cfg.eps)
            self.a_norm_k = RMSNorm(d, eps=cfg.eps)
            self.norm1_audio_weight = nn.Parameter(torch.ones(d, dtype=torch.float32))
            self.norm1_audio_bias = nn.Parameter(torch.zeros(d, dtype=torch.float32))
        else:
            self.a_to_q = None
        self.ffn = GELUMLP(d, cfg.ffn_dim, approximate=True, dtype=dtype)
        self.modulation = nn.Parameter(torch.empty(1, 6, d, dtype=torch.float32))
        self.heads = cfg.num_heads
        self.head_dim = cfg.head_dim
        self.eps = cfg.eps

    def _heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.heads, self.head_dim)

    def _audio_attn(self, x, audio_tokens, n_frames: int):
        """Each latent frame's tokens against that frame's audio tokens."""
        b, s, c = x.shape
        hw = s // n_frames
        xq = layer_norm(x, self.norm1_audio_weight, self.norm1_audio_bias, self.eps)
        q = self.a_norm_q(self.a_to_q(xq)).reshape(b * n_frames, hw, self.heads, self.head_dim)
        f_a, n_tok = audio_tokens.shape[1], audio_tokens.shape[2]
        a = audio_tokens.reshape(b * f_a, n_tok, -1).to(x.dtype)
        k = self.a_norm_k(self.a_to_k(a)).reshape(b * f_a, n_tok, self.heads, self.head_dim)
        v = self.a_to_v(a).reshape(b * f_a, n_tok, self.heads, self.head_dim)
        n = min(q.shape[0], k.shape[0])  # the longer side is truncated
        out = attention_op(q[:n], k[:n], v[:n]).reshape(b, -1, c)
        if out.shape[1] < s:  # audio shorter than the video: the tail gets zeros
            out = torch.cat([out, out.new_zeros(b, s - out.shape[1], c)], dim=1)
        return self.a_to_o(out)

    def forward(self, x, e6, context, audio_tokens, n_frames, rope_cos, rope_sin):
        mods = (self.modulation + e6).float()
        sh, sc, g = mods[:, 0:1], mods[:, 1:2], mods[:, 2:3]
        fsh, fsc, fg = mods[:, 3:4], mods[:, 4:5], mods[:, 5:6]
        b, s, c = x.shape

        norm_x = (layer_norm(x.float(), eps=self.eps) * (1 + sc) + sh).to(x.dtype)
        q = apply_rope(self._heads(self.norm_q(self.to_q(norm_x))), rope_cos, rope_sin)
        k = apply_rope(self._heads(self.norm_k(self.to_k(norm_x))), rope_cos, rope_sin)
        v = self._heads(self.to_v(norm_x))
        attn = self.to_o(attention_op(q, k, v).reshape(b, s, c))
        x = (x.float() + attn.float() * g).to(x.dtype)

        norm_x = layer_norm(x, self.norm3_weight, self.norm3_bias, self.eps) if self.norm3_weight is not None else x
        qc = self._heads(self.c_norm_q(self.c_to_q(norm_x)))
        kc = self._heads(self.c_norm_k(self.c_to_k(context)))
        vc = self._heads(self.c_to_v(context))
        x = x + self.c_to_o(attention_op(qc, kc, vc).reshape(b, s, c))

        if self.a_to_q is not None and audio_tokens is not None:
            x = x + self._audio_attn(x, audio_tokens, n_frames)

        norm_x = (layer_norm(x.float(), eps=self.eps) * (1 + fsc) + fsh).to(x.dtype)
        return (x.float() + self.ffn(norm_x).float() * fg).to(x.dtype)


@transformer_registry.register("wan.humo", aliases=("HumoWanTransformerModel", "wan_humo"))
class HumoWanTransformerModel(nn.Module):
    config_class = WanHuMoConfig

    def __init__(self, cfg: WanHuMoConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        patch = int(np.prod(cfg.patch_size))
        self.patch_embedding = Linear(cfg.in_dim * patch, d, dtype=dtype)
        self.text_embedding_1 = Linear(cfg.text_dim, d, dtype=dtype)
        self.text_embedding_2 = Linear(d, d, dtype=dtype)
        self.time_embedding_1 = Linear(cfg.freq_dim, d, dtype=dtype)
        self.time_embedding_2 = Linear(d, d, dtype=dtype)
        self.time_projection = Linear(d, 6 * d, dtype=dtype)
        self.audio_proj = HuMoAudioProj(cfg) if cfg.insert_audio else None
        self.blocks = nn.ModuleList([HuMoBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.head_norm_mod = nn.Parameter(torch.empty(1, 2, d, dtype=torch.float32))
        self.head = Linear(d, cfg.out_dim * patch, dtype=dtype)
        self._tables = {}

    def rope_tables(self, t_tok: int, h_tok: int, w_tok: int, device=None):
        key = (t_tok, h_tok, w_tok, str(device))
        if key not in self._tables:
            ids = np.stack(np.meshgrid(np.arange(t_tok), np.arange(h_tok), np.arange(w_tok), indexing="ij"),
                           axis=-1).reshape(1, -1, 3)
            cos, sin = precompute_axial_freqs(ids, self.cfg.rope_axes_dims, 10000.0)
            self._tables = {key: tuple(torch.from_numpy(a[:, :, None, :]).to(device) for a in (cos, sin))}
        return self._tables[key]

    def forward(
        self,
        x: torch.Tensor,                                # [B, 16, T, H, W] noisy latents
        t: torch.Tensor,                                # [B]
        context: torch.Tensor,                          # [B, L, text_dim]
        audio_windows: Optional[torch.Tensor] = None,   # [B, F, window, blocks, C]
        y: Optional[torch.Tensor] = None,               # [B, 20, T, H, W] mask + condition
    ) -> torch.Tensor:
        cfg = self.cfg
        if y is not None:
            x = torch.cat([x, y.to(x.dtype)], dim=1)
        b, _, tt, hh, ww = x.shape
        pt, ph, pw = cfg.patch_size
        n_t, n_h, n_w = tt // pt, hh // ph, ww // pw

        freq = timestep_embedding(t.float(), cfg.freq_dim, flip_sin_to_cos=True)
        e = self.time_embedding_2(F.silu(self.time_embedding_1(freq.to(self.dtype)))).float()
        e6 = self.time_projection(F.silu(e.to(self.dtype))).reshape(b, 6, cfg.dim).float()
        ctx = self.text_embedding_2(F.gelu(self.text_embedding_1(context.to(self.dtype)), approximate="tanh"))

        audio_tokens = None
        if self.audio_proj is not None and audio_windows is not None:
            audio_tokens = self.audio_proj(audio_windows)

        tokens = self.patch_embedding(_patchify(x, cfg.patch_size).to(self.dtype))
        rope_cos, rope_sin = self.rope_tables(n_t, n_h, n_w, device=tokens.device)
        for blk in self.blocks:
            tokens = blk(tokens, e6, ctx, audio_tokens, n_t, rope_cos, rope_sin)

        mods = (self.head_norm_mod + e[:, None, :]).float()
        shift, scale = mods[:, 0:1], mods[:, 1:2]
        out = self.head((layer_norm(tokens.float(), eps=cfg.eps) * (1 + scale) + shift).to(self.dtype))
        out = out.reshape(b, n_t, n_h, n_w, cfg.out_dim, pt, ph, pw).permute(0, 4, 1, 5, 2, 6, 3, 7)
        return out.reshape(b, cfg.out_dim, tt, hh, ww)
