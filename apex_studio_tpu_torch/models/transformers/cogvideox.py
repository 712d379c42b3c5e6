"""CogVideoX DiT, port of ``apex_studio_tpu/models/transformers/cogvideox.py``
(the 5B config by default: 48 heads of 64, 42 layers, text 4096, time 512).

- video tokens: per-frame 2×2 patches through a linear patch embed; T5
  features projected to the same width and put before them: every block
  attends over ``[text ‖ video]``
- ``CogLayerNormZero``: silu(temb) → (shift, scale, gate) for the video and
  the text streams, around the attention and the FFN; the FFN runs on the
  joint sequence
- attention: per-head LayerNorm on q and k, 3-axis RoPE (t : h : w of the
  head dim = 1 : 1.5 : 1.5 quarters) on the video tokens only, one unmasked
  kernel launch over the joint sequence
- final: LayerNorm, then AdaLN with the chunk order (shift, scale) on the
  video tokens, then the projection to p²·out_channels
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import GELUMLP, LayerNorm, Linear, TimestepEmbedder
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.ops.attention import attention
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import apply_rope, precompute_axial_freqs


@dataclasses.dataclass
class CogVideoXConfig:
    num_attention_heads: int = 48
    attention_head_dim: int = 64
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 42
    text_embed_dim: int = 4096
    time_embed_dim: int = 512
    patch_size: int = 2
    temporal_compression_ratio: int = 4
    sample_height: int = 60
    sample_width: int = 90
    use_rotary_positional_embeddings: bool = True
    rope_theta: float = 10000.0

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def rope_axes_dims(self) -> Tuple[int, int, int]:
        d = self.attention_head_dim
        return (d // 4, 3 * d // 8, 3 * d // 8)

    @classmethod
    def from_dict(cls, cfg: dict) -> "CogVideoXConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in known})


class CogLayerNormZero(nn.Module):
    """silu(temb) → Linear(6·dim): (shift, scale, gate) × (video, text)."""

    def __init__(self, cond_dim: int, dim: int, *, dtype):
        super().__init__()
        self.linear = Linear(cond_dim, 6 * dim, dtype=dtype)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, vid, txt, temb):
        mods = self.linear(F.silu(temb))[:, None, :]
        shift, scale, gate, t_shift, t_scale, t_gate = mods.chunk(6, dim=-1)
        vid = self.norm(vid) * (1 + scale) + shift
        txt = self.norm(txt) * (1 + t_scale) + t_shift
        return vid, txt, gate, t_gate


class CogVideoXAttention(nn.Module):
    def __init__(self, cfg: CogVideoXConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.to_q = Linear(d, d, dtype=dtype)
        self.to_k = Linear(d, d, dtype=dtype)
        self.to_v = Linear(d, d, dtype=dtype)
        self.to_out = Linear(d, d, dtype=dtype)
        self.norm_q = LayerNorm(cfg.attention_head_dim, eps=1e-6)
        self.norm_k = LayerNorm(cfg.attention_head_dim, eps=1e-6)
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim

    def forward(self, seq, n_txt: int, cos, sin):
        b, n, _ = seq.shape

        def split(x):
            return x.reshape(b, n, self.heads, self.head_dim)

        q = self.norm_q(split(self.to_q(seq)))
        k = self.norm_k(split(self.to_k(seq)))
        v = split(self.to_v(seq))
        if cos is not None:  # the video positions only; the text passes through
            q = torch.cat([q[:, :n_txt], apply_rope(q[:, n_txt:], cos, sin)], dim=1)
            k = torch.cat([k[:, :n_txt], apply_rope(k[:, n_txt:], cos, sin)], dim=1)
        return self.to_out(attention(q, k, v).reshape(b, n, -1))


class CogVideoXBlock(nn.Module):
    def __init__(self, cfg: CogVideoXConfig, *, dtype):
        super().__init__()
        self.norm1 = CogLayerNormZero(cfg.time_embed_dim, cfg.dim, dtype=dtype)
        self.attn1 = CogVideoXAttention(cfg, dtype=dtype)
        self.norm2 = CogLayerNormZero(cfg.time_embed_dim, cfg.dim, dtype=dtype)
        self.ff = GELUMLP(cfg.dim, 4 * cfg.dim, dtype=dtype)

    def forward(self, vid, txt, temb, cos, sin):
        n_txt = txt.shape[1]
        v_n, t_n, v_gate, t_gate = self.norm1(vid, txt, temb)
        attn = self.attn1(torch.cat([t_n, v_n], dim=1), n_txt, cos, sin)
        txt = txt + t_gate * attn[:, :n_txt]
        vid = vid + v_gate * attn[:, n_txt:]
        v_n, t_n, v_gate, t_gate = self.norm2(vid, txt, temb)
        ff = self.ff(torch.cat([t_n, v_n], dim=1))
        txt = txt + t_gate * ff[:, :n_txt]
        vid = vid + v_gate * ff[:, n_txt:]
        return vid, txt


@transformer_registry.register("cogvideo.base", aliases=("cogvideox", "CogVideoXTransformer3DModel"))
class CogVideoXTransformer3DModel(nn.Module):
    config_class = CogVideoXConfig

    def __init__(self, cfg: CogVideoXConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        p = cfg.patch_size
        self.patch_embed_proj = Linear(cfg.in_channels * p * p, cfg.dim, dtype=dtype)
        self.text_proj = Linear(cfg.text_embed_dim, cfg.dim, dtype=dtype)
        self.time_embed = TimestepEmbedder(cfg.time_embed_dim, freq_size=cfg.dim, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([CogVideoXBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.norm_final = LayerNorm(cfg.dim, eps=1e-5)
        self.norm_out_linear = Linear(cfg.time_embed_dim, 2 * cfg.dim, dtype=dtype)
        self.proj_out = Linear(cfg.dim, p * p * cfg.out_channels, dtype=dtype)

    def rope_tables(self, t_tok: int, h_tok: int, w_tok: int, device=None):
        """cos / sin [1, t·h·w, 1, D/2] over the (t, h, w) token grid, or
        (None, None) without rotary embeddings."""
        if not self.cfg.use_rotary_positional_embeddings:
            return None, None
        ids = np.stack(np.meshgrid(np.arange(t_tok), np.arange(h_tok), np.arange(w_tok), indexing="ij"),
                       axis=-1).reshape(-1, 3)
        cos, sin = precompute_axial_freqs(torch.from_numpy(ids).to(device)[None], self.cfg.rope_axes_dims,
                                          self.cfg.rope_theta)
        return cos[:, :, None, :], sin[:, :, None, :]

    def pack_latents(self, x: torch.Tensor) -> torch.Tensor:
        """[B,C,T,H,W] → [B, T·(H/p)·(W/p), C·p²] video tokens."""
        p = self.cfg.patch_size
        b, c, t, h, w = x.shape
        x = x.reshape(b, c, t, h // p, p, w // p, p)
        return x.permute(0, 2, 3, 5, 1, 4, 6).reshape(b, t * (h // p) * (w // p), c * p * p)

    def unpack_latents(self, tokens: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
        p = self.cfg.patch_size
        b, n, d = tokens.shape
        c = d // (p * p)
        x = tokens.reshape(b, t, h // p, w // p, c, p, p)
        return x.permute(0, 4, 1, 2, 5, 3, 6).reshape(b, c, t, h, w)

    def forward(self, hidden_states: torch.Tensor, timestep: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """hidden_states [B, C, T, H, W] latents, timestep [B], the text
        [B, N_txt, text_embed_dim] → [B, out_channels, T, H, W]."""
        b, c, t, h, w = hidden_states.shape
        p = self.cfg.patch_size
        temb = self.time_embed(timestep.float())
        vid = self.patch_embed_proj(self.pack_latents(hidden_states).to(self.dtype))
        txt = self.text_proj(encoder_hidden_states.to(self.dtype))
        cos, sin = self.rope_tables(t, h // p, w // p, device=vid.device)
        for blk in self.transformer_blocks:
            vid, txt = blk(vid, txt, temb, cos, sin)
        vid = self.norm_final(torch.cat([txt, vid], dim=1))[:, txt.shape[1]:]
        shift, scale = self.norm_out_linear(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        vid = layer_norm(vid, eps=1e-5) * (1 + scale) + shift
        return self.unpack_latents(self.proj_out(vid), t, h, w)
