"""Chroma (Chroma1-HD) MMDiT, port of
``apex_studio_tpu/models/transformers/chroma.py``.

A Flux derivative with pruned modulation, same graph, attribute names and
dtype flow as the JAX module:

- no pooled-text or guidance embedders: the approximator (in_proj, residual
  RMSNorm → Linear → SiLU → Linear layers, out_proj) turns one input row per
  modulation row into every block's modulation at once; a row is
  ``[sin-cos(t·1000) | sin-cos(0) | mod_proj_i]`` with the reference's
  degenerate integer ``mod_proj`` table;
- single block i reads rows 3i..3i+2, double block i its image rows at
  3·n_single + 6i and its text rows 6·n_double further on, the final norm
  the last two rows (shift first);
- the blocks are Flux's (joint attention through the port's
  ``FluxJointAttention``, parallel single blocks, per-head RMS qk-norm,
  axial RoPE over zeroed text ids and the 2×2 packed latent grid).

Text padding: the JAX module builds a ``[B, 1, S, S]`` pair mask at −1e9,
which its attention front sends to XLA. For every kept query row that mask
is the key-padding row ``[txt_mask | ones]``; only the padded text rows
(which every later block masks as keys and the output drops) see anything
else. The port passes that key-padding row to the flash kernel, so the image
output is the JAX module's and the padded text rows differ (ROADMAP Queue 3,
"Departures").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import GELUMLP, Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.models.transformers.flux import FluxConfig, FluxJointAttention, FluxTransformer2DModel
from apex_studio_tpu_torch.ops.attention import _prep_bias
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import apply_rope


@dataclasses.dataclass
class ChromaConfig:
    patch_size: int = 1
    in_channels: int = 64
    out_channels: int = 64
    num_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 10000.0
    approximator_num_channels: int = 64
    approximator_hidden_dim: int = 5120
    approximator_layers: int = 5

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def num_mod_rows(self) -> int:
        return 3 * self.num_single_layers + 2 * 6 * self.num_layers + 2

    @classmethod
    def from_dict(cls, cfg: dict) -> "ChromaConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: (tuple(v) if k == "axes_dims_rope" else v) for k, v in cfg.items() if k in names})


class ChromaApproximator(nn.Module):
    """Residual MLP stack emitting all modulation rows."""

    def __init__(self, cfg: ChromaConfig, *, dtype):
        super().__init__()
        h = cfg.approximator_hidden_dim
        self.in_proj = Linear(cfg.approximator_num_channels, h, dtype=dtype)
        self.layers_1 = nn.ModuleList([Linear(h, h, dtype=dtype) for _ in range(cfg.approximator_layers)])
        self.layers_2 = nn.ModuleList([Linear(h, h, dtype=dtype) for _ in range(cfg.approximator_layers)])
        self.norms = nn.ModuleList([RMSNorm(h, eps=1e-6) for _ in range(cfg.approximator_layers)])
        self.out_proj = Linear(h, cfg.dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_proj(x)
        for l1, l2, nrm in zip(self.layers_1, self.layers_2, self.norms):
            x = x + l2(F.silu(l1(nrm(x).to(x.dtype))))
        return self.out_proj(x)


def _mod_row_embedding(num_rows: int, dim: int) -> np.ndarray:
    """The reference's ``mod_proj`` buffer: its integer timesteps truncate
    every frequency to an integer, so the frequencies collapse to
    [1, 0, 0, ...]; Chroma's approximator was distilled against that table."""
    half = dim // 2
    freqs = np.trunc(np.exp(-np.log(10000.0) * np.arange(half) / half))
    angles = (np.arange(num_rows, dtype=np.float64) * 1000.0)[:, None] * freqs
    return np.concatenate([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)


def chroma_input_vec(t: torch.Tensor, num_channels: int, num_rows: int) -> torch.Tensor:
    """[B] timesteps in [0, 1] → [B, num_rows, 4·num_channels] in f32."""
    b = t.shape[0]
    t_proj = timestep_embedding(t.float() * 1000.0, num_channels)
    g_proj = timestep_embedding(torch.zeros(b, dtype=torch.float32, device=t.device), num_channels)
    mod = torch.from_numpy(_mod_row_embedding(num_rows, 2 * num_channels)).to(t.device)
    tg = torch.cat([t_proj, g_proj], dim=-1)[:, None].expand(b, num_rows, 2 * num_channels)
    return torch.cat([tg, mod[None].expand(b, -1, -1)], dim=-1)


class ChromaDoubleBlock(nn.Module):
    def __init__(self, cfg: ChromaConfig, *, dtype):
        super().__init__()
        fcfg = FluxConfig(in_channels=cfg.in_channels, num_attention_heads=cfg.num_attention_heads,
                          attention_head_dim=cfg.attention_head_dim, joint_attention_dim=cfg.joint_attention_dim)
        d = cfg.dim
        self.attn = FluxJointAttention(fcfg, dtype=dtype)
        self.ff = GELUMLP(d, 4 * d, approximate=True, dtype=dtype)
        self.ff_context = GELUMLP(d, 4 * d, approximate=True, dtype=dtype)

    def forward(self, img, txt, mod_img, mod_txt, rope_cos, rope_sin, bias):
        # mod_* [B, 6, d] raw rows in Flux's chunk order
        sh_i, sc_i, g_i, sh2_i, sc2_i, g2_i = (mod_img[:, i][:, None].to(img.dtype) for i in range(6))
        sh_t, sc_t, g_t, sh2_t, sc2_t, g2_t = (mod_txt[:, i][:, None].to(img.dtype) for i in range(6))
        img_n = layer_norm(img, eps=1e-6) * (1 + sc_i) + sh_i
        txt_n = layer_norm(txt, eps=1e-6) * (1 + sc_t) + sh_t
        attn_i, attn_t = self.attn(img_n, txt_n, rope_cos, rope_sin, mask_bias=bias)
        img = img + g_i * attn_i
        txt = txt + g_t * attn_t
        img = img + g2_i * self.ff(layer_norm(img, eps=1e-6) * (1 + sc2_i) + sh2_i)
        txt = txt + g2_t * self.ff_context(layer_norm(txt, eps=1e-6) * (1 + sc2_t) + sh2_t)
        return img, txt


class ChromaSingleBlock(nn.Module):
    def __init__(self, cfg: ChromaConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.to_q = Linear(d, d, dtype=dtype)
        self.to_k = Linear(d, d, dtype=dtype)
        self.to_v = Linear(d, d, dtype=dtype)
        self.norm_q = RMSNorm(cfg.attention_head_dim, eps=1e-6)
        self.norm_k = RMSNorm(cfg.attention_head_dim, eps=1e-6)
        self.proj_mlp = Linear(d, 4 * d, dtype=dtype)
        self.proj_out = Linear(5 * d, d, dtype=dtype)
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim

    def forward(self, x, mod, rope_cos, rope_sin, bias):
        b, s, _ = x.shape
        shift, scale, gate = (mod[:, i][:, None].to(x.dtype) for i in range(3))
        xn = layer_norm(x, eps=1e-6) * (1 + scale) + shift
        shape = (b, s, self.heads, self.head_dim)
        q = apply_rope(self.norm_q(self.to_q(xn).reshape(shape)), rope_cos, rope_sin)
        k = apply_rope(self.norm_k(self.to_k(xn).reshape(shape)), rope_cos, rope_sin)
        v = self.to_v(xn).reshape(shape)
        attn = attention_op(q, k, v, bias=bias).reshape(b, s, -1)
        mlp = F.gelu(self.proj_mlp(xn), approximate="tanh")
        return x + gate * self.proj_out(torch.cat([attn, mlp], dim=-1))


@transformer_registry.register("chroma.base", aliases=("chroma", "ChromaTransformer2DModel"))
class ChromaTransformer2DModel(nn.Module):
    config_class = ChromaConfig

    def __init__(self, cfg: ChromaConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        self.x_embedder = Linear(cfg.in_channels, d, dtype=dtype)
        self.context_embedder = Linear(cfg.joint_attention_dim, d, dtype=dtype)
        self.distilled_guidance_layer = ChromaApproximator(cfg, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([ChromaDoubleBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.single_transformer_blocks = nn.ModuleList(
            [ChromaSingleBlock(cfg, dtype=dtype) for _ in range(cfg.num_single_layers)])
        self.proj_out = Linear(d, cfg.patch_size**2 * cfg.out_channels, dtype=dtype)

    img_ids = staticmethod(FluxTransformer2DModel.img_ids)
    pack_latents = staticmethod(FluxTransformer2DModel.pack_latents)
    unpack_latents = staticmethod(FluxTransformer2DModel.unpack_latents)

    def rope_tables(self, n_txt: int, h_tok: int, w_tok: int, device=None):
        return FluxTransformer2DModel.rope_tables(self, n_txt, h_tok, w_tok, device=device)

    def forward(
        self,
        hidden_states: torch.Tensor,          # [B, S_img, in_channels] packed
        encoder_hidden_states: torch.Tensor,  # [B, S_txt, joint_dim]
        timestep: torch.Tensor,               # [B] in [0, 1]
        attention_mask: Optional[torch.Tensor] = None,  # [B, S_txt] 1 = keep
        rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        grid_hw: Optional[Tuple[int, int]] = None,
    ) -> torch.Tensor:
        cfg = self.cfg
        img = self.x_embedder(hidden_states.to(self.dtype))
        txt = self.context_embedder(encoder_hidden_states.to(self.dtype))
        b, n_img = img.shape[:2]
        n_txt = txt.shape[1]
        rope_cos, rope_sin = rope if rope is not None else self.rope_tables(n_txt, *grid_hw, device=img.device)

        vec = chroma_input_vec(timestep, cfg.approximator_num_channels // 4, cfg.num_mod_rows).to(self.dtype)
        pooled = self.distilled_guidance_layer(vec).float()  # [B, rows, d]

        bias = None
        if attention_mask is not None:
            keep = torch.cat([attention_mask.bool(), torch.ones(b, n_img, dtype=torch.bool, device=img.device)],
                             dim=1)
            bias = _prep_bias(None, keep)

        n_single, n_double = cfg.num_single_layers, cfg.num_layers
        img_off = 3 * n_single
        txt_off = img_off + 6 * n_double
        for i, block in enumerate(self.transformer_blocks):
            img, txt = block(img, txt, pooled[:, img_off + 6 * i: img_off + 6 * i + 6],
                             pooled[:, txt_off + 6 * i: txt_off + 6 * i + 6], rope_cos, rope_sin, bias)

        x = torch.cat([txt, img], dim=1)
        for i, block in enumerate(self.single_transformer_blocks):
            x = block(x, pooled[:, 3 * i: 3 * i + 3], rope_cos, rope_sin, bias)
        x = x[:, n_txt:]

        # the final pruned adaLN: rows [-2:] are (shift, scale), shift first
        shift = pooled[:, -2][:, None].to(x.dtype)
        scale = pooled[:, -1][:, None].to(x.dtype)
        x = layer_norm(x, eps=1e-6) * (1 + scale) + shift
        return self.proj_out(x)
