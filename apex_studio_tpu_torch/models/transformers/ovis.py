"""Ovis-Image MMDiT, port of ``apex_studio_tpu/models/transformers/ovis.py``.

Flux-shaped joint-attention MMDiT (6 dual + 27 single blocks at dim 3072, 24
heads of 128, packed 2×2 latents, 3-axis RoPE (16, 56, 56) θ 10000) with
SwiGLU feed-forwards in the dual blocks (a fused value‖gate projection), a
SiLU-gated MLP in the single blocks, an RMSNorm ahead of the context
embedder, timestep-only conditioning and diagonal text RoPE ids (text token
i at (0, i, i)). Same attribute names and dtype flow as the JAX module;
every attention goes to ``ops.attention`` (the flash kernel on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.models.transformers.flux import FluxJointAttention, FluxTransformer2DModel
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import apply_rope, precompute_axial_freqs


@dataclasses.dataclass
class OvisConfig:
    patch_size: int = 1
    in_channels: int = 64
    out_channels: int = 64
    num_layers: int = 6
    num_single_layers: int = 27
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 2048
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 10000.0
    mlp_ratio: float = 4.0

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def from_dict(cls, cfg: dict) -> "OvisConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "axes_dims_rope" in kw:
            kw["axes_dims_rope"] = tuple(kw["axes_dims_rope"])
        return cls(**kw)


class FusedSwiGLU(nn.Module):
    """fc2(value · silu(gate)) with a fused value‖gate projection (diffusers'
    ``FeedForward(activation_fn="swiglu")`` layout)."""

    def __init__(self, dim: int, hidden: int, *, dtype):
        super().__init__()
        self.fc1 = Linear(dim, 2 * hidden, dtype=dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x):
        value, gate = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(value * F.silu(gate))


class OvisDoubleBlock(nn.Module):
    def __init__(self, cfg: OvisConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.norm1_linear = Linear(d, 6 * d, dtype=dtype)
        self.norm1_context_linear = Linear(d, 6 * d, dtype=dtype)
        self.attn = FluxJointAttention(cfg, dtype=dtype)
        hidden = int(d * cfg.mlp_ratio)
        self.ff = FusedSwiGLU(d, hidden, dtype=dtype)
        self.ff_context = FusedSwiGLU(d, hidden, dtype=dtype)

    @staticmethod
    def _mod(linear, temb):
        return linear(F.silu(temb))[:, None, :].chunk(6, dim=-1)

    def forward(self, img, txt, temb, rope_cos, rope_sin):
        sh_i, sc_i, g_i, sh2_i, sc2_i, g2_i = self._mod(self.norm1_linear, temb)
        sh_t, sc_t, g_t, sh2_t, sc2_t, g2_t = self._mod(self.norm1_context_linear, temb)
        img_n = layer_norm(img, eps=1e-6) * (1 + sc_i) + sh_i
        txt_n = layer_norm(txt, eps=1e-6) * (1 + sc_t) + sh_t
        attn_i, attn_t = self.attn(img_n, txt_n, rope_cos, rope_sin)
        img = img + g_i * attn_i
        txt = txt + g_t * attn_t
        img = img + g2_i * self.ff(layer_norm(img, eps=1e-6) * (1 + sc2_i) + sh2_i)
        txt = txt + g2_t * self.ff_context(layer_norm(txt, eps=1e-6) * (1 + sc2_t) + sh2_t)
        return img, txt


class OvisSingleBlock(nn.Module):
    """Parallel attention + SiLU-gated MLP over the fused [txt, img] sequence
    (``proj_mlp`` → value‖gate, out = silu(gate)·value)."""

    def __init__(self, cfg: OvisConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.norm_linear = Linear(d, 3 * d, dtype=dtype)
        self.to_q = Linear(d, d, dtype=dtype)
        self.to_k = Linear(d, d, dtype=dtype)
        self.to_v = Linear(d, d, dtype=dtype)
        self.norm_q = RMSNorm(cfg.attention_head_dim, eps=1e-6)
        self.norm_k = RMSNorm(cfg.attention_head_dim, eps=1e-6)
        self.mlp_hidden = int(d * cfg.mlp_ratio)
        self.proj_mlp = Linear(d, 2 * self.mlp_hidden, dtype=dtype)
        self.proj_out = Linear(d + self.mlp_hidden, d, dtype=dtype)
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim

    def forward(self, x, temb, rope_cos, rope_sin):
        b, s, _ = x.shape
        shift, scale, gate = self.norm_linear(F.silu(temb))[:, None, :].chunk(3, dim=-1)
        xn = layer_norm(x, eps=1e-6) * (1 + scale) + shift
        shape = (b, s, self.heads, self.head_dim)
        q = apply_rope(self.norm_q(self.to_q(xn).reshape(shape)), rope_cos, rope_sin)
        k = apply_rope(self.norm_k(self.to_k(xn).reshape(shape)), rope_cos, rope_sin)
        v = self.to_v(xn).reshape(shape)
        attn = attention_op(q, k, v).reshape(b, s, -1)
        value, mgate = self.proj_mlp(xn).chunk(2, dim=-1)
        return x + gate * self.proj_out(torch.cat([attn, F.silu(mgate) * value], dim=-1))


@transformer_registry.register("ovis.base", aliases=("ovis", "OvisImageTransformer2DModel"))
class OvisImageTransformer2DModel(nn.Module):
    config_class = OvisConfig

    def __init__(self, cfg: OvisConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        self.x_embedder = Linear(cfg.in_channels, d, dtype=dtype)
        self.context_embedder_norm = RMSNorm(cfg.joint_attention_dim, eps=1e-6)
        self.context_embedder = Linear(cfg.joint_attention_dim, d, dtype=dtype)
        self.timestep_linear_1 = Linear(256, d, dtype=dtype)
        self.timestep_linear_2 = Linear(d, d, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([OvisDoubleBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.single_transformer_blocks = nn.ModuleList(
            [OvisSingleBlock(cfg, dtype=dtype) for _ in range(cfg.num_single_layers)])
        self.norm_out_linear = Linear(d, 2 * d, dtype=dtype)
        self.proj_out = Linear(d, cfg.patch_size**2 * cfg.out_channels, dtype=dtype)

    pack_latents = staticmethod(FluxTransformer2DModel.pack_latents)
    unpack_latents = staticmethod(FluxTransformer2DModel.unpack_latents)

    def rope_tables(self, n_txt: int, h_tok: int, w_tok: int, device=None):
        """cos/sin [1, S, 1, D/2] over diagonal text ids and the image grid,
        from an int32 tensor of ids (the JAX module's f32 path)."""
        txt_ids = np.zeros((n_txt, 3), np.int64)
        txt_ids[:, 1] = np.arange(n_txt)
        txt_ids[:, 2] = np.arange(n_txt)
        ids = np.concatenate([txt_ids, FluxTransformer2DModel.img_ids(h_tok, w_tok)], axis=0)
        ids_t = torch.as_tensor(ids.astype(np.int32), device=device)[None]
        cos, sin = precompute_axial_freqs(ids_t, self.cfg.axes_dims_rope, self.cfg.rope_theta)
        return cos[:, :, None, :], sin[:, :, None, :]

    def forward(
        self,
        hidden_states: torch.Tensor,          # [B, N_img, 64] packed latents
        encoder_hidden_states: torch.Tensor,  # [B, N_txt, joint_dim]
        timestep: torch.Tensor,               # [B] in [0, 1]
        grid_hw: Optional[Tuple[int, int]] = None,
    ) -> torch.Tensor:
        n_img = hidden_states.shape[1]
        n_txt = encoder_hidden_states.shape[1]
        if grid_hw is None:
            side = int(round(float(np.sqrt(n_img))))
            grid_hw = (side, side)
        t_freq = timestep_embedding(timestep.float() * 1000.0, 256, flip_sin_to_cos=True)
        temb = self.timestep_linear_2(F.silu(self.timestep_linear_1(t_freq.to(self.dtype))))
        img = self.x_embedder(hidden_states.to(self.dtype))
        txt = self.context_embedder(self.context_embedder_norm(encoder_hidden_states.to(self.dtype)))
        rope_cos, rope_sin = self.rope_tables(n_txt, *grid_hw, device=img.device)

        for blk in self.transformer_blocks:
            img, txt = blk(img, txt, temb, rope_cos, rope_sin)
        x = torch.cat([txt, img], dim=1)
        for blk in self.single_transformer_blocks:
            x = blk(x, temb, rope_cos, rope_sin)
        img = x[:, n_txt:]

        scale, shift = self.norm_out_linear(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        img = layer_norm(img, eps=1e-6) * (1 + scale) + shift
        return self.proj_out(img)
