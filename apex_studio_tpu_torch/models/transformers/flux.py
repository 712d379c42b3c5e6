"""Flux DiT (MMDiT: 19 double-stream + 38 single-stream blocks), port of
``apex_studio_tpu/models/transformers/flux.py``.

Same graph, attribute names and dtype flow as the JAX module: packed 2×2
latents (64-dim tokens), joint attention over [txt, img] through
``ops.attention`` (the flash kernel on the card), per-head RMS qk-norm in f32,
interleaved-pair RoPE, and adaLN ``layer_norm(x)*(1+scale)+shift`` in the
activation dtype.
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
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import apply_rope, precompute_axial_freqs


@dataclasses.dataclass
class FluxConfig:
    in_channels: int = 64
    out_channels: int = 64
    num_layers: int = 19            # double-stream
    num_single_layers: int = 38     # single-stream
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096  # T5 features
    pooled_projection_dim: int = 768  # CLIP pooled
    guidance_embeds: bool = True
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 10000.0

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def from_dict(cls, cfg: dict) -> "FluxConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "axes_dims_rope" in kw:
            kw["axes_dims_rope"] = tuple(kw["axes_dims_rope"])
        return cls(**kw)


class FluxTimeTextEmbed(nn.Module):
    """timestep + (guidance) + pooled-text → temb."""

    def __init__(self, cfg: FluxConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.timestep_linear_1 = Linear(256, d, dtype=dtype)
        self.timestep_linear_2 = Linear(d, d, dtype=dtype)
        if cfg.guidance_embeds:
            self.guidance_linear_1 = Linear(256, d, dtype=dtype)
            self.guidance_linear_2 = Linear(d, d, dtype=dtype)
        else:
            self.guidance_linear_1 = self.guidance_linear_2 = None
        self.text_linear_1 = Linear(cfg.pooled_projection_dim, d, dtype=dtype)
        self.text_linear_2 = Linear(d, d, dtype=dtype)

    def forward(self, t, pooled, guidance=None):
        t_freq = timestep_embedding(t * 1000.0, 256, flip_sin_to_cos=True)
        temb = self.timestep_linear_2(F.silu(self.timestep_linear_1(t_freq)))
        if self.guidance_linear_1 is not None and guidance is not None:
            g_freq = timestep_embedding(guidance * 1000.0, 256, flip_sin_to_cos=True)
            temb = temb + self.guidance_linear_2(F.silu(self.guidance_linear_1(g_freq)))
        return temb + self.text_linear_2(F.silu(self.text_linear_1(pooled)))


class FluxJointAttention(nn.Module):
    """Joint attention over [txt, img] with separate projections per stream."""

    def __init__(self, cfg: FluxConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
                     "to_out", "to_add_out"):
            setattr(self, name, Linear(d, d, dtype=dtype))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(self, name, RMSNorm(cfg.attention_head_dim, eps=1e-6))
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim

    def forward(self, img, txt, rope_cos, rope_sin):
        b, n_img, _ = img.shape
        n_txt = txt.shape[1]

        def split(x, proj_q, proj_k, proj_v, nq, nk):
            shape = (b, x.shape[1], self.heads, self.head_dim)
            return nq(proj_q(x).reshape(shape)), nk(proj_k(x).reshape(shape)), proj_v(x).reshape(shape)

        q_i, k_i, v_i = split(img, self.to_q, self.to_k, self.to_v, self.norm_q, self.norm_k)
        q_t, k_t, v_t = split(txt, self.add_q_proj, self.add_k_proj, self.add_v_proj,
                              self.norm_added_q, self.norm_added_k)
        q = apply_rope(torch.cat([q_t, q_i], dim=1), rope_cos, rope_sin)
        k = apply_rope(torch.cat([k_t, k_i], dim=1), rope_cos, rope_sin)
        v = torch.cat([v_t, v_i], dim=1)
        out = attention_op(q, k, v).reshape(b, n_txt + n_img, -1)
        txt_out, img_out = out[:, :n_txt], out[:, n_txt:]
        return self.to_out(img_out), self.to_add_out(txt_out)


class FluxDoubleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.norm1_linear = Linear(d, 6 * d, dtype=dtype)
        self.norm1_context_linear = Linear(d, 6 * d, dtype=dtype)
        self.attn = FluxJointAttention(cfg, dtype=dtype)
        self.ff = GELUMLP(d, 4 * d, approximate=True, dtype=dtype)
        self.ff_context = GELUMLP(d, 4 * d, approximate=True, dtype=dtype)

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


class FluxSingleBlock(nn.Module):
    """Parallel attention+MLP block over the fused [txt, img] sequence."""

    def __init__(self, cfg: FluxConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.norm_linear = Linear(d, 3 * d, dtype=dtype)
        self.to_q = Linear(d, d, dtype=dtype)
        self.to_k = Linear(d, d, dtype=dtype)
        self.to_v = Linear(d, d, dtype=dtype)
        self.norm_q = RMSNorm(cfg.attention_head_dim, eps=1e-6)
        self.norm_k = RMSNorm(cfg.attention_head_dim, eps=1e-6)
        self.proj_mlp = Linear(d, 4 * d, dtype=dtype)
        self.proj_out = Linear(5 * d, d, dtype=dtype)
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
        mlp = F.gelu(self.proj_mlp(xn), approximate="tanh")
        return x + gate * self.proj_out(torch.cat([attn, mlp], dim=-1))


@transformer_registry.register("flux.base", aliases=("flux",))
class FluxTransformer2DModel(nn.Module):
    config_class = FluxConfig

    def __init__(self, cfg: FluxConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        self.x_embedder = Linear(cfg.in_channels, d, dtype=dtype)
        self.context_embedder = Linear(cfg.joint_attention_dim, d, dtype=dtype)
        self.time_text_embed = FluxTimeTextEmbed(cfg, dtype=dtype)
        self.transformer_blocks = nn.ModuleList(
            [FluxDoubleBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.single_transformer_blocks = nn.ModuleList(
            [FluxSingleBlock(cfg, dtype=dtype) for _ in range(cfg.num_single_layers)])
        self.norm_out_linear = Linear(d, 2 * d, dtype=dtype)
        self.proj_out = Linear(d, cfg.out_channels, dtype=dtype)

    # -- geometry -----------------------------------------------------------------

    @staticmethod
    def img_ids(h_tok: int, w_tok: int) -> np.ndarray:
        ids = np.zeros((h_tok, w_tok, 3), np.int64)
        ids[..., 1] = np.arange(h_tok)[:, None]
        ids[..., 2] = np.arange(w_tok)[None, :]
        return ids.reshape(-1, 3)

    def rope_tables(self, n_txt: int, h_tok: int, w_tok: int, device=None):
        """cos/sin [1, n_txt + h_tok·w_tok, 1, D/2] in f32. Built from an int32
        tensor of ids on the f32 path, as the JAX module builds them."""
        ids = np.concatenate([np.zeros((n_txt, 3), np.int64), self.img_ids(h_tok, w_tok)])
        ids_t = torch.as_tensor(ids.astype(np.int32), device=device)[None]
        cos, sin = precompute_axial_freqs(ids_t, self.cfg.axes_dims_rope, self.cfg.rope_theta)
        return cos[:, :, None, :], sin[:, :, None, :]

    @staticmethod
    def pack_latents(x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] → [B, (H/2)(W/2), 4C] (2×2 pixel-shuffle packing)."""
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // 2, 2, w // 2, 2)
        return x.permute(0, 2, 4, 1, 3, 5).reshape(b, (h // 2) * (w // 2), c * 4)

    @staticmethod
    def unpack_latents(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, d = tokens.shape
        c = d // 4
        x = tokens.reshape(b, h // 2, w // 2, c, 2, 2)
        return x.permute(0, 3, 1, 4, 2, 5).reshape(b, c, h, w)

    # -- forward -------------------------------------------------------------------

    def forward(
        self,
        hidden_states: torch.Tensor,          # [B, N_img, 64] packed latents
        encoder_hidden_states: torch.Tensor,  # [B, N_txt, joint_dim] T5 features
        pooled_projections: torch.Tensor,     # [B, pooled_dim] CLIP pooled
        timestep: torch.Tensor,               # [B] in [0, 1]
        guidance: Optional[torch.Tensor] = None,  # [B]
        grid_hw: Optional[Tuple[int, int]] = None,  # token grid (h_tok, w_tok)
        rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        b, n_img, _ = hidden_states.shape
        n_txt = encoder_hidden_states.shape[1]
        if grid_hw is None:
            side = int(round(float(np.sqrt(n_img))))
            grid_hw = (side, side)

        temb = self.time_text_embed(timestep.float(), pooled_projections.to(self.dtype), guidance)
        img = self.x_embedder(hidden_states.to(self.dtype))
        txt = self.context_embedder(encoder_hidden_states.to(self.dtype))
        rope_cos, rope_sin = rope if rope is not None else self.rope_tables(
            n_txt, *grid_hw, device=img.device)

        for blk in self.transformer_blocks:
            img, txt = blk(img, txt, temb, rope_cos, rope_sin)

        x = torch.cat([txt, img], dim=1)
        for blk in self.single_transformer_blocks:
            x = blk(x, temb, rope_cos, rope_sin)
        img = x[:, n_txt: n_txt + n_img]

        # AdaLayerNormContinuous ordering: scale first, then shift.
        scale, shift = self.norm_out_linear(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        img = layer_norm(img, eps=1e-6) * (1 + scale) + shift
        return self.proj_out(img)
