"""Bria FIBO MMDiT, port of ``apex_studio_tpu/models/transformers/fibo.py``.

Flux-shaped joint-attention MMDiT (19 dual + 38 single blocks at dim 3072,
24 heads of 128, unpacked latent tokens, 3-axis RoPE (16, 56, 56) θ 10000)
whose text stream is refreshed per block: the second half of the text
channels is replaced by that block's bias-free projection of one text-encoder
hidden layer. Same attribute names and dtype flow as the JAX module.

The text key padding, as the JAX module applies it:

- single blocks take it as a boolean mask over ``[txt, img]`` (padded keys
  at −1e30, the flash kernel's key-padding bias on the card);
- dual blocks hand the same boolean mask to ``FluxJointAttention`` as an
  additive bias, so a kept key's logit gains 1 and a padded key's none; the
  port adds the same 0/1 bias (a reference fault it mirrors: ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import GELUMLP, Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.models.transformers.flux import FluxJointAttention, FluxTransformer2DModel
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import apply_rope


@dataclasses.dataclass
class FiboConfig:
    patch_size: int = 1
    in_channels: int = 64
    num_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    guidance_embeds: bool = False
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 10000.0
    time_theta: float = 10000.0
    text_encoder_dim: int = 2048
    mlp_ratio: float = 4.0

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def from_dict(cls, cfg: dict) -> "FiboConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "axes_dims_rope" in kw:
            kw["axes_dims_rope"] = tuple(kw["axes_dims_rope"])
        return cls(**kw)


class FiboDoubleBlock(nn.Module):
    def __init__(self, cfg: FiboConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.norm1_linear = Linear(d, 6 * d, dtype=dtype)
        self.norm1_context_linear = Linear(d, 6 * d, dtype=dtype)
        self.attn = FluxJointAttention(cfg, dtype=dtype)
        hidden = int(d * cfg.mlp_ratio)
        self.ff = GELUMLP(d, hidden, approximate=True, dtype=dtype)
        self.ff_context = GELUMLP(d, hidden, approximate=True, dtype=dtype)

    @staticmethod
    def _mod(linear, temb):
        return linear(F.silu(temb))[:, None, :].chunk(6, dim=-1)

    def forward(self, img, txt, temb, rope_cos, rope_sin, mask):
        sh_i, sc_i, g_i, sh2_i, sc2_i, g2_i = self._mod(self.norm1_linear, temb)
        sh_t, sc_t, g_t, sh2_t, sc2_t, g2_t = self._mod(self.norm1_context_linear, temb)
        img_n = layer_norm(img, eps=1e-6) * (1 + sc_i) + sh_i
        txt_n = layer_norm(txt, eps=1e-6) * (1 + sc_t) + sh_t
        # the boolean mask as an additive 0/1 key bias, as the JAX block passes it
        bias = None if mask is None else mask.float()[:, None, None, :]
        attn_i, attn_t = self.attn(img_n, txt_n, rope_cos, rope_sin, mask_bias=bias)
        img = img + g_i * attn_i
        txt = txt + g_t * attn_t
        img = img + g2_i * self.ff(layer_norm(img, eps=1e-6) * (1 + sc2_i) + sh2_i)
        txt = txt + g2_t * self.ff_context(layer_norm(txt, eps=1e-6) * (1 + sc2_t) + sh2_t)
        return img, txt


class FiboSingleBlock(nn.Module):
    """Parallel attention + GELU MLP over the fused [txt, img] sequence with
    the text key-padding mask."""

    def __init__(self, cfg: FiboConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.norm_linear = Linear(d, 3 * d, dtype=dtype)
        self.to_q = Linear(d, d, dtype=dtype)
        self.to_k = Linear(d, d, dtype=dtype)
        self.to_v = Linear(d, d, dtype=dtype)
        self.norm_q = RMSNorm(cfg.attention_head_dim, eps=1e-6)
        self.norm_k = RMSNorm(cfg.attention_head_dim, eps=1e-6)
        hidden = int(d * cfg.mlp_ratio)
        self.proj_mlp = Linear(d, hidden, dtype=dtype)
        self.proj_out = Linear(d + hidden, d, dtype=dtype)
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim

    def forward(self, x, temb, rope_cos, rope_sin, mask):
        b, s, _ = x.shape
        shift, scale, gate = self.norm_linear(F.silu(temb))[:, None, :].chunk(3, dim=-1)
        xn = layer_norm(x, eps=1e-6) * (1 + scale) + shift
        shape = (b, s, self.heads, self.head_dim)
        q = apply_rope(self.norm_q(self.to_q(xn).reshape(shape)), rope_cos, rope_sin)
        k = apply_rope(self.norm_k(self.to_k(xn).reshape(shape)), rope_cos, rope_sin)
        v = self.to_v(xn).reshape(shape)
        attn = attention_op(q, k, v, mask=mask).reshape(b, s, -1)
        mlp = F.gelu(self.proj_mlp(xn), approximate="tanh")
        return x + gate * self.proj_out(torch.cat([attn, mlp], dim=-1))


@transformer_registry.register("fibo.base", aliases=("fibo", "BriaFiboTransformer2DModel"))
class BriaFiboTransformer2DModel(nn.Module):
    config_class = FiboConfig

    def __init__(self, cfg: FiboConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        self.x_embedder = Linear(cfg.in_channels, d, dtype=dtype)
        self.context_embedder = Linear(cfg.joint_attention_dim, d, dtype=dtype)
        self.time_linear_1 = Linear(256, d, dtype=dtype)
        self.time_linear_2 = Linear(d, d, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([FiboDoubleBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.single_transformer_blocks = nn.ModuleList(
            [FiboSingleBlock(cfg, dtype=dtype) for _ in range(cfg.num_single_layers)])
        # one bias-free caption projection a block: a text-encoder layer → half the text width
        self.caption_projection = nn.ModuleList(
            [Linear(cfg.text_encoder_dim, d // 2, use_bias=False, dtype=dtype)
             for _ in range(cfg.num_layers + cfg.num_single_layers)])
        self.norm_out_linear = Linear(d, 2 * d, dtype=dtype)
        self.proj_out = Linear(d, cfg.patch_size**2 * cfg.in_channels, dtype=dtype)

    def rope_tables(self, n_txt: int, h_tok: int, w_tok: int, device=None):
        return FluxTransformer2DModel.rope_tables(self, n_txt, h_tok, w_tok, device=device)

    img_ids = staticmethod(FluxTransformer2DModel.img_ids)

    def _splice_text(self, txt: torch.Tensor, layer: torch.Tensor, idx: int) -> torch.Tensor:
        half = self.cfg.dim // 2
        return torch.cat([txt[..., :half], self.caption_projection[idx](layer.to(self.dtype))], dim=-1)

    def forward(
        self,
        hidden_states: torch.Tensor,          # [B, N_img, C] latent tokens
        encoder_hidden_states: torch.Tensor,  # [B, N_txt, joint_dim]
        text_encoder_layers: Sequence[torch.Tensor],  # per-block [B, N_txt, te_dim]
        timestep: torch.Tensor,               # [B] raw scheduler t (0..1000)
        text_mask: Optional[torch.Tensor] = None,     # [B, N_txt] 1 = real
        grid_hw: Optional[Tuple[int, int]] = None,
    ) -> torch.Tensor:
        b, n_img, _ = hidden_states.shape
        n_txt = encoder_hidden_states.shape[1]
        if grid_hw is None:
            side = int(round(float(np.sqrt(n_img))))
            grid_hw = (side, side)
        t_freq = timestep_embedding(timestep.float(), 256, flip_sin_to_cos=True, max_period=self.cfg.time_theta)
        temb = self.time_linear_2(F.silu(self.time_linear_1(t_freq.to(self.dtype))))
        img = self.x_embedder(hidden_states.to(self.dtype))
        txt = self.context_embedder(encoder_hidden_states.to(self.dtype))
        rope_cos, rope_sin = self.rope_tables(n_txt, *grid_hw, device=img.device)

        mask = None
        if text_mask is not None:
            mask = torch.cat([text_mask.bool(), torch.ones(b, n_img, dtype=torch.bool, device=img.device)], dim=1)

        # the layer list trimmed or padded to one a block
        n_total = len(self.transformer_blocks) + len(self.single_transformer_blocks)
        layers = list(text_encoder_layers)
        layers = (layers[len(layers) - n_total:] if len(layers) >= n_total
                  else layers + [layers[-1]] * (n_total - len(layers)))

        bi = 0
        for blk in self.transformer_blocks:
            txt = self._splice_text(txt, layers[bi], bi)
            bi += 1
            img, txt = blk(img, txt, temb, rope_cos, rope_sin, mask)
        for blk in self.single_transformer_blocks:
            txt = self._splice_text(txt, layers[bi], bi)
            bi += 1
            x = blk(torch.cat([txt, img], dim=1), temb, rope_cos, rope_sin, mask)
            txt, img = x[:, :n_txt], x[:, n_txt:]

        scale, shift = self.norm_out_linear(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        img = layer_norm(img, eps=1e-6) * (1 + scale) + shift
        return self.proj_out(img)
