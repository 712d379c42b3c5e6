"""LTX-2 text connectors, port of ``apex_studio_tpu/models/ltx2_connectors.py``.

The packed per-layer Gemma-3 hidden states (``pack_text_embeds``: per sample
and layer, ``(x − mean) / (max − min) · 8`` over the valid rows, flattened to
``hidden · layers``) are projected by ``text_proj_in`` (188,160 → 3840 at
Gemma-3 12B) and refined by two 1-D transformers, one per modality. Each
moves the valid rows to the front and fills the tail with its learnable
registers tiled, so its attention then runs unmasked on the flash kernel;
without registers the padding is masked with a −1e9 key bias. RoPE is the
DiT family's over one axis normalised by ``connector_rope_base_seq_len``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from apex_studio_tpu_torch.models.layers import GELUMLP, Linear
from apex_studio_tpu_torch.models.registry import helper_registry
from apex_studio_tpu_torch.models.transformers.ltx2 import LTX2Attention, ltx2_rope


@dataclasses.dataclass
class LTX2ConnectorsConfig:
    caption_channels: int = 3840
    text_proj_in_factor: int = 49          # Gemma-3 12B: the embeddings + 48 layers
    video_connector_num_attention_heads: int = 30
    video_connector_attention_head_dim: int = 128
    video_connector_num_layers: int = 2
    video_connector_num_learnable_registers: Optional[int] = 128
    audio_connector_num_attention_heads: int = 30
    audio_connector_attention_head_dim: int = 128
    audio_connector_num_layers: int = 2
    audio_connector_num_learnable_registers: Optional[int] = 128
    connector_rope_base_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6

    @classmethod
    def from_dict(cls, cfg: dict) -> "LTX2ConnectorsConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in known})


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)


class _ConnectorBlock(nn.Module):
    """Affine-free RMS norm → self-attention (+RoPE) → residual; norm → FF → residual."""

    def __init__(self, dim: int, heads: int, head_dim: int, *, eps: float, dtype):
        super().__init__()
        self.attn1 = LTX2Attention(dim, dim, heads, head_dim, qk_eps=eps, dtype=dtype)
        self.ff = GELUMLP(dim, 4 * dim, use_bias=True, approximate=True, dtype=dtype)
        self.eps = eps

    def forward(self, x, rope, mask_bias):
        x = x + self.attn1(_rms(x, self.eps).to(x.dtype), q_rope=rope, k_rope=rope, mask_bias=mask_bias)
        return x + self.ff(_rms(x, self.eps).to(x.dtype))


class _ConnectorTransformer1d(nn.Module):
    def __init__(self, heads: int, head_dim: int, num_layers: int, num_registers: Optional[int],
                 base_seq_len: int, theta: float, *, eps: float, dtype):
        super().__init__()
        inner = heads * head_dim
        self.inner_dim = inner
        self.num_registers = num_registers
        self.learnable_registers = (nn.Parameter(torch.empty(num_registers, inner, dtype=torch.float32))
                                    if num_registers is not None else None)
        self.transformer_blocks = nn.ModuleList([_ConnectorBlock(inner, heads, head_dim, eps=eps, dtype=dtype)
                                                 for _ in range(num_layers)])
        self.base_seq_len = base_seq_len
        self.theta = theta
        self.eps = eps

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B, L, inner]; mask [B, L] bool (False = padded)."""
        b, l, _ = x.shape
        if self.learnable_registers is not None:
            # valid rows to the front in order, then the tail overwritten by the registers
            order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
            compact = torch.take_along_dim(x, order[:, :, None], dim=1)
            registers = self.learnable_registers.repeat(l // int(self.num_registers), 1)
            keep = torch.arange(l, device=x.device)[None, :] < mask.sum(1, keepdim=True)
            x = torch.where(keep[:, :, None], compact, registers[None].to(x.dtype))
            mask_bias = None  # every position is attended once the registers fill the padding
        else:
            mask_bias = torch.where(mask[:, None, None, :], torch.zeros((), device=x.device),
                                    torch.full((), -1e9, device=x.device))
        pos = np.arange(l, dtype=np.float32)[None, None, :]
        rope = ltx2_rope(torch.from_numpy(pos), self.inner_dim, self.theta, (float(self.base_seq_len),),
                         device=x.device)
        for blk in self.transformer_blocks:
            x = blk(x, rope, mask_bias)
        return _rms(x, self.eps).to(x.dtype)


@helper_registry.register("ltx2.connectors", aliases=("LTX2TextConnectors",))
class LTX2TextConnectors(nn.Module):
    config_class = LTX2ConnectorsConfig

    def __init__(self, cfg: LTX2ConnectorsConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.text_proj_in = Linear(cfg.caption_channels * cfg.text_proj_in_factor, cfg.caption_channels,
                                   use_bias=False, dtype=dtype)

        def make(heads, head_dim, layers, registers):
            return _ConnectorTransformer1d(heads, head_dim, layers, registers, cfg.connector_rope_base_seq_len,
                                           cfg.rope_theta, eps=cfg.norm_eps, dtype=dtype)

        self.video_connector = make(cfg.video_connector_num_attention_heads, cfg.video_connector_attention_head_dim,
                                    cfg.video_connector_num_layers, cfg.video_connector_num_learnable_registers)
        self.audio_connector = make(cfg.audio_connector_num_attention_heads, cfg.audio_connector_attention_head_dim,
                                    cfg.audio_connector_num_layers, cfg.audio_connector_num_learnable_registers)

    def forward(self, packed: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """packed [B, L, caption·factor]; mask [B, L] bool → (video ctx, audio ctx) [B, L, D]."""
        x = self.text_proj_in(packed)
        return self.video_connector(x, mask), self.audio_connector(x, mask)


def pack_text_embeds(hidden_all: torch.Tensor, mask: torch.Tensor, scale_factor: float = 8.0,
                     eps: float = 1e-6) -> torch.Tensor:
    """[B, L, D, layers] → [B, L, D·layers] in f32: per sample and layer the
    masked ``(x − mean) / (max − min) · scale_factor``, padded rows zeroed."""
    m = mask[:, :, None, None].bool()
    xf = hidden_all.float()
    n_valid = (mask.sum(1).float() * hidden_all.shape[2])[:, None, None, None]
    mean = torch.where(m, xf, 0.0).sum(dim=(1, 2), keepdim=True) / (n_valid + eps)
    x_min = torch.where(m, xf, float("inf")).amin(dim=(1, 2), keepdim=True)
    x_max = torch.where(m, xf, float("-inf")).amax(dim=(1, 2), keepdim=True)
    normed = (xf - mean) / (x_max - x_min + eps) * scale_factor
    b, l = hidden_all.shape[:2]
    return torch.where(mask[:, :, None].bool(), normed.reshape(b, l, -1), 0.0)
