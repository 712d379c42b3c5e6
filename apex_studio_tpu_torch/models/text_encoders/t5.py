"""T5 / UMT5 encoder stack, port of ``apex_studio_tpu/models/text_encoders/t5.py``.

v1.1-style: pre-LN RMSNorm without bias, relative position bias buckets added
to the attention logits (shared across layers for T5, per layer for UMT5),
gated-GELU FFN, no biases, and no 1/sqrt(d_kv) scale.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import text_encoder_registry
from apex_studio_tpu_torch.ops.attention import attention as attention_op


@dataclasses.dataclass
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    per_layer_relative_bias: bool = False  # True for UMT5

    @classmethod
    def from_dict(cls, cfg: dict) -> "T5Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if cfg.get("model_type") == "umt5" or "umt5" in str(cfg.get("_name_or_path", "")).lower():
            kw["per_layer_relative_bias"] = True
        return cls(**kw)


def relative_position_buckets(qlen: int, klen: int, num_buckets: int = 32,
                              max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 relative-position bucketing (host, static shapes)."""
    ctx = np.arange(qlen)[:, None]
    mem = np.arange(klen)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(rel.clip(1) / max_exact) / np.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return out + np.where(is_small, rel, large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, *, dtype):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.q = Linear(cfg.d_model, inner, use_bias=False, dtype=dtype)
        self.k = Linear(cfg.d_model, inner, use_bias=False, dtype=dtype)
        self.v = Linear(cfg.d_model, inner, use_bias=False, dtype=dtype)
        self.o = Linear(inner, cfg.d_model, use_bias=False, dtype=dtype)
        self.relative_attention_bias = (
            nn.Parameter(torch.empty(cfg.relative_attention_num_buckets, cfg.num_heads, dtype=dtype))
            if has_bias else None
        )
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.cfg = cfg

    def position_bias(self, qlen: int, klen: int) -> torch.Tensor:
        buckets = relative_position_buckets(
            qlen, klen, self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance)
        table = self.relative_attention_bias.float()
        bias = table[torch.as_tensor(buckets, device=table.device)]  # [q, k, H]
        return bias.permute(2, 0, 1)[None]  # [1, H, q, k]

    def forward(self, x, bias, mask):
        b, s, _ = x.shape
        shape = (b, s, self.heads, self.d_kv)
        q = self.q(x).reshape(shape)
        k = self.k(x).reshape(shape)
        v = self.v(x).reshape(shape)
        out = attention_op(q, k, v, bias=bias, mask=mask, scale=1.0, backend="xla")
        return self.o(out.reshape(b, s, -1))


class T5FF(nn.Module):
    def __init__(self, cfg: T5Config, *, dtype):
        super().__init__()
        self.wi_0 = Linear(cfg.d_model, cfg.d_ff, use_bias=False, dtype=dtype)
        self.wi_1 = Linear(cfg.d_model, cfg.d_ff, use_bias=False, dtype=dtype)
        self.wo = Linear(cfg.d_ff, cfg.d_model, use_bias=False, dtype=dtype)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, *, dtype):
        super().__init__()
        self.layer_norm0 = RMSNorm(cfg.d_model, eps=cfg.layer_norm_epsilon)
        self.attention = T5Attention(cfg, has_bias, dtype=dtype)
        self.layer_norm1 = RMSNorm(cfg.d_model, eps=cfg.layer_norm_epsilon)
        self.ff = T5FF(cfg, dtype=dtype)

    def forward(self, x, bias, mask):
        x = x + self.attention(self.layer_norm0(x), bias, mask)
        return x + self.ff(self.layer_norm1(x))


@text_encoder_registry.register("T5EncoderModel", aliases=("UMT5EncoderModel", "t5", "umt5"))
class T5Encoder(nn.Module):
    config_class = T5Config

    def __init__(self, cfg: T5Config, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.shared = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, dtype=dtype))
        self.blocks = nn.ModuleList([
            T5Block(cfg, has_bias=(i == 0 or cfg.per_layer_relative_bias), dtype=dtype)
            for i in range(cfg.num_layers)
        ])
        self.final_layer_norm = RMSNorm(cfg.d_model, eps=cfg.layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        x = self.shared[input_ids].to(self.dtype)
        s = input_ids.shape[1]
        mask = attention_mask.bool() if attention_mask is not None else None
        shared_bias = None
        for i, block in enumerate(self.blocks):
            if block.attention.relative_attention_bias is not None:
                bias = block.attention.position_bias(s, s)
                if i == 0:
                    shared_bias = bias
            else:
                bias = shared_bias
            x = block(x, bias, mask)
        return self.final_layer_norm(x)
