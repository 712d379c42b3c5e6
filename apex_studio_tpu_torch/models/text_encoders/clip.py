"""CLIP text encoder (CLIP-L/14 class), port of
``apex_studio_tpu/models/text_encoders/clip.py``.

Flux conditions on the pooled embedding: the final-layer-norm hidden state at
the EOS position (argmax of the input ids). Attention uses the plain-math
``xla`` backend with a combined causal + padding mask, as the JAX module asks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import LayerNorm, Linear
from apex_studio_tpu_torch.models.registry import text_encoder_registry
from apex_studio_tpu_torch.ops.attention import attention as attention_op


@dataclasses.dataclass
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @classmethod
    def from_dict(cls, cfg: dict) -> "CLIPTextConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in known})


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name in ("gelu_tanh", "gelu_pytorch_tanh", "gelu_new"):
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, dtype):
        super().__init__()
        d = cfg.hidden_size
        self.q_proj = Linear(d, d, dtype=dtype)
        self.k_proj = Linear(d, d, dtype=dtype)
        self.v_proj = Linear(d, d, dtype=dtype)
        self.out_proj = Linear(d, d, dtype=dtype)
        self.heads = cfg.num_attention_heads
        self.head_dim = d // cfg.num_attention_heads

    def forward(self, x, mask):
        b, s, _ = x.shape
        shape = (b, s, self.heads, self.head_dim)
        q = self.q_proj(x).reshape(shape)
        k = self.k_proj(x).reshape(shape)
        v = self.v_proj(x).reshape(shape)
        out = attention_op(q, k, v, mask=mask, is_causal=mask is None, backend="xla")
        return self.out_proj(out.reshape(b, s, -1))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, dtype):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg, dtype=dtype)
        self.layer_norm2 = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.fc1 = Linear(d, cfg.intermediate_size, dtype=dtype)
        self.fc2 = Linear(cfg.intermediate_size, d, dtype=dtype)
        self.act = cfg.hidden_act

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.fc2(_act(self.act, self.fc1(self.layer_norm2(x))))


@text_encoder_registry.register("CLIPTextModel", aliases=("CLIPTextModelWithProjection", "clip"))
class CLIPTextEncoder(nn.Module):
    config_class = CLIPTextConfig

    def __init__(self, cfg: CLIPTextConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.token_embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, dtype=dtype))
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.max_position_embeddings, cfg.hidden_size, dtype=dtype))
        self.layers = nn.ModuleList([CLIPLayer(cfg, dtype=dtype) for _ in range(cfg.num_hidden_layers)])
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (last_hidden_state [B,S,D], pooled [B,D])."""
        b, s = input_ids.shape
        x = self.token_embedding[input_ids].to(self.dtype)
        x = x + self.position_embedding[:s].to(self.dtype)
        # CLIP text attention is causal; combine with the padding mask when given.
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask.bool()[:, None, None, :]
        for layer in self.layers:
            x = layer(x, mask)
        x = self.final_layer_norm(x)
        eos_idx = input_ids.argmax(dim=-1)  # EOS has the highest token id
        pooled = x[torch.arange(b, device=x.device), eos_idx]
        return x, pooled
