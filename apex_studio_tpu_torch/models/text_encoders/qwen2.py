"""Qwen2 / Qwen2.5-VL text path, port of ``apex_studio_tpu/models/text_encoders/qwen2.py``.

HunyuanVideo 1.5 conditions on Qwen2.5-VL hidden states of the text modality.
For text alone the VL model's mRoPE reduces to rotate-half RoPE, so the path
is a plain Qwen2 decoder: biased q/k/v projections, GQA (28 query heads share
4 key/value heads at 7B), SwiGLU. The mask is causal AND padding, ``[B,1,S,S]``:
a per-query bias, which the attention dispatcher sends to the plain-math route,
as the JAX package sends it to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear, RMSNorm, SwiGLU
from apex_studio_tpu_torch.models.registry import text_encoder_registry
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.rope import apply_rope_half, rope_freqs_1d


@dataclasses.dataclass
class Qwen2Config:
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_dict(cls, cfg: dict) -> "Qwen2Config":
        known = {f.name for f in dataclasses.fields(cls)}
        # Qwen2.5-VL nests the text config under "text_config" in some exports.
        merged = dict(cfg["text_config"]) if "text_config" in cfg else dict(cfg)
        return cls(**{k: v for k, v in merged.items() if k in known})


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: Qwen2Config, *, dtype):
        super().__init__()
        h, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        self.q_proj = Linear(cfg.hidden_size, h * d, dtype=dtype)
        self.k_proj = Linear(cfg.hidden_size, kv * d, dtype=dtype)
        self.v_proj = Linear(cfg.hidden_size, kv * d, dtype=dtype)
        self.o_proj = Linear(h * d, cfg.hidden_size, use_bias=False, dtype=dtype)
        self.heads, self.kv_heads, self.head_dim = h, kv, d

    def forward(self, x, cos, sin, mask):
        b, s, _ = x.shape
        q = apply_rope_half(self.q_proj(x).reshape(b, s, self.heads, self.head_dim), cos, sin)
        k = apply_rope_half(self.k_proj(x).reshape(b, s, self.kv_heads, self.head_dim), cos, sin)
        v = self.v_proj(x).reshape(b, s, self.kv_heads, self.head_dim)
        rep = self.heads // self.kv_heads
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = attention_op(q, k, v, mask=mask, is_causal=mask is None)
        return self.o_proj(out.reshape(b, s, -1))


class Qwen2DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen2Config, *, dtype):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps)
        self.self_attn = Qwen2Attention(cfg, dtype=dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps)
        self.mlp = SwiGLU(cfg.hidden_size, cfg.intermediate_size, dtype=dtype)

    def forward(self, x, cos, sin, mask):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, mask)
        return x + self.mlp(self.post_attention_layernorm(x))


@text_encoder_registry.register(
    "Qwen2_5_VLForConditionalGeneration",
    aliases=("Qwen2ForCausalLM", "Qwen2_5_VLTextModel", "qwen2", "qwen25vl"),
)
class Qwen2TextEncoder(nn.Module):
    config_class = Qwen2Config

    def __init__(self, cfg: Qwen2Config, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embed_tokens = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, dtype=dtype))
        self.layers = nn.ModuleList([Qwen2DecoderLayer(cfg, dtype=dtype)
                                     for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                num_hidden_layers_to_skip: int = 0, normalize_last: bool = False) -> torch.Tensor:
        """skip=0 → the last layer's output (HF ``hidden_states[-2]`` once
        normed); skip=k → HF ``hidden_states[-(k+1)]``: the first
        ``layers − (k − 1)`` layers run, so skip 2 runs 27 of 28."""
        b, s = input_ids.shape
        x = self.embed_tokens[input_ids].to(self.dtype)
        positions = torch.arange(s, device=x.device)[None, :]
        cos, sin = rope_freqs_1d(positions, self.cfg.head_dim, self.cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask.bool()[:, None, None, :]
        n_run = len(self.layers) - max(0, num_hidden_layers_to_skip - 1)
        for layer in list(self.layers)[:n_run]:
            x = layer(x, cos, sin, mask)
        return self.norm(x) if normalize_last else x
