"""LLaMA-architecture causal LM as a text encoder, port of
``apex_studio_tpu/models/text_encoders/llama.py``.

A decoder-only GQA transformer: RMSNorm, rotate-half RoPE, SwiGLU, no q/k
norm and no attention bias (Qwen3's module without its per-head norms). The
family covers Llama, Llava's text tower and Mistral (FLUX.2's Mistral-Small
3.2 tower). One forward, no KV cache:

- ``skip_last_layers`` picks the hidden state returned (HF
  ``hidden_states[-(skip+1)]``: 0 is the last layer's output before the final
  norm, which ``normalize_last`` applies);
- ``stack_layers`` (FLUX.2) concatenates ``hidden_states[k]`` of each listed
  k along the features and stops after the deepest one.

Attention takes the causal ∧ padding mask ``[B, 1, S, S]``, a per-query mask,
which goes to the plain-math route (XLA there), as in the JAX package.
``from_dict`` reads the config's top level only, as the JAX one does (a
nested ``text_config`` is not unnested).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear, RMSNorm, SwiGLU
from apex_studio_tpu_torch.models.registry import text_encoder_registry
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.rope import apply_rope_half, rope_freqs_1d


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 128320
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    attention_bias: bool = False
    # which hidden state the conditioning uses (HF hidden_states[-(skip+1)])
    skip_last_layers: int = 2
    # FLUX.2: concatenate hidden_states[k] for these k along the features
    stack_layers: Optional[Tuple[int, ...]] = None

    @classmethod
    def from_dict(cls, cfg: dict) -> "LlamaConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "head_dim" not in kw and "hidden_size" in kw and "num_attention_heads" in kw:
            kw["head_dim"] = kw["hidden_size"] // kw["num_attention_heads"]
        if kw.get("stack_layers") is not None:
            kw["stack_layers"] = tuple(kw["stack_layers"])
        return cls(**kw)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, dtype):
        super().__init__()
        h, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        self.q_proj = Linear(cfg.hidden_size, h * d, use_bias=cfg.attention_bias, dtype=dtype)
        self.k_proj = Linear(cfg.hidden_size, kv * d, use_bias=cfg.attention_bias, dtype=dtype)
        self.v_proj = Linear(cfg.hidden_size, kv * d, use_bias=cfg.attention_bias, dtype=dtype)
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


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, dtype):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg, dtype=dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps)
        self.mlp = SwiGLU(cfg.hidden_size, cfg.intermediate_size, dtype=dtype)

    def forward(self, x, cos, sin, mask):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, mask)
        return x + self.mlp(self.post_attention_layernorm(x))


@text_encoder_registry.register(
    "LlamaModel",
    aliases=("llama", "LlavaForConditionalGeneration", "MistralModel", "Mistral3ForConditionalGeneration"),
)
class LlamaTextEncoder(nn.Module):
    config_class = LlamaConfig

    def __init__(self, cfg: LlamaConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embed_tokens = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, dtype=dtype))
        self.layers = nn.ModuleList([LlamaDecoderLayer(cfg, dtype=dtype) for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                normalize_last: bool = False) -> torch.Tensor:
        """``hidden_states[-(skip+1)]``, or with ``stack_layers`` the listed
        hidden states concatenated (``hidden_states[k]`` is the output after
        k decoder layers, 0 the embeddings)."""
        s = input_ids.shape[1]
        x = self.embed_tokens[input_ids].to(self.dtype)
        cos, sin = rope_freqs_1d(torch.arange(s, device=x.device)[None, :], self.cfg.head_dim,
                                 self.cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask.bool()[:, None, None, :]

        if self.cfg.stack_layers is not None:
            want = [int(k) for k in self.cfg.stack_layers]
            collected = {0: x} if 0 in want else {}
            for i, layer in enumerate(self.layers[:max(want)]):
                x = layer(x, cos, sin, mask)
                if i + 1 in want:
                    collected[i + 1] = x
            return torch.cat([collected[k] for k in want], dim=-1)
        for layer in self.layers[:len(self.layers) - int(self.cfg.skip_last_layers)]:
            x = layer(x, cos, sin, mask)
        if self.cfg.skip_last_layers == 0 and normalize_last:
            x = self.norm(x)
        return x
