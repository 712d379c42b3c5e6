"""Gemma-3 text tower, port of ``apex_studio_tpu/models/text_encoders/gemma3.py``.

LTX-2's conditioning encoder (``Gemma3ForConditionalGeneration`` in the
manifests; only the text tower is built). Against the Llama-style towers:

- embeddings scaled by sqrt(hidden) in the model dtype;
- RMSNorm with zero-centred gamma, applied as (1 + w);
- sandwich norms: the attention and feed-forward outputs are normed before
  each residual add;
- per-head q/k RMSNorm; the query scaled by ``query_pre_attn_scalar^-0.5``;
- local layers (sliding window, theta 10k) and every ``sliding_window_pattern``-th
  layer global (theta 1M over ``positions / rope_scaling_factor``, float
  positions);
- a GeGLU MLP (tanh-GELU gate).

The masks are ``[B, 1, S, S]`` (causal, banded for the local layers, ∧ key
padding) at head dim 256: the JAX front sends such a mask to XLA, and the
port's front sends it to its plain-math route, as for the other encoders.
``output_hidden_states`` stacks the embedding output and every layer's output,
the last one after the final norm, on a trailing axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear
from apex_studio_tpu_torch.models.registry import text_encoder_registry
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.rope import apply_rope_half, rope_freqs_1d


@dataclasses.dataclass
class Gemma3Config:
    vocab_size: int = 262208
    hidden_size: int = 3840
    intermediate_size: int = 15360
    num_hidden_layers: int = 48
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    rope_local_base_freq: float = 10_000.0
    rope_scaling_factor: float = 8.0
    query_pre_attn_scalar: float = 256.0
    sliding_window: int = 1024
    sliding_window_pattern: int = 6  # every Nth layer is global
    skip_last_layers: int = 0

    @classmethod
    def from_dict(cls, cfg: dict) -> "Gemma3Config":
        merged = dict(cfg["text_config"]) if "text_config" in cfg else dict(cfg)
        if isinstance(merged.get("rope_scaling"), dict):
            merged["rope_scaling_factor"] = merged["rope_scaling"].get("factor", 8.0)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in merged.items() if k in known})


class GemmaRMSNorm(nn.Module):
    """RMSNorm with zero-centred gamma: y = x̂ · (1 + w), in f32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim, dtype=torch.float32))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (xf * (1.0 + self.weight)).to(x.dtype)


class Gemma3Attention(nn.Module):
    def __init__(self, cfg: Gemma3Config, is_global: bool, *, dtype):
        super().__init__()
        h, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        self.q_proj = Linear(cfg.hidden_size, h * d, use_bias=False, dtype=dtype)
        self.k_proj = Linear(cfg.hidden_size, kv * d, use_bias=False, dtype=dtype)
        self.v_proj = Linear(cfg.hidden_size, kv * d, use_bias=False, dtype=dtype)
        self.o_proj = Linear(h * d, cfg.hidden_size, use_bias=False, dtype=dtype)
        self.q_norm = GemmaRMSNorm(d, cfg.rms_norm_eps)
        self.k_norm = GemmaRMSNorm(d, cfg.rms_norm_eps)
        self.heads, self.kv_heads, self.head_dim = h, kv, d
        self.scale = cfg.query_pre_attn_scalar ** -0.5
        self.is_global = is_global

    def forward(self, x, cos, sin, mask):
        b, s, _ = x.shape
        q = self.q_norm(self.q_proj(x).reshape(b, s, self.heads, self.head_dim))
        k = self.k_norm(self.k_proj(x).reshape(b, s, self.kv_heads, self.head_dim))
        v = self.v_proj(x).reshape(b, s, self.kv_heads, self.head_dim)
        q = apply_rope_half(q.to(x.dtype), cos, sin)
        k = apply_rope_half(k.to(x.dtype), cos, sin)
        rep = self.heads // self.kv_heads
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = attention_op(q, k, v, mask=mask, scale=self.scale)
        return self.o_proj(out.reshape(b, s, -1))


class Gemma3Layer(nn.Module):
    def __init__(self, cfg: Gemma3Config, is_global: bool, *, dtype):
        super().__init__()
        eps = cfg.rms_norm_eps
        self.input_layernorm = GemmaRMSNorm(cfg.hidden_size, eps)
        self.self_attn = Gemma3Attention(cfg, is_global, dtype=dtype)
        self.post_attention_layernorm = GemmaRMSNorm(cfg.hidden_size, eps)
        self.pre_feedforward_layernorm = GemmaRMSNorm(cfg.hidden_size, eps)
        self.gate_proj = Linear(cfg.hidden_size, cfg.intermediate_size, use_bias=False, dtype=dtype)
        self.up_proj = Linear(cfg.hidden_size, cfg.intermediate_size, use_bias=False, dtype=dtype)
        self.down_proj = Linear(cfg.intermediate_size, cfg.hidden_size, use_bias=False, dtype=dtype)
        self.post_feedforward_layernorm = GemmaRMSNorm(cfg.hidden_size, eps)
        self.is_global = is_global

    def forward(self, x, cos, sin, mask):
        h = self.self_attn(self.input_layernorm(x), cos, sin, mask)
        x = x + self.post_attention_layernorm(h)
        h = self.pre_feedforward_layernorm(x)
        h = self.down_proj(F.gelu(self.gate_proj(h), approximate="tanh") * self.up_proj(h))
        return x + self.post_feedforward_layernorm(h)


@text_encoder_registry.register("Gemma3ForConditionalGeneration",
                                aliases=("gemma3", "Gemma3TextModel", "Gemma3Model"))
class Gemma3TextEncoder(nn.Module):
    config_class = Gemma3Config

    def __init__(self, cfg: Gemma3Config, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embed_tokens = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, dtype=dtype))
        p = cfg.sliding_window_pattern
        self.layers = nn.ModuleList([Gemma3Layer(cfg, is_global=(i + 1) % p == 0, dtype=dtype)
                                     for i in range(cfg.num_hidden_layers)])
        self.norm = GemmaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                normalize_last: bool = True, output_hidden_states: bool = False) -> torch.Tensor:
        """The final hidden states [B, S, D] (after the final norm unless
        ``normalize_last`` is False); with ``output_hidden_states`` the stack
        [B, S, D, layers + 1] (HF ``hidden_states``, the last entry
        post-norm), which LTX-2's connectors consume whole."""
        cfg = self.cfg
        s = input_ids.shape[1]
        x = self.embed_tokens[input_ids].to(self.dtype)
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=self.dtype)
        dev = x.device
        positions = torch.arange(s, device=dev)[None, :]
        cos_g, sin_g = rope_freqs_1d(positions / cfg.rope_scaling_factor, cfg.head_dim, cfg.rope_theta)
        cos_l, sin_l = rope_freqs_1d(positions, cfg.head_dim, cfg.rope_local_base_freq)
        cos_g, sin_g, cos_l, sin_l = (t[:, :, None, :] for t in (cos_g, sin_g, cos_l, sin_l))

        causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        pos = positions[0]
        band = causal & ((pos[:, None] - pos[None, :]) < cfg.sliding_window)
        mask_g, mask_l = causal[None, None], band[None, None]
        if attention_mask is not None:
            pad = attention_mask.bool()[:, None, None, :]
            mask_g, mask_l = mask_g & pad, mask_l & pad

        collected = [x] if output_hidden_states else None
        for layer in self.layers[: len(self.layers) - cfg.skip_last_layers]:
            if layer.is_global:
                x = layer(x, cos_g, sin_g, mask_g)
            else:
                x = layer(x, cos_l, sin_l, mask_l)
            if output_hidden_states:
                collected.append(x)
        if cfg.skip_last_layers == 0 and normalize_last:
            x = self.norm(x)
        if output_hidden_states:
            collected[-1] = x  # HF: the final entry is the post-norm output
            return torch.stack(collected, dim=-1)
        return x
