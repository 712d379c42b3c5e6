"""Qwen3 causal LM, port of ``apex_studio_tpu/models/text_encoders/qwen3.py``.

ZImage conditions on Qwen3-4B hidden states: the forward returns the last
decoder layer's output before the final norm (HF ``hidden_states[-2]``);
``normalize_last`` applies the final norm. A decoder-only GQA transformer
(32 query heads share 8 key/value heads at 4B, repeated with
``repeat_interleave`` as ``jnp.repeat`` does), per-head q/k RMSNorm,
rotate-half RoPE and SwiGLU.

Attention routes as the JAX package routes it: the encode and ``prefill``
pass a causal ∧ padding mask ``[B, 1, S, S]``, a per-query bias, which goes to
the plain-math route (XLA there); ``decode_step``'s single query attends the
cache through the flash kernel with the valid prefix as a ``[B, L]``
key-padding bias.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear, RMSNorm, SwiGLU
from apex_studio_tpu_torch.models.registry import text_encoder_registry
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.rope import apply_rope_half, rope_freqs_1d

Cache = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class Qwen3Config:
    vocab_size: int = 151936
    hidden_size: int = 2560
    intermediate_size: int = 9728
    num_hidden_layers: int = 36
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    attention_bias: bool = False

    @classmethod
    def from_dict(cls, cfg: dict) -> "Qwen3Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in known})


class Qwen3Attention(nn.Module):
    def __init__(self, cfg: Qwen3Config, *, dtype):
        super().__init__()
        h, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        self.q_proj = Linear(cfg.hidden_size, h * d, use_bias=cfg.attention_bias, dtype=dtype)
        self.k_proj = Linear(cfg.hidden_size, kv * d, use_bias=cfg.attention_bias, dtype=dtype)
        self.v_proj = Linear(cfg.hidden_size, kv * d, use_bias=cfg.attention_bias, dtype=dtype)
        self.o_proj = Linear(h * d, cfg.hidden_size, use_bias=False, dtype=dtype)
        self.q_norm = RMSNorm(d, eps=cfg.rms_norm_eps)
        self.k_norm = RMSNorm(d, eps=cfg.rms_norm_eps)
        self.heads, self.kv_heads, self.head_dim = h, kv, d

    def qkv(self, x, cos, sin):
        """q, k (normed, rotated) and v, k/v before the GQA repeat."""
        b, s, _ = x.shape
        q = self.q_norm(self.q_proj(x).reshape(b, s, self.heads, self.head_dim))
        k = self.k_norm(self.k_proj(x).reshape(b, s, self.kv_heads, self.head_dim))
        v = self.v_proj(x).reshape(b, s, self.kv_heads, self.head_dim)
        return apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin), v

    def attend(self, q, k, v, mask):
        rep = self.heads // self.kv_heads
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = attention_op(q, k, v, mask=mask, is_causal=mask is None)
        return self.o_proj(out.reshape(q.shape[0], q.shape[1], -1))

    def forward(self, x, cos, sin, mask):
        return self.attend(*self.qkv(x, cos, sin), mask)

    def step(self, x, cos, sin, cache_k, cache_v, pos: int):
        """One-token decode: write this position's (pre-repeat) K/V into the
        fixed-size cache ``[B, L, kv_heads, d]`` at ``pos``, in place, and
        attend the single query over the cache's valid prefix (keys ≤ pos)."""
        q, k, v = self.qkv(x, cos, sin)
        cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
        valid = torch.arange(cache_k.shape[1], device=x.device) <= pos
        mask = valid[None, :].expand(x.shape[0], -1)
        out = self.attend(q, cache_k.to(q.dtype), cache_v.to(q.dtype), mask)
        return out, cache_k, cache_v


class Qwen3DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen3Config, *, dtype):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps)
        self.self_attn = Qwen3Attention(cfg, dtype=dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps)
        self.mlp = SwiGLU(cfg.hidden_size, cfg.intermediate_size, dtype=dtype)

    def forward(self, x, cos, sin, mask):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, mask)
        return x + self.mlp(self.post_attention_layernorm(x))

    def step(self, x, cos, sin, cache_k, cache_v, pos: int):
        attn, cache_k, cache_v = self.self_attn.step(self.input_layernorm(x), cos, sin,
                                                     cache_k, cache_v, pos)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x)), cache_k, cache_v


@text_encoder_registry.register("Qwen3ForCausalLM", aliases=("qwen3",))
class Qwen3TextEncoder(nn.Module):
    config_class = Qwen3Config

    def __init__(self, cfg: Qwen3Config, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embed_tokens = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, dtype=dtype))
        self.layers = nn.ModuleList([Qwen3DecoderLayer(cfg, dtype=dtype)
                                     for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps)

    def _rope(self, positions: torch.Tensor):
        cos, sin = rope_freqs_1d(positions, self.cfg.head_dim, self.cfg.rope_theta)
        return cos[:, :, None, :], sin[:, :, None, :]  # broadcast over heads

    def _prompt(self, input_ids, attention_mask):
        """Embeddings, RoPE tables and the causal ∧ padding mask [B, 1, S, S]."""
        s = input_ids.shape[1]
        x = self.embed_tokens[input_ids].to(self.dtype)
        cos, sin = self._rope(torch.arange(s, device=x.device)[None, :])
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask.bool()[:, None, None, :]
        return x, cos, sin, mask

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                normalize_last: bool = False) -> torch.Tensor:
        """The last decoder layer's output (HF ``hidden_states[-2]``);
        ``normalize_last=True`` applies the final norm (``last_hidden_state``)."""
        x, cos, sin, mask = self._prompt(input_ids, attention_mask)
        for layer in self.layers:
            x = layer(x, cos, sin, mask)
        return self.norm(x) if normalize_last else x

    # -- KV-cached autoregressive decode (prompt extension) -------------------

    def init_cache(self, batch: int, cache_len: int) -> Cache:
        """Per-layer (k, v) caches [B, L, kv_heads, head_dim], zero."""
        shape = (batch, cache_len, self.cfg.num_key_value_heads, self.cfg.head_dim)
        dev = self.embed_tokens.device
        return [(torch.zeros(shape, dtype=self.dtype, device=dev),
                 torch.zeros(shape, dtype=self.dtype, device=dev)) for _ in self.layers]

    def prefill(self, input_ids, attention_mask, cache_len: int, normalize_last: bool = True):
        """Full forward over the prompt that also fills the KV caches. Returns
        (hidden [B, S, D], caches zero-padded to ``cache_len``)."""
        x, cos, sin, mask = self._prompt(input_ids, attention_mask)
        b, s = input_ids.shape
        caches: Cache = []
        for layer in self.layers:
            att = layer.self_attn
            q, k, v = att.qkv(layer.input_layernorm(x), cos, sin)
            ck = torch.zeros(b, cache_len, att.kv_heads, att.head_dim, dtype=self.dtype, device=x.device)
            cv = torch.zeros_like(ck)
            ck[:, :s], cv[:, :s] = k, v
            caches.append((ck, cv))
            x = x + att.attend(q, k, v, mask)
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        return (self.norm(x) if normalize_last else x), caches

    def decode_step(self, token_ids, pos: int, caches: Cache, normalize_last: bool = True):
        """One cached decode step: ``token_ids`` [B, 1] at position ``pos``.
        Writes that position's K/V into ``caches`` in place and returns
        (hidden [B, 1, D], caches)."""
        x = self.embed_tokens[token_ids].to(self.dtype)
        cos, sin = self._rope(torch.full((1, 1), int(pos), dtype=torch.int32, device=x.device))
        new_caches: Cache = []
        for layer, (ck, cv) in zip(self.layers, caches):
            x, ck, cv = layer.step(x, cos, sin, ck, cv, int(pos))
            new_caches.append((ck, cv))
        return (self.norm(x) if normalize_last else x), new_caches
