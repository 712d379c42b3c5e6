"""Interchangeable attention backends behind one BSHD signature (port of
``apex_studio_tpu/ops/attention/__init__.py``).

Backends:
  - ``flash`` — the hand-written CUDA kernel (ops/attention/flash.py), the
    default; on CPU tensors it runs its plain PyTorch version. One query a
    head past the kernel's head dims runs ``one_query_wide_head_attention``
    on it.
  - ``xla``   — plain math with the semantics of ``jax.nn.dot_product_attention``:
    f32 scores, bias added in f32, f32 softmax cast to the value dtype, P·V.
    No library attention kernel.
  - ``naive`` — the reference einsum (f32 scores and softmax)

A key-padding mask is accepted either as boolean [B, Sk] or as an additive bias.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_studio_tpu_torch.ops.attention.flash import NEG_INF, flash_attention
from apex_studio_tpu_torch.registry import Registry

attention_registry = Registry("attention")


def _prep_bias(bias: Optional[torch.Tensor], mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Combine an additive bias and a boolean mask into one additive bias.
    Masked entries get a finite -1e30: a row whose keys are all masked then
    averages V uniformly instead of turning into NaN."""
    if mask is not None:
        mask = mask.bool()
        if mask.ndim == 2:  # [B, Sk] key-padding
            mask = mask[:, None, None, :]
        zero = torch.zeros((), dtype=torch.float32, device=mask.device)
        neg = torch.full((), NEG_INF, dtype=torch.float32, device=mask.device)
        mbias = torch.where(mask, zero, neg)
        bias = mbias if bias is None else bias + mbias
    return bias


def _plain_attention(q, k, v, bias, scale, causal_diagonal, masked):
    """f32 scores plus bias, f32 softmax, ``p`` cast to ``v.dtype``, P·V. With
    ``causal_diagonal`` set, keys above that diagonal get ``masked``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal_diagonal is not None:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril(causal_diagonal)
        s = s.masked_fill(~keep, masked)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


@attention_registry.register("naive")
def naive_attention(q, k, v, bias=None, scale=None, is_causal=False):
    """Reference einsum (f32 softmax), for tests and tiny shapes. Causal masks
    align bottom-right."""
    diagonal = k.shape[1] - q.shape[1] if is_causal else None
    return _plain_attention(q, k, v, bias, scale, diagonal, NEG_INF)


@attention_registry.register("xla")
def xla_attention(q, k, v, bias=None, scale=None, is_causal=False):
    """Plain-math counterpart of ``jax.nn.dot_product_attention``'s XLA path.
    Causal masks align top-left and use a large finite negative."""
    return _plain_attention(q, k, v, bias, scale, 0 if is_causal else None,
                            -0.7 * torch.finfo(torch.float32).max)


attention_registry.add("flash", flash_attention, default=True)


def one_query_wide_head_attention(q, k, v, bias=None, scale=None):
    """One query a head (Sq == 1) at a head dim past the kernel's 128 (Mochi's
    caption pooler: 8 heads of 512), on the kernel: the f32 scores q·kᵀ·scale
    (+ the key bias) become the kernel's key bias over zero q and k, so the
    kernel takes exactly those scores into its softmax, and v's 128-wide (or
    64-wide) slices are its heads, each weighted by the same softmax. One
    launch; [B, 1, H, D] like ``flash_attention``."""
    b, _, h, d = q.shape
    sk = k.shape[1]
    width = 128 if d % 128 == 0 else 64
    if d % width:
        raise ValueError(f"a wide-head query needs a head dim that is a multiple of 64, got {d}")
    scale = scale if scale is not None else d ** -0.5
    scores = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float().reshape(bias.shape[0], 1, sk)
    parts = d // width
    vs = v.permute(0, 2, 1, 3).reshape(b * h, sk, parts, width)
    zq = torch.zeros(b * h, 1, parts, width, dtype=v.dtype, device=v.device)
    zk = torch.zeros(b * h, sk, parts, width, dtype=v.dtype, device=v.device)
    out = flash_attention(zq, zk, vs, bias=scores.reshape(b * h, sk), scale=1.0)
    return out.reshape(b, h, 1, d).transpose(1, 2)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    is_causal: bool = False,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Unified attention entry point. q/k/v: [B, S, H, D]; returns [B, Sq, H, D]."""
    bias = _prep_bias(bias, mask)
    name = backend or "flash"
    if name == "flash" and bias is not None and bias.ndim == 4 and (
            bias.shape[1] != 1 or bias.shape[2] != 1):
        # The kernel takes a key-padding bias only; per-head or per-query
        # biases go to the plain-math backend.
        name = "xla"
    if name == "flash" and q.shape[1] == 1 and q.shape[-1] > 128 and not is_causal:
        return one_query_wide_head_attention(q, k, v, bias=bias, scale=scale)
    return attention_registry.get(name)(q, k, v, bias=bias, scale=scale, is_causal=is_causal)
