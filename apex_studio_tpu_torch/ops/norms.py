"""Normalization and adaLN modulation primitives (port of ``ops/norms.py``).

All reductions accumulate in float32 regardless of the activation dtype, and
the result is cast back to the input dtype, exactly as the JAX functions do.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def modulate(x: torch.Tensor, scale: torch.Tensor, shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """adaLN input modulation: x * (1 + scale) (+ shift)."""
    out = x * (1.0 + scale.to(x.dtype))
    if shift is not None:
        out = out + shift.to(x.dtype)
    return out


def gate(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """adaLN output gating: x * g."""
    return x * g.to(x.dtype)
