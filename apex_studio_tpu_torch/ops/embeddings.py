"""Scalar-conditioning embeddings (port of ``ops/embeddings.py``)."""

from __future__ import annotations

import math

import torch


def timestep_embedding(
    t: torch.Tensor,
    dim: int,
    max_period: float = 10000.0,
    scale: float = 1.0,
    flip_sin_to_cos: bool = True,
) -> torch.Tensor:
    """Sinusoidal timestep embedding in float32. ``flip_sin_to_cos=True``
    gives [cos | sin] ordering, False gives [sin | cos]."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = scale * t.float()[..., None] * freqs
    if flip_sin_to_cos:
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    else:
        emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb
