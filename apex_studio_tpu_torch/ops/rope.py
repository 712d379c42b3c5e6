"""Rotary position embeddings, real-valued (port of ``ops/rope.py``).

Interleaved-pair convention (``apply_rope``, the DiTs): feature pairs
(2i, 2i+1) rotate together by the cos/sin tables of shape [..., head_dim/2].
Rotate-half convention (``apply_rope_half``, the HF Llama/Qwen LLMs): feature
i rotates with feature i + head_dim/2. Tables for numpy positions are built
in float64 and cast to float32; tensor positions take a float32 path, as in the
JAX functions.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

Positions = Union[np.ndarray, torch.Tensor]


def rope_freqs_1d(positions: Positions, dim: int, theta: float = 10000.0):
    """cos/sin tables [*pos.shape, dim//2] in float32 (numpy in, numpy out;
    tensor in, tensor out)."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    if not isinstance(positions, torch.Tensor):
        angles = np.asarray(positions, np.float64)[..., None] * inv
        return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)
    inv32 = torch.as_tensor(inv, dtype=torch.float32, device=positions.device)
    angles = positions.float()[..., None] * inv32
    return torch.cos(angles), torch.sin(angles)


def precompute_axial_freqs(ids: Positions, axes_dims: Sequence[int], theta: float = 10000.0):
    """Multi-axis tables: axis i of ``ids`` [..., n_axes] contributes
    ``axes_dims[i]/2`` rotary pairs. Output cos/sin [..., sum(axes_dims)//2]."""
    assert ids.shape[-1] == len(axes_dims), (ids.shape, axes_dims)
    cos_parts, sin_parts = [], []
    for i, d in enumerate(axes_dims):
        c, s = rope_freqs_1d(ids[..., i], d, theta)
        cos_parts.append(c)
        sin_parts.append(s)
    if isinstance(ids, torch.Tensor):
        return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)
    return np.concatenate(cos_parts, axis=-1), np.concatenate(sin_parts, axis=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved feature pairs of ``x`` [..., H, D] by cos/sin
    [..., D//2] (broadcast over the head axis), in float32."""
    x32 = x.float()
    xr = x32[..., 0::2]
    xi = x32[..., 1::2]
    out_r = xr * cos - xi * sin
    out_i = xr * sin + xi * cos
    return torch.stack([out_r, out_i], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE: ``x·cos + rotate_half(x)·sin`` in float32 with
    ``rotate_half(x) = [-x[D/2:], x[:D/2]]``; cos/sin [..., D//2] are tiled to
    D and broadcast over the head axis."""
    x32 = x.float()
    d2 = x.shape[-1] // 2
    cos2 = torch.cat([cos, cos], dim=-1)
    sin2 = torch.cat([sin, sin], dim=-1)
    rotated = torch.cat([-x32[..., d2:], x32[..., :d2]], dim=-1)
    return (x32 * cos2 + rotated * sin2).to(x.dtype)
