"""``jax.image.resize`` in PyTorch.

The JAX package resizes with ``jax.image.resize``, which is not
``F.interpolate``: its pixels are half-pixel centred, its cubic is Keys' with
a = -0.5 (torch's bicubic uses -0.75), and with ``antialias`` (the default) a
downscale widens the kernel by the scale, so that it low-pass filters; each
output's weights are then normalised to sum to 1. Its nearest takes the input
index ⌊(i + 0.5)·n_in / n_out⌋ in f32. Each axis whose size changes is resized
on its own by one weight matrix, as in JAX (``jax/_src/image/scale.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x.abs()).clamp_min(0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"linear": _triangle, "bilinear": _triangle, "trilinear": _triangle, "triangle": _triangle,
            "cubic": _keys_cubic, "bicubic": _keys_cubic}


def resize_weights(n_in: int, n_out: int, method: str, antialias: bool = True,
                   device=None, dtype=torch.float32) -> torch.Tensor:
    """``[n_in, n_out]`` weights of one axis of ``jax.image.resize``: the
    kernel at |sample - input index| (widened by ``n_in / n_out`` on a
    downscale with ``antialias``), each column normalised to sum 1, and
    columns whose sample lies outside the input zeroed."""
    kernel = _KERNELS[method]
    inv = n_in / n_out
    kernel_scale = max(inv, 1.0) if antialias else 1.0
    sample = (torch.arange(n_out, dtype=torch.float64) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float64)[:, None]).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device=device, dtype=dtype)


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """``jax.image.resize(..., "nearest")``'s source index along one axis:
    ⌊f32((i + 0.5)·n_in) / f32(n_out)⌋."""
    return np.floor((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in)
                    / np.float32(n_out)).astype(np.int64)


def resize(x: torch.Tensor, shape: Sequence[int], method: str, antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(x, shape, method, antialias)``: every axis whose
    size differs from ``shape`` is resized (``nearest``, ``linear`` /
    ``bilinear`` / ``trilinear`` / ``triangle`` or ``cubic`` / ``bicubic``); a float result keeps ``x``'s
    dtype, an integer input comes back as f32."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} does not match the rank of {tuple(x.shape)}")
    if method != "nearest" and not x.is_floating_point():
        x = x.float()
    for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        if method == "nearest":
            x = x.index_select(axis, torch.from_numpy(nearest_index(n_in, n_out)).to(x.device))
        else:
            w = resize_weights(n_in, n_out, method, antialias, x.device, x.dtype)
            x = torch.tensordot(x, w, dims=([axis], [0])).movedim(-1, axis)
    return x
