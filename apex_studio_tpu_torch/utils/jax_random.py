"""JAX's default random stream (threefry2x32, partitionable bits) on the host,
in numpy: ``key``, ``fold_in`` and ``normal`` draw what ``jax.random.key``,
``jax.random.fold_in`` and ``jax.random.normal(key, shape, float32)`` draw.

The LTX VAE's decoder injects spatial noise from keys folded out of one
decode key; the port draws the same noise so that a decode matches the JAX
package's. A key is a uint32 array of two words.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The 20-round Threefry-2x32 block cipher of ``key`` over the count
    words ``(x0, x1)``, element-wise (uint32 arithmetic wraps)."""
    ks = (np.uint32(key[0]), np.uint32(key[1]), np.uint32(key[0]) ^ np.uint32(key[1]) ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s two words (32-bit JAX: the seed's low word)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``."""
    a, b = threefry2x32(k, np.zeros(1, np.uint32), np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def normal(k: np.ndarray, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)`` as an f32 tensor: the bits of
    each flat index's count, a uniform in [nextafter(−1, 0), 1), then
    √2·erfinv (in float64, rounded to f32)."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi, lo = threefry2x32(k, (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = hi ^ lo
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo_val = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo_val, floats * np.float32(1.0 - lo_val) + lo_val).astype(np.float32)
    z = torch.special.erfinv(torch.from_numpy(u).double()).float() * np.float32(np.sqrt(2.0))
    return z.reshape(tuple(shape)).to(device)
