"""Carry the JAX package's parameters into the port's modules.

The port keeps the JAX attribute names, so the mapping is mechanical:

- ``...kernel`` becomes ``...weight``; a 2-D Linear kernel [in, out] is
  transposed to [out, in] and a 4-D conv kernel HWIO to OIHW;
- every other parameter keeps its name and layout.

The input is a flat ``{dotted.nnx.path: np.ndarray}`` dict (list indices are
path components, e.g. ``transformer_blocks.0.attn.to_q.kernel``). Loading is
strict: every key must land on a port parameter and every port parameter must
be filled, or it raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def convert_jax_params(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rename and re-lay out a flat JAX parameter dict into port keys."""
    out: Dict[str, np.ndarray] = {}
    for key, value in flat.items():
        arr = np.asarray(value)
        parts = key.split(".")
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{key}: kernel of rank {arr.ndim} has no known layout")
        out[".".join(parts)] = arr
    return out


def load_from_jax(module: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy ``flat`` (JAX parameter paths) into ``module`` in place, strictly.
    Values are cast to each port parameter's dtype and device."""
    params = dict(module.named_parameters())
    converted = convert_jax_params(flat)
    unexpected = sorted(set(converted) - set(params))
    missing = sorted(set(params) - set(converted))
    if unexpected or missing:
        raise KeyError(f"JAX→port carry mismatch: unexpected {unexpected[:8]}, missing {missing[:8]}")
    with torch.no_grad():
        for name, arr in converted.items():
            p = params[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {arr.shape} vs port {tuple(p.shape)}")
            src = torch.from_numpy(np.array(arr, dtype=np.float32))
            p.copy_(src.to(device=p.device, dtype=p.dtype))
    return module
