"""Apply a (converted) torch-layout state dict onto one of the port's modules
(port of ``apex_studio_tpu/loaders/state_mapping.py``).

Converted keys name the JAX package's leaves, so a Linear or conv weight ends
in ``.kernel``; the port's parameter is ``.weight`` and already has torch's
layout (Linear ``[out, in]``, conv ``OIHW``), so where the JAX loader
transposes, this one copies. What remains of the layout rules:

- a conv-style weight ``[O, C, *k]`` loaded into a Linear (a patch embedding,
  a 1×1-conv attention projection) is flattened to ``[O, C·∏k]``;
- a pure rank mismatch with equal element count (broadcast singletons) is
  reshaped; a same-rank mismatch is an error.

A module built on the ``meta`` device is filled tensor by tensor: each value
is cast to the target's dtype and moved to ``device`` on its own, so neither
the host nor the card ever holds a second full copy of the model.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn


def _as_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if not arr.flags.writeable:  # a view of a read-only memory map
        arr = arr.copy()
    return torch.from_numpy(arr)


def port_path(path: str) -> str:
    """Converted (JAX-leaf) path → the port's parameter path: ``.kernel`` →
    ``.weight``, and a raw ``..._kernel`` matrix (the Wan VAE attention's
    ``to_qkv_kernel``) → ``..._weight``, both already in torch's layout."""
    parent, dot, leaf = path.rpartition(".")
    if leaf == "kernel":
        return parent + dot + "weight"
    if leaf.endswith("_kernel"):
        return parent + dot + leaf[: -len("kernel")] + "weight"
    return path


def _reconcile_shape(t: torch.Tensor, target_shape: Tuple[int, ...]) -> torch.Tensor:
    """Layout fixes the names cannot express. Never reshapes a same-rank
    mismatch: those are real errors and are reported by the caller."""
    if tuple(t.shape) == target_shape:
        return t
    if len(target_shape) == 2 and t.ndim > 2:
        # conv-style weight flattened into a Linear: [O, C, *k] → [O, C·∏k]
        return t.reshape(t.shape[0], -1)
    if t.ndim != len(target_shape) and t.numel() == int(np.prod(target_shape)):
        return t.reshape(target_shape)
    return t


def _targets(module: nn.Module) -> Dict[str, torch.Tensor]:
    out = dict(module.named_parameters())
    out.update({k: v for k, v in module.named_buffers() if v is not None})
    return out


def apply_state_dict(
    module: nn.Module,
    state: Mapping[str, Any],
    *,
    device: Optional[Union[str, torch.device]] = None,
    strict: bool = True,
) -> Tuple[List[str], List[str]]:
    """Assign every entry of ``state`` (converted keys) into ``module``.

    Returns (missing_in_checkpoint, unexpected_in_checkpoint), both against
    the module's parameters and buffers; with ``strict`` either raises
    ``KeyError``. A shape that does not fit raises ``ValueError`` always.
    ``device`` is where tensors of a ``meta``-built module land (required for
    such a module); tensors that already have storage are copied in place.
    """
    targets = _targets(module)
    applied = set()
    unexpected: List[str] = []
    with torch.no_grad():
        for key, value in state.items():
            path = port_path(key)
            target = targets.get(path)
            if target is None:
                unexpected.append(key)
                continue
            src = _reconcile_shape(_as_tensor(value), tuple(target.shape))
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(f"{path}: shape mismatch, model {tuple(target.shape)} "
                                 f"vs checkpoint {tuple(src.shape)}")
            if target.is_meta:
                if device is None:
                    raise ValueError(f"{path}: the module is on the meta device; pass device=")
                _assign(module, path, src.to(device=device, dtype=target.dtype))
            else:
                target.copy_(src.to(device=target.device, dtype=target.dtype))
            applied.add(path)

    missing = sorted(set(targets) - applied)
    if strict and unexpected:
        raise KeyError(f"checkpoint keys not in model: {unexpected[:8]}{'…' if len(unexpected) > 8 else ''}")
    if strict and missing:
        raise KeyError(f"model params missing from checkpoint: {missing[:8]}{'…' if len(missing) > 8 else ''}")
    return missing, unexpected


def _assign(module: nn.Module, path: str, value: torch.Tensor) -> None:
    """Give the ``meta`` parameter or buffer at ``path`` its storage."""
    parent, _, leaf = path.rpartition(".")
    owner = module.get_submodule(parent) if parent else module
    if leaf in owner._parameters:
        owner._parameters[leaf] = nn.Parameter(value, requires_grad=False)
    else:
        owner._buffers[leaf] = value
