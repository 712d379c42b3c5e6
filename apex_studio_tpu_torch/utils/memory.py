"""Parameter size against free device memory (the gate of
``apex_studio_tpu/parallel/host_offload.py``; block streaming itself is not
ported)."""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn


def params_nbytes(model: nn.Module) -> int:
    """Total bytes of every parameter and buffer of the module."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def free_memory_bytes(device: Union[str, torch.device]) -> Optional[int]:
    """Free memory of a CUDA device (``torch.cuda.mem_get_info``, so other
    residents count against it), or None for a device that reports none."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[0])


def should_stream(model: nn.Module, *, device: Union[str, torch.device],
                  fraction: float = 0.75) -> bool:
    """True when the model's parameters alone would take ``fraction`` of the
    device's free memory: the gate the engine consults before it falls back to
    int8 residency."""
    free = free_memory_bytes(device)
    return free is not None and params_nbytes(model) > fraction * free
