"""int8 / int4 weight residency (port of ``apex_studio_tpu/quantize/residency.py``).

Every large ``Linear`` weight is stored on the card quantized, with one f32
scale per output channel: int8 ``[out, in]``, or int4 nibble-packed into uint8
``[out/2, in]``. ``Linear`` computes int8 weights W8A8 (``torch._int_mm``) and
int4 weights by unpacking into the compute dtype (models/layers.py).

Layouts: the port's weights are ``[out, in]``, the JAX package's kernels
``[in, out]``; every array here is the transpose of its JAX counterpart, byte
for byte. For int4 that makes the packed array ``[out/2, in]`` with the low
nibble holding output row ``j`` and the high nibble row ``j + out/2``, values
offset-binary (``q + 8``, ``q ∈ [-8, 7]``).
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear

# Weights below this many elements stay in the compute dtype (embedding- and
# bias-sized weights are cheap and more scale-sensitive).
DEFAULT_MIN_NUMEL = 1 << 20


def _quantize(w: torch.Tensor, qmax: int, qmin: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel (row of ``[out, in]``) absmax quantization
    in f32 on ``w``'s device: integer values in int16 and the f32 scales. An
    all-zero row takes scale 1. Rounds half to even."""
    w = w.float()
    scale = w.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True) / float(qmax)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(w / scale).clamp_(qmin, qmax).to(torch.int16)
    return q, scale.reshape(-1)


def _quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    q, scale = _quantize(w, 127, -127)
    return q.to(torch.int8), scale


def _quantize_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if w.ndim != 2 or w.shape[0] % 2:
        raise ValueError(f"int4 packing needs a 2-D weight with an even number of rows, got {tuple(w.shape)}")
    q, scale = _quantize(w, 7, -8)
    q = (q + 8).to(torch.uint8)  # offset-binary, [0, 15]
    half = w.shape[0] // 2
    return q[:half] | (q[half:] << 4), scale


def quantize_kernel_int8(weight: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel (row of ``[out, in]``) absmax int8."""
    q, scale = _quantize_int8(torch.from_numpy(np.array(weight, np.float32)))
    return q.numpy(), scale.numpy()


def quantize_kernel_int4(weight: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel absmax int4 of ``[out, in]`` (``out`` even),
    nibble-packed to uint8 ``[out/2, in]`` in the plane layout described above,
    so the product splits into two halves instead of an interleaving gather."""
    q, scale = _quantize_int4(torch.from_numpy(np.array(weight, np.float32)))
    return q.numpy(), scale.numpy()


def _is_quantizable(mod: nn.Module, min_numel: int, bits: int) -> bool:
    if not isinstance(mod, Linear) or mod.weight_scale is not None:
        return False
    w = mod.weight
    if w.ndim != 2 or w.numel() < min_numel:
        return False
    return bits == 8 or w.shape[0] % 2 == 0  # an odd ``out`` cannot be nibble-paired


def count_resident(model: nn.Module) -> int:
    """How many Linear weights of ``model`` are stored quantized."""
    return sum(isinstance(m, Linear) and m.weight_scale is not None for m in model.modules())


def _apply_residency(model: nn.Module, bits: int, min_numel: int) -> int:
    quantize = _quantize_int4 if bits == 4 else _quantize_int8
    n = 0
    with torch.no_grad():
        for mod in model.modules():
            if _is_quantizable(mod, min_numel, bits):
                mod.set_quantized(*quantize(mod.weight), bits)
                n += 1
    return n


def apply_int8_residency(model: nn.Module, *, min_numel: int = DEFAULT_MIN_NUMEL) -> int:
    """Quantize every large Linear weight of ``model`` to int8 in place, on the
    device it lies on. Returns the number of weights quantized. Each weight is
    quantized and replaced before the next is touched, so at most one weight
    exists in both forms (and in f32 for the length of its quantization)."""
    return _apply_residency(model, 8, min_numel)


def apply_int4_residency(model: nn.Module, *, min_numel: int = DEFAULT_MIN_NUMEL) -> int:
    """``apply_int8_residency`` to packed int4; a weight with an odd number of
    output channels keeps its dtype."""
    return _apply_residency(model, 4, min_numel)


def _materialize_random(model: nn.Module, bits: int, device: Union[str, torch.device],
                        min_numel: int, seed: int, scale: float) -> int:
    device = torch.device(device)
    consts: Dict[int, float] = {}
    n = 0
    for mod in model.modules():
        if not _is_quantizable(mod, min_numel, bits):
            continue
        out_f, in_f = mod.weight.shape
        shape, dtype = ((out_f // 2, in_f), torch.uint8) if bits == 4 else ((out_f, in_f), torch.int8)
        mod.set_quantized(torch.empty(shape, dtype=dtype, device="meta"),
                          torch.empty(out_f, dtype=torch.float32, device="meta"), bits)
        n += 1
    model.to_empty(device=device)
    for mod in model.modules():  # after to_empty: it makes new tensor objects
        if isinstance(mod, Linear) and mod.weight_scale is not None:
            qmax = 7.0 if mod.weight_bits == 4 else 127.0
            consts[id(mod.weight_scale)] = float(scale / np.sqrt(mod.weight.shape[1]) / qmax)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if id(t) in consts:
                t.fill_(consts[id(t)])
            elif t.dtype == torch.int8:
                t.random_(-127, 128, generator=gen)
            elif t.dtype == torch.uint8:
                t.random_(0, 256, generator=gen)
            elif t.is_floating_point():
                t.normal_(0.0, scale, generator=gen)
            else:
                t.zero_()
    return n


def materialize_random_int8(model: nn.Module, *, device: Union[str, torch.device],
                            min_numel: int = DEFAULT_MIN_NUMEL, seed: int = 0,
                            scale: float = 0.02) -> int:
    """Give a ``meta``-built model storage on ``device`` and random weights,
    large Linear weights directly as int8: no full-precision copy of them is
    ever allocated. Values are random, placement is real.

    Everything is drawn on ``device`` from one seeded ``torch.Generator``:
    int8 uniform in [-127, 127], every other floating tensor normal(0,
    ``scale``), each quantized weight's scales the constant
    ``scale / sqrt(fan_in) / 127``. Returns the number of resident weights.
    """
    return _materialize_random(model, 8, device, min_numel, seed, scale)


def materialize_random_int4(model: nn.Module, *, device: Union[str, torch.device],
                            min_numel: int = DEFAULT_MIN_NUMEL, seed: int = 0,
                            scale: float = 0.02) -> int:
    """``materialize_random_int8`` with large Linear weights as packed int4
    (bytes uniform in [0, 255], scales ``scale / sqrt(fan_in) / 7``)."""
    return _materialize_random(model, 4, device, min_numel, seed, scale)
