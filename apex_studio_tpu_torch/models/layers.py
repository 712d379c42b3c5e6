"""Shared building blocks for the model families (port of ``models/layers.py``).

Conventions:
- ``dtype`` is the compute dtype of a Linear and, unless ``param_dtype`` says
  otherwise, its storage dtype (the JAX components mostly build with
  ``param_dtype == dtype``). Norm weights are stored in
  f32 and norm statistics accumulate in f32 (ops/norms.py).
- Linear weights are stored torch-style ``weight [out, in]``; the JAX package
  stores ``kernel [in, out]`` (loaders/from_jax.py transposes on carry).
- The bf16 matmul is a plain ``F.linear`` and the int8 product of a resident
  weight a plain ``torch._int_mm``, as the JAX package leaves both to XLA.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm as _layer_norm
from apex_studio_tpu_torch.ops.norms import rms_norm as _rms_norm


def int8_compute_enabled() -> bool:
    """W8A8 for int8-resident weights: an int8 tensor-core product instead of
    dequantizing to the compute dtype. On unless ``APEX_INT8_COMPUTE=0``, which
    restores the dequant path. Read at each call; it only affects weights that
    are already stored int8 (quantize/residency.py)."""
    return os.environ.get("APEX_INT8_COMPUTE", "1") != "0"


def int_mm(xq: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Exact s8 × s8 → s32 product ``xq [M, K] @ weight[N, K]ᵀ`` through
    ``torch._int_mm``. The weight goes in as the transposed view of its
    ``[out, in]`` storage (column-major, the layout cuBLASLt's int8 GEMM reads
    as is), so no copy of it is made. On the card the call needs more than 16
    rows: fewer are padded with zero rows to 32 and the result is sliced, which
    changes no value. K and N must be multiples of 8 there."""
    m, k = xq.shape
    n = weight.shape[0]
    if xq.is_cuda:
        if k % 8 or n % 8:
            raise ValueError(f"int8 product on the card needs K and N in multiples of 8, got K={k}, N={n}")
        if m <= 16:
            return torch._int_mm(F.pad(xq, (0, 0, 0, 32 - m)), weight.t())[:m]
    return torch._int_mm(xq, weight.t())


def quantize_rows(x: torch.Tensor):
    """Dynamic symmetric per-row int8 quantization of ``x [M, K]``, in f32:
    ``sx = max(amax|x|, 1e-6) / 127``, ``xq = clip(rint(x / sx), ±127)``.
    Returns ``(xq int8 [M, K], sx f32 [M, 1])``. Rounds half to even."""
    xf = x.float()
    sx = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / 127.0
    return torch.round(xf / sx).clamp_(-127, 127).to(torch.int8), sx


def rescale(acc: torch.Tensor, sx: torch.Tensor, weight_scale: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """The s32 product back to ``dtype``: ``acc · sx · weight_scale`` in f32
    (per row, then per output channel), then the cast."""
    return (acc.float() * sx * weight_scale.float()).to(dtype)


class Linear(nn.Module):
    """``weight [out, in]`` in ``param_dtype``; or, after residency
    (quantize/residency.py), quantized with per-output-channel scales in the
    ``weight_scale`` buffer: int8 ``[out, in]`` (``weight_bits == 8``) or
    nibble-packed int4, uint8 ``[out/2, in]`` (``weight_bits == 4``)."""

    def __init__(self, in_features: int, out_features: int, *, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(out_features, dtype=param_dtype)) if use_bias else None
        self.register_buffer("weight_scale", None)
        self.weight_bits = 8
        self.dtype = dtype

    def set_quantized(self, weight: torch.Tensor, scale: torch.Tensor, bits: int) -> None:
        """Swap in a quantized weight (int8, or packed uint8 for ``bits == 4``)
        and its f32 per-output-channel scales."""
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.weight_scale = scale
        self.weight_bits = bits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight_scale is not None:
            if self.weight_bits == 4:
                return self._w4(x)
            if int8_compute_enabled():
                return self._w8a8(x)
            w = self.weight.to(self.dtype) * self.weight_scale.to(self.dtype)[:, None]
        else:
            w = self.weight.to(self.dtype)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), w, bias)

    def _w4(self, x: torch.Tensor) -> torch.Tensor:
        """Nibble-packed int4 residency (``quantize_kernel_int4`` layout: packed
        ``[out/2, in]`` uint8, low nibble = output row j, high nibble = row
        j + out/2, stored offset-binary q+8). Each plane is unpacked, scaled
        per row in the compute dtype and multiplied on its own; the two
        results are concatenated on the last axis. A copy of the weight in the
        compute dtype exists for the length of the call."""
        u, s = self.weight, self.weight_scale.to(self.dtype)
        half = u.shape[0]
        xd = x.to(self.dtype)
        lo = ((u & 0xF).to(torch.int8) - 8).to(self.dtype) * s[:half, None]
        hi = ((u >> 4).to(torch.int8) - 8).to(self.dtype) * s[half:, None]
        y = torch.cat([F.linear(xd, lo), F.linear(xd, hi)], dim=-1)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y

    def _w8a8(self, x: torch.Tensor) -> torch.Tensor:
        """int8 compute for int8-resident weights: dynamic symmetric per-token
        activation quantization against the per-output-channel weight scales,
        an exact s8 × s8 → s32 product (``int_mm``), one f32 rescale, the cast
        to the compute dtype, then the bias in that dtype."""
        xq, sx = quantize_rows(x.reshape(-1, x.shape[-1]))
        y = rescale(int_mm(xq, self.weight), sx, self.weight_scale, self.dtype)
        y = y.reshape(*x.shape[:-1], y.shape[-1])
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, eps: float = 1e-5, elementwise_affine: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32)) if elementwise_affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _rms_norm(x, self.weight, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, *, eps: float = 1e-6, elementwise_affine: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32)) if elementwise_affine else None
        self.bias = (nn.Parameter(torch.zeros(dim, dtype=torch.float32))
                     if elementwise_affine and use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _layer_norm(x, self.weight, self.bias, self.eps)


class SwiGLU(nn.Module):
    """w2(silu(w1·x) * w3·x), the LLaMA / Qwen FFN shape."""

    def __init__(self, dim: int, hidden_dim: int, *, use_bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.w1 = Linear(dim, hidden_dim, use_bias=use_bias, dtype=dtype)
        self.w3 = Linear(dim, hidden_dim, use_bias=use_bias, dtype=dtype)
        self.w2 = Linear(hidden_dim, dim, use_bias=use_bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class GELUMLP(nn.Module):
    """fc2(gelu(fc1·x)) — the DiT/ViT FFN shape (tanh GELU by default)."""

    def __init__(self, dim: int, hidden_dim: int, *, use_bias: bool = True,
                 approximate: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim, use_bias=use_bias, dtype=dtype)
        self.fc2 = Linear(hidden_dim, dim, use_bias=use_bias, dtype=dtype)
        self.approximate = "tanh" if approximate else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class TimestepEmbedder(nn.Module):
    """Sinusoidal frequencies → MLP, the DiT conditioning stem."""

    def __init__(self, out_size: int, mid_size: Optional[int] = None, *, freq_size: int = 256,
                 max_period: float = 10000.0, flip_sin_to_cos: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        mid = mid_size if mid_size is not None else out_size
        self.in_layer = Linear(freq_size, mid, dtype=dtype)
        self.out_layer = Linear(mid, out_size, dtype=dtype)
        self.freq_size = freq_size
        self.max_period = max_period
        self.flip_sin_to_cos = flip_sin_to_cos

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        freqs = timestep_embedding(t, self.freq_size, max_period=self.max_period,
                                   flip_sin_to_cos=self.flip_sin_to_cos)
        return self.out_layer(F.silu(self.in_layer(freqs)))
