"""Shared building blocks for the model families (port of ``models/layers.py``).

Conventions:
- ``dtype`` is the compute dtype of a Linear and, unless ``param_dtype`` says
  otherwise, its storage dtype (the JAX components mostly build with
  ``param_dtype == dtype``). Norm weights are stored in
  f32 and norm statistics accumulate in f32 (ops/norms.py).
- Linear weights are stored torch-style ``weight [out, in]``; the JAX package
  stores ``kernel [in, out]`` (loaders/from_jax.py transposes on carry).
- The bf16 matmul is a plain ``F.linear``, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm as _layer_norm
from apex_studio_tpu_torch.ops.norms import rms_norm as _rms_norm


def check_residency(mode: str) -> None:
    """Weight residency of the synthetic-weight mode (``APEX_SYNTHETIC_WEIGHTS``).
    Only bf16 is ported: int8 (W8A8) and int4 raise rather than dequantize."""
    if mode in ("int8", "int4", "1", "true"):
        raise NotImplementedError(
            f"{mode} weight residency is not ported yet: a later slice ports the "
            "W8A8 and int4 Linear paths; use APEX_SYNTHETIC_WEIGHTS=bf16")
    if mode != "bf16":
        raise ValueError(f"unknown weight residency {mode!r}")


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, *, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(out_features, dtype=param_dtype)) if use_bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


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
