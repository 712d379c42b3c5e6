"""Carry the JAX package's parameters into the port's modules.

The port keeps the JAX attribute names, so the mapping is mechanical:

- ``...kernel`` becomes ``...weight``; a 2-D Linear kernel [in, out] is
  transposed to [out, in], a 3-D conv kernel WIO (wav2vec2's) to OIW, a 4-D
  conv kernel HWIO to OIHW and a 5-D conv kernel DHWIO to OIDHW;
- a quantized Linear comes with ``...kernel_scale``: its int8 kernel
  [in, out] becomes an int8 weight [out, in], its nibble-packed int4 kernel
  (uint8 [in, out/2]) the packed weight [out/2, in] (a plain transpose: the
  port's packing is the transpose of JAX's, quantize/residency.py), the
  scales become ``weight_scale`` and ``weight_bits`` follows from the
  kernel's dtype (``kernel_bits`` is a static attribute of the JAX module,
  not part of its state);
- a 2-D ``..._kernel`` leaf is a raw ``[in, out]`` projection matrix kept
  outside a Linear (the Wan VAE attention's ``to_qkv_kernel`` and
  ``proj_kernel``): it becomes ``..._weight`` ``[out, in]``; a 4-D one is a
  conv kernel kept beside its module's others (M-LSD's ``conv3_kernel``):
  HWIO becomes ``..._weight`` OIHW;
- a 3-D ``...kernel_w`` is a causal 1-D conv kernel kept outside a Linear
  (Wan S2V's ``CausalConv1d``): [k, in, out] becomes ``Conv1d``'s
  [out, in, k] under the same name;
- a 4-D ``...w`` is a transposed-convolution kernel that the JAX module
  keeps spatially flipped in HWIO (RIFE's ``Deconv2x``): it becomes
  ``...weight`` in ``ConvTranspose2d``'s layout ``[in, out, kh, kw]``,
  unflipped; a port module whose class sets ``jax_w_flipped = False``
  (Depth Anything's ``BlockUpsample``, TEED's and the lineart generator's
  ``_Deconv``, whose JAX ``w`` is an unflipped HWIO kernel that the JAX
  module flips as it runs) gets the same layout without the flip, and one
  that sets ``jax_w_torch_layout = True`` (the anime lineart U-Net's ``_Up``,
  whose JAX ``w`` already is ``[in, out, kh, kw]`` for ``lax.conv_transpose``
  with ``transpose_kernel``) takes it as it is;
- grouped and depthwise conv kernels (HWIO with ``I = cin / groups``) become
  torch's grouped OIHW by the same transpose;
- every other parameter keeps its name and layout (learned tokens, PReLU
  slopes, embedding tables, the FLUX.2 VAE's 1-D ``bn_mean`` / ``bn_var``,
  and the inference BatchNorms the preprocessors keep as parameters:
  EfficientNet's ``BNInf`` ``scale`` / ``bias`` / ``mean`` / ``var``, LeReS'
  ``running_mean`` / ``running_var``, M-LSD's and Manga Line's ``bn_*``).

A fused projection (FLUX.2's ``to_qkv_mlp_proj``, its SwiGLU ``linear_in``)
is one Linear on both sides and carries as any other.

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

from apex_studio_tpu_torch.models.layers import Linear

_BITS_OF_DTYPE = {np.dtype(np.int8): 8, np.dtype(np.uint8): 4}


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
            elif arr.ndim == 3:
                arr = arr.transpose(2, 1, 0)
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 5:
                arr = arr.transpose(4, 3, 0, 1, 2)
            else:
                raise ValueError(f"{key}: kernel of rank {arr.ndim} has no known layout")
        elif parts[-1].endswith("_kernel") and arr.ndim == 2:
            parts[-1] = parts[-1][: -len("kernel")] + "weight"
            arr = arr.T
        elif parts[-1].endswith("_kernel") and arr.ndim == 4:
            parts[-1] = parts[-1][: -len("kernel")] + "weight"
            arr = arr.transpose(3, 2, 0, 1)
        elif parts[-1] == "kernel_w" and arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)
        elif parts[-1] == "w" and arr.ndim == 4:
            parts[-1] = "weight"
            arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        elif parts[-1] == "kernel_scale":
            parts[-1] = "weight_scale"
        out[".".join(parts)] = arr
    return out


def load_from_jax(module: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy ``flat`` (JAX parameter paths) into ``module`` in place, strictly.
    Values are cast to each port parameter's dtype and device; a quantized
    kernel keeps its integer dtype and makes its Linear resident."""
    params = dict(module.named_parameters())
    converted = convert_jax_params(flat)
    for key in flat:
        parent, dot, leaf = key.rpartition(".")
        weight = f"{parent}{dot}weight"
        owner = _owner(module, weight) if leaf == "w" else None
        if getattr(owner, "jax_w_torch_layout", False):
            converted[weight] = np.asarray(flat[key])
        elif not getattr(owner, "jax_w_flipped", True):
            converted[weight] = converted[weight][:, :, ::-1, ::-1]
    scales = {name for name in converted if name.rpartition(".")[2] == "weight_scale"
              and isinstance(_owner(module, name), Linear)}
    unexpected = sorted(set(converted) - set(params) - scales)
    missing = sorted(set(params) - set(converted))
    if unexpected or missing:
        raise KeyError(f"JAX→port carry mismatch: unexpected {unexpected[:8]}, missing {missing[:8]}")
    with torch.no_grad():
        for name in scales:
            lin, weight = _owner(module, name), converted[name[: -len("_scale")]]
            bits = _BITS_OF_DTYPE.get(weight.dtype)
            logical = (weight.shape[0] * 2, weight.shape[1]) if bits == 4 else tuple(weight.shape)
            if bits is None or logical != tuple(lin.weight.shape):
                raise ValueError(f"{name}: quantized JAX kernel {weight.dtype} {weight.shape} "
                                 f"vs port weight {tuple(lin.weight.shape)}")
            device = lin.weight.device
            lin.set_quantized(torch.from_numpy(np.ascontiguousarray(weight)).to(device),
                              torch.from_numpy(np.array(converted[name], np.float32)).to(device), bits)
        quantized = {name[: -len("_scale")] for name in scales}
        for name, arr in converted.items():
            if name in scales or name in quantized:
                continue
            p = params[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {arr.shape} vs port {tuple(p.shape)}")
            src = torch.from_numpy(np.array(arr, dtype=np.float32))
            p.copy_(src.to(device=p.device, dtype=p.dtype))
    return module


def _owner(module: nn.Module, path: str):
    parent = path.rpartition(".")[0]
    try:
        return module.get_submodule(parent) if parent else module
    except AttributeError:
        return None
