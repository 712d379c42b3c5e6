"""safetensors ingestion → torch tensors on the CPU (port of
``apex_studio_tpu/loaders/safetensors_io.py``).

The header is parsed here (8-byte length + JSON) and each payload is mapped
with ``torch.frombuffer``, so bf16 and fp8 need neither ``ml_dtypes`` nor the
``safetensors`` package. Tensors are views of a private copy-on-write memory
map until they are cast or moved: host memory holds only what is touched.
fp8-scaled and FP4-scaled checkpoints are dequantized at load time.
"""

from __future__ import annotations

import json
import mmap
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

import numpy as np
import torch

_ST_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}
_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _read_header(path: Path):
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n).decode("utf-8"))
    return header, 8 + n


def safetensors_keys(path: Union[str, Path]) -> List[str]:
    header, _ = _read_header(Path(path))
    return [k for k in header if k != "__metadata__"]


def load_safetensors(
    path: Union[str, Path],
    keys: Optional[Iterable[str]] = None,
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """Memory-map a .safetensors file and return (optionally cast) CPU tensors."""
    path = Path(path)
    header, data_start = _read_header(path)
    with open(path, "rb") as f:
        # private copy-on-write map: writable for torch.frombuffer, never written back
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out: Dict[str, torch.Tensor] = {}
    wanted = set(keys) if keys is not None else None
    for name, info in header.items():
        if name == "__metadata__" or (wanted is not None and name not in wanted):
            continue
        t_dtype = _ST_DTYPES.get(info["dtype"])
        if t_dtype is None:
            raise ValueError(f"{path}: unsupported safetensors dtype {info['dtype']} for {name}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if count == 0:
            t = torch.empty(shape, dtype=t_dtype)
        else:
            offset = data_start + begin
            if offset % t_dtype.itemsize:  # unaligned payload: copy it out
                t = torch.frombuffer(bytearray(mm[offset:data_start + end]), dtype=t_dtype, count=count)
            else:
                t = torch.frombuffer(mm, dtype=t_dtype, count=count, offset=offset)
            t = t.reshape(shape)
        out[name] = t.to(dtype) if dtype is not None and t.dtype != dtype else t
    return out


def load_sharded_safetensors(
    directory: Union[str, Path],
    index_file: str = "model.safetensors.index.json",
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """Load a HF sharded checkpoint directory (or a dir of .safetensors files)."""
    directory = Path(directory)
    index_path = directory / index_file
    out: Dict[str, torch.Tensor] = {}
    if index_path.exists():
        index = json.loads(index_path.read_text())
        by_file: Dict[str, List[str]] = {}
        for key, fname in index["weight_map"].items():
            by_file.setdefault(fname, []).append(key)
        for fname, ks in by_file.items():
            out.update(load_safetensors(directory / fname, keys=ks, dtype=dtype))
        return out
    files = sorted(directory.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors found under {directory}")
    for f in files:
        out.update(load_safetensors(f, dtype=dtype))
    return out


def load_torch_checkpoint(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """torch-pickle checkpoints (.pth/.ckpt/.pt) → CPU state dict, loaded with
    ``weights_only=True``. Nested {"state_dict": ...} containers are unwrapped;
    non-tensor entries are dropped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "module"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    out: Dict[str, torch.Tensor] = {}
    for k, v in obj.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach()
        elif isinstance(v, np.ndarray):
            out[k] = torch.from_numpy(v)
    return out


def dequantize_fp8_scaled(sd: Mapping[str, torch.Tensor],
                          target: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Fold ``<name>.scale_weight`` / ``weight_scale`` / ``_scale`` tensors into
    their quantized weights at load time:

    - fp8 (e4m3/e5m2) weights: cast to ``target`` and multiply by the scale
      where there is one;
    - FP4-scaled weights: int8/uint8 tensors holding signed 4-bit codes in
      [-7, 7] with a broadcastable scale → ``codes * scale``. int8/uint8
      tensors without a scale pass through.
    """
    out: Dict[str, torch.Tensor] = {}
    scale_suffixes = (".scale_weight", ".weight_scale", "_scale")
    scales = {k: v for k, v in sd.items() if k.endswith(scale_suffixes)}

    def _scale_for(key: str):
        for suf in scale_suffixes:
            cand = key.rsplit(".", 1)[0] + suf
            if cand in scales:
                return scales[cand]
        return None

    for key, t in sd.items():
        if key in scales:
            continue
        if t.dtype in _FP8:
            scale = _scale_for(key)
            t = t.to(target)
            if scale is not None:
                t = t * scale.to(target)
        elif t.dtype in (torch.int8, torch.uint8):
            scale = _scale_for(key)
            if scale is not None:  # FP4-scaled entry (codes are signed)
                t = t.view(torch.int8).to(target) * scale.to(target)
        out[key] = t
    return out


def save_safetensors(path: Union[str, Path], tensors: Mapping[str, Any],
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write a .safetensors file (header JSON + contiguous little-endian
    payloads) from torch tensors or numpy arrays. Payloads are written one
    tensor at a time, so a multi-GB file needs no second copy in memory."""
    items = {}
    for name in sorted(tensors):
        t = tensors[name]
        t = torch.from_numpy(np.ascontiguousarray(t)) if isinstance(t, np.ndarray) else t.detach().cpu()
        if t.dtype not in _ST_NAMES:
            t = t.to(torch.float32)
        items[name] = t.contiguous()
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in items.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    hdr = json.dumps(header).encode("utf-8")
    hdr += b" " * ((-len(hdr)) % 8)
    with open(path, "wb") as f:
        f.write(len(hdr).to_bytes(8, "little"))
        f.write(hdr)
        for t in items.values():
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
