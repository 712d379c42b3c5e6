"""GGUF checkpoint ingestion, dequantized on load to numpy (copy of
``apex_studio_tpu/quantize/gguf.py`` without its ``ml_dtypes`` use).

The port has no K-quant compute path, so every quantized tensor is dequantized
to float at load time; what stays small on the card is int8/int4 residency
(quantize/residency.py), applied after loading.

Implements the GGUF v2/v3 container and the dequant kernels for the formats
Apex manifests actually ship: F32/F16/BF16, Q8_0, Q4_0, Q4_1, Q5_0, Q5_1,
Q4_K, Q5_K, Q6_K, Q2_K, Q3_K (block layouts per ggml's quantization spec).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, BinaryIO, Dict, Tuple, Union

import numpy as np

GGUF_MAGIC = b"GGUF"

# ggml type ids → (name, block_bytes, elements_per_block)
_GGML_TYPES = {
    0: ("F32", 4, 1),
    1: ("F16", 2, 1),
    2: ("Q4_0", 18, 32),
    3: ("Q4_1", 20, 32),
    6: ("Q5_0", 22, 32),
    7: ("Q5_1", 24, 32),
    8: ("Q8_0", 34, 32),
    10: ("Q2_K", 84, 256),
    11: ("Q3_K", 110, 256),
    12: ("Q4_K", 144, 256),
    13: ("Q5_K", 176, 256),
    14: ("Q6_K", 210, 256),
    30: ("BF16", 2, 1),
}

_GGUF_VALUE_FMT = {
    0: "B", 1: "b", 2: "H", 3: "h", 4: "I", 5: "i", 6: "f",
    7: "?", 10: "Q", 11: "q", 12: "d",
}


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype in _GGUF_VALUE_FMT:
        fmt = _GGUF_VALUE_FMT[vtype]
        return struct.unpack("<" + fmt, f.read(struct.calcsize(fmt)))[0]
    if vtype == 8:  # string
        n = struct.unpack("<Q", f.read(8))[0]
        return f.read(n).decode("utf-8", errors="replace")
    if vtype == 9:  # array
        etype = struct.unpack("<I", f.read(4))[0]
        n = struct.unpack("<Q", f.read(8))[0]
        return [_read_value(f, etype) for _ in range(n)]
    raise ValueError(f"unknown GGUF metadata type {vtype}")


def read_gguf_header(path: Union[str, Path]):
    """→ (metadata dict, tensor infos [(name, shape, ggml_type, offset)], data_start)."""
    with open(path, "rb") as f:
        if f.read(4) != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        version = struct.unpack("<I", f.read(4))[0]
        if version < 2:
            raise ValueError(f"GGUF v{version} unsupported")
        n_tensors = struct.unpack("<Q", f.read(8))[0]
        n_kv = struct.unpack("<Q", f.read(8))[0]
        meta: Dict[str, Any] = {}
        for _ in range(n_kv):
            klen = struct.unpack("<Q", f.read(8))[0]
            key = f.read(klen).decode("utf-8")
            vtype = struct.unpack("<I", f.read(4))[0]
            meta[key] = _read_value(f, vtype)
        infos = []
        for _ in range(n_tensors):
            nlen = struct.unpack("<Q", f.read(8))[0]
            name = f.read(nlen).decode("utf-8")
            ndim = struct.unpack("<I", f.read(4))[0]
            dims = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
            ttype = struct.unpack("<I", f.read(4))[0]
            offset = struct.unpack("<Q", f.read(8))[0]
            infos.append((name, tuple(dims), ttype, offset))
        align = int(meta.get("general.alignment", 32))
        pos = f.tell()
        data_start = (pos + align - 1) // align * align
    return meta, infos, data_start


# -- dequant kernels (vectorized numpy; layouts per ggml quantization spec) ------------


def _deq_q8_0(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    blocks = raw.reshape(n_blocks, 34)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    q = blocks[:, 2:].view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)


def _deq_q4_0(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    blocks = raw.reshape(n_blocks, 18)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    q = blocks[:, 2:]
    lo = (q & 0x0F).astype(np.int8) - 8
    hi = (q >> 4).astype(np.int8) - 8
    out = np.concatenate([lo, hi], axis=1).astype(np.float32) * d
    return out.reshape(-1)


def _deq_q4_1(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    blocks = raw.reshape(n_blocks, 20)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    q = blocks[:, 4:]
    lo = (q & 0x0F).astype(np.float32)
    hi = (q >> 4).astype(np.float32)
    out = np.concatenate([lo, hi], axis=1) * d + m
    return out.reshape(-1)


def _deq_q5_1(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    blocks = raw.reshape(n_blocks, 24)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    qh = blocks[:, 4:8].copy().view(np.uint32).reshape(n_blocks, 1)
    qs = blocks[:, 8:]
    shifts = np.arange(32, dtype=np.uint32)
    hbits = ((qh >> shifts) & 1).astype(np.uint8)  # (n, 32)
    lo = (qs & 0x0F) | (hbits[:, :16] << 4)
    hi = (qs >> 4) | (hbits[:, 16:] << 4)
    out = np.concatenate([lo, hi], axis=1).astype(np.float32) * d + m
    return out.reshape(-1)


def _deq_q5_0(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    blocks = raw.reshape(n_blocks, 22)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    qh = blocks[:, 2:6].copy().view(np.uint32).reshape(n_blocks, 1)
    qs = blocks[:, 6:]
    shifts = np.arange(32, dtype=np.uint32)
    hbits = ((qh >> shifts) & 1).astype(np.uint8)  # (n, 32)
    lo = (qs & 0x0F) | (hbits[:, :16] << 4)
    hi = (qs >> 4) | (hbits[:, 16:] << 4)
    out = (np.concatenate([lo, hi], axis=1).astype(np.int16) - 16).astype(np.float32) * d
    return out.reshape(-1)


def _q_k_scale_min(blocks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte 6-bit scales/mins used by Q4_K/Q5_K."""
    sc = blocks[:, :12]
    scales = np.empty((blocks.shape[0], 8), np.float32)
    mins = np.empty((blocks.shape[0], 8), np.float32)
    for j in range(8):
        if j < 4:
            scales[:, j] = (sc[:, j] & 63).astype(np.float32)
            mins[:, j] = (sc[:, j + 4] & 63).astype(np.float32)
        else:
            scales[:, j] = ((sc[:, j + 4] & 0x0F) | ((sc[:, j - 4] >> 6) << 4)).astype(np.float32)
            mins[:, j] = ((sc[:, j + 4] >> 4) | ((sc[:, j] >> 6) << 4)).astype(np.float32)
    return scales, mins


def _deq_q4_k(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    blocks = raw.reshape(n_blocks, 144)
    d = blocks[:, 140:142].copy().view(np.float16).astype(np.float32)
    dmin = blocks[:, 142:144].copy().view(np.float16).astype(np.float32)
    scales, mins = _q_k_scale_min(blocks)
    qs = blocks[:, 12:140]  # 128 bytes → 256 nibbles
    out = np.empty((n_blocks, 256), np.float32)
    for j in range(4):  # 4 chunks of 64 values (2 sub-blocks each)
        q = qs[:, j * 32 : (j + 1) * 32]
        lo = (q & 0x0F).astype(np.float32)
        hi = (q >> 4).astype(np.float32)
        s_lo = d * scales[:, 2 * j] ; m_lo = dmin * mins[:, 2 * j]
        s_hi = d * scales[:, 2 * j + 1]; m_hi = dmin * mins[:, 2 * j + 1]
        out[:, j * 64 : j * 64 + 32] = lo * s_lo[:, None] - m_lo[:, None]
        out[:, j * 64 + 32 : j * 64 + 64] = hi * s_hi[:, None] - m_hi[:, None]
    return out.reshape(-1)


def _deq_q5_k(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    blocks = raw.reshape(n_blocks, 176)
    d = blocks[:, 172:174].copy().view(np.float16).astype(np.float32)
    dmin = blocks[:, 174:176].copy().view(np.float16).astype(np.float32)
    scales, mins = _q_k_scale_min(blocks)
    qh = blocks[:, 12:44]  # 32 bytes of high bits
    qs = blocks[:, 44:172]  # 128 bytes → 256 nibbles
    out = np.empty((n_blocks, 256), np.float32)
    u = np.uint8(1)
    for j in range(4):
        q = qs[:, j * 32 : (j + 1) * 32]
        hb_lo = ((qh >> np.uint8(2 * j)) & u).astype(np.float32)
        hb_hi = ((qh >> np.uint8(2 * j + 1)) & u).astype(np.float32)
        lo = (q & 0x0F).astype(np.float32) + hb_lo * 16.0
        hi = (q >> 4).astype(np.float32) + hb_hi * 16.0
        s_lo = d * scales[:, 2 * j] ; m_lo = dmin * mins[:, 2 * j]
        s_hi = d * scales[:, 2 * j + 1]; m_hi = dmin * mins[:, 2 * j + 1]
        out[:, j * 64 : j * 64 + 32] = lo * s_lo[:, None] - m_lo[:, None]
        out[:, j * 64 + 32 : j * 64 + 64] = hi * s_hi[:, None] - m_hi[:, None]
    return out.reshape(-1)


def _deq_q6_k(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    blocks = raw.reshape(n_blocks, 210)
    ql = blocks[:, :128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8).astype(np.float32)
    d = blocks[:, 208:210].copy().view(np.float16).astype(np.float32)
    out = np.empty((n_blocks, 256), np.float32)
    for half in range(2):  # two 128-value halves
        l = ql[:, half * 64 : half * 64 + 64]
        h = qh[:, half * 32 : half * 32 + 32]
        base = half * 128
        sbase = half * 8
        q1 = ((l[:, :32] & 0x0F) | (((h >> 0) & 3) << 4)).astype(np.int16) - 32
        q2 = ((l[:, 32:] & 0x0F) | (((h >> 2) & 3) << 4)).astype(np.int16) - 32
        q3 = ((l[:, :32] >> 4) | (((h >> 4) & 3) << 4)).astype(np.int16) - 32
        q4 = ((l[:, 32:] >> 4) | (((h >> 6) & 3) << 4)).astype(np.int16) - 32
        for idx, q in enumerate((q1, q2, q3, q4)):
            s = sc[:, sbase + idx * 2 : sbase + idx * 2 + 2]
            scale = np.repeat(s, 16, axis=1)  # two 16-value sub-scales
            out[:, base + idx * 32 : base + (idx + 1) * 32] = q.astype(np.float32) * scale * d
    return out.reshape(-1)


def _deq_q2_k(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    blocks = raw.reshape(n_blocks, 84)
    sc = blocks[:, :16]
    qs = blocks[:, 16:80]
    d = blocks[:, 80:82].copy().view(np.float16).astype(np.float32)
    dmin = blocks[:, 82:84].copy().view(np.float16).astype(np.float32)
    out = np.empty((n_blocks, 256), np.float32)
    for j in range(16):  # 16 sub-blocks of 16 values
        scale = (sc[:, j] & 0x0F).astype(np.float32) * d
        mn = (sc[:, j] >> 4).astype(np.float32) * dmin
        byte_group = qs[:, (j // 4) * 16 : (j // 4) * 16 + 16]
        shift = np.uint8(2 * (j % 4))
        q = ((byte_group >> shift) & 3).astype(np.float32)
        out[:, j * 16 : (j + 1) * 16] = q * scale[:, None] - mn[:, None]
    return out.reshape(-1)


def _deq_q3_k(raw: np.ndarray, n_blocks: int) -> np.ndarray:
    blocks = raw.reshape(n_blocks, 110)
    hmask = blocks[:, :32]
    qs = blocks[:, 32:96]
    scales_raw = blocks[:, 96:108]
    d = blocks[:, 108:110].copy().view(np.float16).astype(np.float32)
    # 6-bit scales packed into 12 bytes (ggml layout).
    scales = np.empty((n_blocks, 16), np.int8)
    for j in range(16):
        if j < 8:
            lo = scales_raw[:, j] & 0x0F
        else:
            lo = scales_raw[:, j - 8] >> 4
        hi = (scales_raw[:, 8 + (j % 4)] >> np.uint8(2 * (j // 4))) & 3
        scales[:, j] = ((hi << 4) | lo).astype(np.int8) - 32
    out = np.empty((n_blocks, 256), np.float32)
    for j in range(16):
        byte_group = qs[:, (j // 4) * 16 : (j // 4) * 16 + 16]
        shift = np.uint8(2 * (j % 4))
        q = ((byte_group >> shift) & 3).astype(np.int8)
        hbit = (hmask[:, (j % 2) * 16 : (j % 2) * 16 + 16] >> np.uint8(j // 2)) & 1
        q = q - ((1 - hbit) << 2).astype(np.int8)
        out[:, j * 16 : (j + 1) * 16] = q.astype(np.float32) * (d * scales[:, j].astype(np.float32))[:, None]
    return out.reshape(-1)


_DEQUANT = {
    "Q8_0": _deq_q8_0,
    "Q4_0": _deq_q4_0,
    "Q4_1": _deq_q4_1,
    "Q5_0": _deq_q5_0,
    "Q5_1": _deq_q5_1,
    "Q4_K": _deq_q4_k,
    "Q5_K": _deq_q5_k,
    "Q6_K": _deq_q6_k,
    "Q2_K": _deq_q2_k,
    "Q3_K": _deq_q3_k,
}


def load_gguf_state_dict(path: Union[str, Path], dtype=np.float32) -> Dict[str, np.ndarray]:
    """Load a GGUF file and dequantize every tensor to ``dtype``.

    GGUF stores dims innermost-first; returned arrays use torch/numpy order
    (reversed dims), matching what the key converters expect.
    """
    meta, infos, data_start = read_gguf_header(path)
    mm = np.memmap(path, mode="r", dtype=np.uint8)
    out: Dict[str, np.ndarray] = {}
    for name, dims, ttype, offset in infos:
        if ttype not in _GGML_TYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported ggml type {ttype}")
        tname, block_bytes, block_elems = _GGML_TYPES[ttype]
        n_elems = int(np.prod(dims))
        shape = tuple(reversed(dims))
        start = data_start + offset
        if tname == "F32":
            arr = mm[start : start + 4 * n_elems].view(np.float32).reshape(shape)
        elif tname == "F16":
            arr = mm[start : start + 2 * n_elems].view(np.float16).reshape(shape)
        elif tname == "BF16":
            # bf16 is the upper half of an f32: widen the bits
            bits = mm[start : start + 2 * n_elems].view(np.uint16).astype(np.uint32) << 16
            arr = bits.view(np.float32).reshape(shape)
        else:
            n_blocks = n_elems // block_elems
            raw = np.asarray(mm[start : start + n_blocks * block_bytes])
            arr = _DEQUANT[tname](raw, n_blocks).reshape(shape)
        out[name] = arr.astype(dtype) if arr.dtype != dtype else arr
    return out
