"""Flash attention: the hand-written CUDA kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``apex_studio_tpu/ops/attention/pallas_flash.py``
(``_flash_kernel``, launched by ``_flash_call``, fronted by
``flash_attention``). The kernel lives in ``csrc/flash_attn.cu``; its header
comment gives the design in full.

Design: one block per 128-query tile and batch·head; two consumer warpgroups
(64 query rows each, scores and output accumulators in registers) and one
producer warp that loads Q once and a ring of 128-key K/V tiles by TMA through
tensor maps over the tensors' real BSHD strides; both products are ``wgmma``
(S = Q·Kᵀ from swizzled shared memory, O += P·V with P in registers and V read
transposed); the softmax of one tile runs while the next tile's Q·Kᵀ and this
tile's P·V are in flight. S and P never reach device memory.

Bound: at the Flux Dev 1024px shape (B=1, S=4608, H=24, D=128) one call does
4·B·H·Sq·Sk·D = 2.61e11 FLOP, 0.264 ms at the H100's 989 TFLOP/s bf16, and
moves 113 MB, 0.034 ms at 3.35 TB/s: it is bound by tensor-core operations.

``flash_attention`` runs the plain version for tensors on the CPU and the
kernel for tensors on the card; a failed build, tensor-map encoding or launch
raises. ``flash_attention.launches`` counts kernel launches.
``flash_attention_tiled_reference`` walks the kernel's algorithm tile by tile
in plain PyTorch; only the tests use it.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

LOG2E = math.log2(math.e)
NEG_INF = -1e30
_SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "flash_attn.cu"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_Strides = ctypes.c_int64 * 13
_lib = None
_lib_lock = threading.Lock()


def build_dir() -> Path:
    """Where compiled kernels go: ``APEX_KERNEL_BUILD_DIR``, else ``build/kernels``
    beside the package (listed in ``.gitignore``)."""
    env = os.environ.get("APEX_KERNEL_BUILD_DIR")
    return Path(env) if env else _SOURCE.parents[2] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found: the flash kernel cannot be built")
    return str(cand)


def build() -> ctypes.CDLL:
    """Compile ``csrc/flash_attn.cu`` for sm_90a (once per source hash) and
    load it. Raises when nvcc fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        src = _SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        so = out_dir / f"flash_attn_{tag}.so"
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                capture_output=True, text=True,
            )
            (out_dir / f"flash_attn_{tag}.log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {_SOURCE}:\n{proc.stderr[-4000:]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        fn = lib.apex_flash_attn_fwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.apex_flash_attn_smem_bytes.argtypes = [ctypes.c_int]
        lib.apex_flash_attn_smem_bytes.restype = ctypes.c_int
        _lib = lib
        return lib


def _describe_error(err: int) -> str:
    """The C function's return code in words (see ``csrc/flash_attn.cu``)."""
    if err == 100000:
        return "this CUDA installation has no cuTensorMapEncodeTiled"
    if err > 100000:
        which, cu = divmod(err - 101000, 1000)
        return f"cuTensorMapEncodeTiled refused the map of {'qkv'[which]}: CUresult {cu}"
    return f"cudaError {err}"


def _key_padding_bias(bias: Optional[torch.Tensor], b: int, sk: int) -> Optional[torch.Tensor]:
    """Normalize a key-padding bias ([B|1, Sk] or [B|1, 1, 1, Sk]) to [B|1, Sk];
    anything richer raises (the dispatcher routes it to the ``xla`` backend)."""
    if bias is None:
        return None
    if bias.ndim == 4:
        if bias.shape[1] != 1 or bias.shape[2] != 1:
            raise ValueError("flash attention supports a key-padding bias only")
        bias = bias[:, 0, 0, :]
    if bias.ndim != 2 or bias.shape[0] not in (1, b) or bias.shape[1] != sk:
        raise ValueError(f"flash attention bias must be [B, Sk] or [B,1,1,Sk], got {tuple(bias.shape)}")
    return bias


def _check(q, k, v, is_causal: bool) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q/k/v must be BSHD")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"q/k/v shapes disagree: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if is_causal and sq != k.shape[1]:
        # Pallas aligns causal masks top-left and the naive backend bottom-right;
        # the two agree only for Sq == Sk.
        raise ValueError("causal flash attention needs Sq == Sk")


def flash_attention_reference(q, k, v, *, bias=None, scale=None, is_causal=False):
    """Plain PyTorch version: the ``naive`` backend (f32 scores, f32 softmax,
    ``p`` cast to ``v.dtype`` before P·V) behind the kernel's input checks."""
    from apex_studio_tpu_torch.ops.attention import naive_attention

    _check(q, k, v, is_causal)
    bias = _key_padding_bias(bias, q.shape[0], k.shape[1])
    if bias is not None:
        bias = bias[:, None, None, :]
    return naive_attention(q, k, v, bias=bias, scale=scale, is_causal=is_causal)


def flash_attention_tiled_reference(q, k, v, *, bias=None, scale=None, is_causal=False,
                                    block_m: int = 128, block_n: int = 128):
    """The kernel's algorithm, tile by tile, in plain PyTorch (tests only).

    Query tiles of ``block_m`` rows sweep key tiles of ``block_n`` keys with an
    online softmax in base 2: scores scaled by ``scale·log2 e`` in f32, the
    bias added as ``bias·log2 e`` (a finite -1e30 stays finite), tail keys
    (zero-filled, as the tensor map gives them) and the causal upper triangle
    set to -inf, causal tiles wholly above the diagonal skipped, the running
    max guarded against ``(-inf) - (-inf)``, P rounded to ``v.dtype`` before
    P·V, and ``1 / max(l, 1e-30)`` at the end.
    """
    _check(q, k, v, is_causal)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    kv_bias = _key_padding_bias(bias, b, sk)
    scale_log2 = (scale if scale is not None else d ** -0.5) * LOG2E
    pad = (-sk) % block_n
    qf = q.float().permute(0, 2, 1, 3)                                          # [B, H, Sq, D]
    kf = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)).float().permute(0, 2, 3, 1)  # [B, H, D, Sk+]
    vf = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).float().permute(0, 2, 1, 3)  # [B, H, Sk+, D]
    if kv_bias is not None:
        kv_bias = torch.nn.functional.pad(kv_bias.float(), (0, pad)) * LOG2E   # [B|1, Sk+]
    cols = torch.arange(sk + pad, device=q.device)
    out = torch.empty(b, h, sq, d, dtype=q.dtype, device=q.device)
    neg_inf = float("-inf")
    for q0 in range(0, sq, block_m):
        rows = torch.arange(q0, min(q0 + block_m, sq), device=q.device)
        n_tiles = (sk + block_n - 1) // block_n
        if is_causal:
            n_tiles = min(n_tiles, int(rows[-1]) // block_n + 1)
        m_run = torch.full((b, h, len(rows)), neg_inf)
        l_run = torch.zeros(b, h, len(rows))
        acc = torch.zeros(b, h, len(rows), d)
        for j in range(n_tiles):
            c = cols[j * block_n:(j + 1) * block_n]
            x = (qf[:, :, rows] @ kf[:, :, :, c]) * scale_log2
            if kv_bias is not None:
                x = x + kv_bias[:, None, None, c]
            x = x.masked_fill(c >= sk, neg_inf)
            if is_causal:
                x = x.masked_fill(c[None, :] > rows[:, None], neg_inf)
            m_new = torch.maximum(m_run, x.amax(-1))
            m_use = torch.where(m_new == neg_inf, torch.zeros_like(m_new), m_new)
            corr = torch.exp2(m_run - m_use)
            p = torch.exp2(x - m_use[..., None])
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + p.to(v.dtype).float() @ vf[:, :, c]
            m_run = m_new
        out[:, :, rows] = (acc / l_run.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out.permute(0, 2, 1, 3)


def flash_attention(q, k, v, *, bias=None, scale=None, is_causal=False):
    """q/k/v: [B, S, H, D] → [B, Sq, H, D]. ``bias``: additive key-padding
    bias [B, Sk] or [B, 1, 1, Sk]. CPU tensors take the plain version; CUDA
    tensors take the kernel (bf16, or f32 rounded to bf16 and returned in
    f32; D in {64, 128}) or raise."""
    _check(q, k, v, is_causal)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    kv_bias = _key_padding_bias(bias, b, sk)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias=bias, scale=scale, is_causal=is_causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    if q.dtype == k.dtype == v.dtype == torch.float32:
        # f32 attention (the audio encoder's) runs on the kernel's bf16 tiles,
        # as an f32 dot at the TPU's default precision runs on the MXU in bf16
        # passes, with f32 scores and softmax; the output returns in f32
        return flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias=bias, scale=scale,
                               is_causal=is_causal).float()
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"the flash kernel takes bf16 (or f32, rounded to bf16 tiles) q/k/v, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in (64, 128):
        raise ValueError(f"the flash kernel takes head dim 64 or 128, got {d}")
    if sk == 0 or b * h > 65535:
        raise ValueError(f"unsupported flash shape B*H={b * h}, Sk={sk}")
    dev = q.device
    q_st, k_st, v_st = q.stride(), k.stride(), v.stride()
    for name, t, st in (("q", q, q_st), ("k", k, k_st), ("v", v, v_st)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        # What a tensor map takes: a contiguous head dim, a 16-byte aligned
        # base and every other stride a multiple of 16 bytes.
        if st[3] != 1 or st[0] % 8 or st[1] % 8 or st[2] % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous head dim and 16-byte aligned rows")
    if kv_bias is not None:
        kv_bias = kv_bias.to(device=dev, dtype=torch.float32).contiguous()
    scale = scale if scale is not None else d ** -0.5

    out = torch.empty(b, sq, h, d, dtype=q.dtype, device=dev)
    o_st = out.stride()
    strides = _Strides(
        q_st[0], q_st[1], q_st[2], k_st[0], k_st[1], k_st[2], v_st[0], v_st[1], v_st[2],
        o_st[0], o_st[1], o_st[2],
        kv_bias.stride(0) if kv_bias is not None and kv_bias.shape[0] == b else 0)
    lib = _lib or build()
    # The launch goes to the tensors' card and PyTorch's current stream there.
    # Per-call host work is kept small: the denoise loop launches this 57 times
    # a step.
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    if index != current:
        torch.cuda.set_device(index)
    try:
        err = lib.apex_flash_attn_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_bias.data_ptr() if kv_bias is not None else None, out.data_ptr(),
            b, h, sq, sk, d, strides, scale * LOG2E, int(is_causal),
            torch._C._cuda_getCurrentRawStream(index),
        )
    finally:
        if index != current:
            torch.cuda.set_device(current)
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: {_describe_error(err)}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
