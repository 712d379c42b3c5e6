#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (apex_studio_tpu_torch) on one NVIDIA card.

Phases, each printed as one JSON line:
  card       the card's name and power limit, the kernels' build time, and
             what ptxas said of each kernel (registers, spills, warnings)
  kernels    every hand-written kernel against its plain PyTorch version on
             the card, case by case, with the tolerance stated; then what
             three deliberately faulty versions read against that tolerance
  timing     each kernel at the main path's shape: its time (CUDA events,
             warm, median), the plain version's, one PyTorch library call's
             as a yardstick, and the least time the card could take (bound);
             each also as the time per call of 20 queued calls
  reference  a tiny Flux DiT on the card (bf16, kernels) against the same
             weights on the CPU (f32, plain versions)
  residency  the int8 / int4 resident Linear: the int8 product exact against
             a float64 product at Flux's shapes (1 to 4608 rows), W8A8 and
             int4 on the card against the same module on the CPU, the LoRA
             merges into quantized weights against numpy, and one timing line
             per Flux Linear shape (bf16, W8A8 split into its three passes,
             int4) beside its bounds
  checkpoint a Flux DiT at full width (2 + 2 blocks) written in the BFL
             single-file naming and the full Flux VAE in diffusers naming,
             loaded back through the engine's checkpoint branch: strict, every
             parameter bit-equal, forwards equal; then int8 residency applied
             to the loaded DiT and W8A8 held against the dequant path
  main       Flux Dev text-to-image at 1024x1024 through UniversalEngine with
             synthetic int8-resident weights (W8A8) and a rank-16 LoRA on the
             19 double blocks' q/k/v merged into them at load: three requests
             of 4 steps each, the kernels' launch counts read around each
  trace      (only when asked for) one more int8 request under torch.profiler:
             device time by kernel class, by W8A8 pass, and the idle share
  bf16       one request of 4 steps with synthetic bf16 weights
  int4       one request of 2 steps with the DiT packed int4 (encoders int8)
  hyv15      HunyuanVideo 1.5 i2v at 720x1280 from its manifest, full width and
             depth, synthetic int8 weights: the kernel at the path's shapes
             (113,457 and 34,257 tokens on query-row subsets, the refiner's 1000
             with a bias) timed beside its bound and the library call; two
             identical 33-frame requests (tiled decode, frames and latents
             equal), one TAE preview, one decode tile against float64, one
             121-frame request timed per step; the
             DiT's resident Linears timed by shape, and the step split into
             attention, W8A8 Linears and the rest
then a ``wall`` line, a ``kernels`` line, the card and, last,
``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line. Run from the root of a
checkout: ``python3 chip_smoke.py`` (``--phases kernels,timing`` for a short run;
add ``trace`` to the default list for the profile).
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
MANIFEST = REPO / "manifests" / "image" / "flux-dev-text-to-image.yml"
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# Kernel against its plain version, bf16 on unit-normal inputs. Both limits
# scale with the output: at Flux's shape a typical |out| is about 0.02, so a
# flat limit such as 3e-2 would pass a kernel that dropped a whole key tile.
MAX_ERR_OF_MAX_REF = 2e-2  # max|Δ| ≤ 2e-2·max|ref|, about 2.5 bf16 ulps of the largest output
REL_L2_TOL = 1e-2          # ‖Δ‖₂ ≤ 1e-2·‖ref‖₂
FLUX_SHAPE = dict(b=1, s=4096 + 512, h=24, d=128)
STEPS = 4
SIZE = 1024
BLOCKS = 19 + 38
DEFAULT_PHASES = "kernels,timing,reference,residency,checkpoint,main,bf16,int4,hyv15"
LORA_RANK, LORA_SCALE, LORA_BLOCKS = 16, 0.8, 19
# W8A8 against the same arithmetic elsewhere (f32 compute): x / sx on a rounding
# tie may fall one int8 step apart. int4 and dequant in f32: summation order.
# A bf16 compute dtype on the card against f32 on the CPU adds bf16's 8 bits.
W8A8_REL_L2, F32_REL_L2, BF16_REL_L2 = 2e-3, 1e-4, 1e-2
# W8A8 against the dequant path through 2 + 2 Flux blocks in bf16: twice the 3%
# the JAX package's gate allows through 1 + 1 blocks in f32, since activation
# quantization adds about 1% a matmul and the error grows with depth (weight
# quantization alone reads 3% against the unquantized bf16 model here).
W8A8_VS_DEQUANT = 6e-2
PROMPT_A = "A cinematic photograph of a lighthouse on a rocky coast at golden hour"
PROMPT_B = "An oil painting of a red fox asleep in fresh snow under pine trees"
HYV15_MANIFEST = REPO / "manifests" / "video" / "hunyuanvideo-1.5-i2v.yml"
# 720x1280: latents 45x80 a frame, 9 frames at 33 and 31 at 121; context 729
# SigLIP + 128 byT5 + 1000 Qwen2.5-VL tokens
HYV15_CONTEXT_TOKENS = 729 + 128 + 1000
HYV15_TOKENS = {33: 9 * 45 * 80 + HYV15_CONTEXT_TOKENS, 121: 31 * 45 * 80 + HYV15_CONTEXT_TOKENS}
HYV15_MLLM_TOKENS, HYV15_HEADS, HYV15_STEPS = 1000, 16, 2
HYV15_SIZE, HYV15_FRAMES, HYV15_SCALES = (720, 1280), (33, 33, 121), (4, 16)  # VAE time, space
HYV15_LAUNCHES_PER_STEP = 2 * (54 + 2)  # CFG: two forwards of 54 joint + 2 refiner attentions
# rows, in, out and calls a CFG step of the DiT's resident Linears at 121 frames
# (111,600 image rows, 1,857 context rows, adaLN on one row)
HYV15_LINEAR_CALLS = {(111600, 2048, 2048): 432, (111600, 2048, 8192): 108, (111600, 8192, 2048): 108,
                      (1857, 2048, 2048): 432, (1857, 2048, 8192): 108, (1857, 8192, 2048): 108,
                      (1, 2048, 12288): 216}
HYV15_PROMPT = 'A lighthouse keeper walks along the pier at dusk, a sign reads "NORTH LIGHT"'
# google/byt5-small config.json (the manifest's glyph encoder)
BYT5_SMALL = {"model_type": "t5", "d_model": 1472, "d_ff": 3584, "d_kv": 64, "num_heads": 6,
              "num_layers": 12, "vocab_size": 384, "relative_attention_num_buckets": 32,
              "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6,
              "feed_forward_proj": "gated-gelu"}


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def make_tokenizer():
    """Byte-level BPE tokenizer built in code (the manifests' tokenizer files
    are not vendored; the token values do not change the work done)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {chr(c): c for c in range(256)}
    vocab.update({f"<{i}>": 256 + i for i in range(64)})
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[], unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    return tok


def agreement(out, ref) -> dict:
    """How far ``out`` is from ``ref``, read against the limits above."""
    import torch

    d, r = out.float() - ref.float(), ref.float()
    max_err, max_ref = d.abs().max().item(), r.abs().max().item()
    rel_l2 = (torch.linalg.vector_norm(d) / torch.linalg.vector_norm(r)).item()
    return {"max_abs_err": max_err, "max_abs_ref": max_ref, "rel_l2": rel_l2,
            "tol": {"max_abs_err": MAX_ERR_OF_MAX_REF * max_ref, "rel_l2": REL_L2_TOL},
            "within": max_err <= MAX_ERR_OF_MAX_REF * max_ref and rel_l2 <= REL_L2_TOL}


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` single-call CUDA-event timings after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, calls: int = 20, warmup: int = 3) -> float:
    """Time per call of ``calls`` calls queued between one pair of CUDA events:
    the card's time alone, as in the denoise loop, where launches queue ahead
    of the card. ``time_ms`` also counts the host's work before each launch."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


# -- kernels ---------------------------------------------------------------------------


def qkv(b, sq, sk, h, d, seed):
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    mk = lambda s: torch.randn(b, s, h, d, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    return mk(sq), mk(sk), mk(sk)


def phase_kernels():
    import torch

    from apex_studio_tpu_torch.ops.attention import _prep_bias
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention, flash_attention_reference

    cases = []

    def run_case(name, q, k, v, bias=None, causal=False):
        out = flash_attention(q, k, v, bias=bias, is_causal=causal)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k, v, bias=bias, is_causal=causal)
        agree = agreement(out, ref)
        finite = bool(torch.isfinite(out.float()).all())
        cases.append({"case": name, "shape": list(q.shape), "sk": k.shape[1], "causal": causal,
                      "bias": bias is not None, **agree, "finite": finite,
                      "ok": finite and agree["within"]})
        return agree["max_abs_err"], ref

    s = FLUX_SHAPE
    q, k, v = qkv(s["b"], s["s"], s["s"], s["h"], s["d"], 0)
    flux_err, flux_ref = run_case("flux_1024px", q, k, v)
    # What three faults of a kernel would read against the limits at Flux's
    # shape: the last 64-key tile dropped; exp2 taken without log2 e (the
    # softmax at ln 2 of its scale); and query rows 64-127 of every 128-row
    # tile computed with the first 128-key tile replaced by the second (what a
    # consumer warpgroup that read a stale stage would give). Each must fall
    # outside them.
    stale_k, stale_v = k.clone(), v.clone()
    stale_k[:, :128], stale_v[:, :128] = k[:, 128:256], v[:, 128:256]
    upper = (torch.arange(s["s"], device="cuda") % 128) >= 64
    stale = flux_ref.clone()
    stale[:, upper] = flash_attention_reference(q[:, upper], stale_k, stale_v)
    probes = {
        "dropped_last_key_tile": flash_attention_reference(q, k[:, :-64], v[:, :-64]),
        "softmax_scale_times_ln2": flash_attention_reference(q, k, v, scale=s["d"] ** -0.5 * math.log(2)),
        "stale_tile_in_second_warpgroup": stale,
    }
    probes = {name: agreement(wrong, flux_ref) for name, wrong in probes.items()}
    emit({"phase": "tolerance_probes", "shape": list(q.shape), "probes": probes})
    check(not any(p["within"] for p in probes.values()),
          f"the kernel tolerance cannot see a faulty kernel: {probes}")
    del q, k, v, flux_ref, stale, stale_k, stale_v
    run_case("ragged_sq72_sk200", *qkv(2, 72, 200, 4, 128, 1))
    q, k, v = qkv(2, 96, 160, 4, 128, 2)
    lengths = torch.tensor([50, 0], device="cuda")  # batch 1: every key masked
    mask = torch.arange(160, device="cuda")[None, :] < lengths[:, None]
    run_case("key_padding_bias_row_fully_masked", q, k, v, bias=_prep_bias(None, mask))
    run_case("causal_s384_d64", *qkv(1, 384, 384, 4, 64, 3), causal=True)
    # The edges of the 128 x 128 tiles and of the two 64-row warpgroups.
    run_case("ragged_sq129_sk257", *qkv(1, 129, 257, 4, 128, 4))
    run_case("sq40_sk1", *qkv(2, 40, 1, 3, 128, 5))
    run_case("sk128_exact", *qkv(1, 200, 128, 4, 128, 6))
    run_case("sk129", *qkv(1, 200, 129, 4, 128, 7))
    run_case("ragged_sq129_sk257_d64", *qkv(2, 129, 257, 3, 64, 8))
    run_case("causal_s200_d128", *qkv(2, 200, 200, 3, 128, 9), causal=True)
    run_case("causal_s384_d128", *qkv(1, 384, 384, 4, 128, 10), causal=True)
    q, k, v = qkv(2, 150, 300, 4, 128, 11)
    shared = _prep_bias(None, torch.arange(300, device="cuda")[None, :] < 211)  # [1,1,1,Sk]
    run_case("bias_1_by_sk_batch_stride_0", q, k, v, bias=shared)
    g = torch.Generator("cuda").manual_seed(12)
    fused = torch.randn(2, 257, 3, 4, 128, generator=g, device="cuda").to(torch.bfloat16)
    run_case("views_of_fused_projection", fused[:, :, 0], fused[:, :, 1], fused[:, :, 2])
    # The first 128-key tile wholly masked by the bias: the running max starts
    # at -1e30 log2 e and must recover on the second tile.
    q, k, v = qkv(1, 130, 300, 4, 128, 13)
    late = _prep_bias(None, torch.arange(300, device="cuda")[None, :] >= 128)
    run_case("first_key_tile_bias_masked", q, k, v, bias=late)
    emit({"phase": "kernels", "cases": cases})
    bad = [c["case"] for c in cases if not c["ok"]]
    check(not bad, f"flash kernel disagrees with its plain version: {bad}")
    return flux_err


def phase_timing():
    """Two rows at Flux's query length: the main path's shape against the plain
    version and the library call, and a ragged Sk with a [1, Sk] bias (tail and
    bias paths paid) against the library call alone. Returns the first."""
    import torch
    import torch.nn.functional as F

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention, flash_attention_reference

    def row(q, k, v, bias, kernel_ms, plain_ms, library_ms, kernel_queued_ms, library_queued_ms):
        b, sq, h, d = q.shape
        sk = k.shape[1]
        flops = 4.0 * b * h * sq * sk * d
        # q, k, v (and the bias) read once, o written once
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + (
            bias.numel() * 4 if bias is not None else 0)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        out = {"phase": "timing", "kernel": "flash_attention", "shape": list(q.shape), "sk": sk,
               "bias": bias is not None, "ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library_call": "torch.nn.functional.scaled_dot_product_attention",
               "bound_ms": bound_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "of_bound": bound_ms / kernel_ms, "vs_library": kernel_ms / library_ms,
               "queued_ms": kernel_queued_ms, "library_queued_ms": library_queued_ms,
               "flops": flops, "bytes": nbytes, "tflops_achieved": flops / kernel_ms / 1e9}
        emit(out)
        return out

    s = FLUX_SHAPE
    q, k, v = qkv(s["b"], s["s"], s["s"], s["h"], s["d"], 0)
    kernel_ms = time_ms(lambda: flash_attention(q, k, v))
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v), reps=20)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    flux_row = row(q, k, v, None, kernel_ms, plain_ms, library_ms,
                   queued_ms(lambda: flash_attention(q, k, v)),
                   queued_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)))

    sk = 4500
    k, v, kt, vt = k[:, :sk], v[:, :sk], kt[:, :, :sk].contiguous(), vt[:, :, :sk].contiguous()
    bias = torch.zeros(1, sk, device="cuda")
    bias[:, 4400:] = -1e30  # the last 100 keys are padding
    kernel_ms = time_ms(lambda: flash_attention(q, k, v, bias=bias))
    # The library call's mask: same values in bf16, its rows 16-byte aligned.
    mask = torch.zeros(1, 1, 1, 4504, device="cuda", dtype=torch.bfloat16)[..., :sk]
    mask.copy_(bias[:, None, None, :])
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    row(q, k, v, bias, kernel_ms, None, library_ms,
        queued_ms(lambda: flash_attention(q, k, v, bias=bias)),
        queued_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)))
    return flux_row


# -- tiny reference ----------------------------------------------------------------------


def phase_reference():
    """The tiny Flux DiT on the card in bf16 (flash kernel) against the same
    weights on the CPU in f32 (plain version)."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers.flux import FluxConfig, FluxTransformer2DModel

    cfg = FluxConfig(in_channels=16, out_channels=16, num_layers=2, num_single_layers=2,
                     attention_head_dim=128, num_attention_heads=2, joint_attention_dim=64,
                     pooled_projection_dim=32, axes_dims_rope=(16, 56, 56))
    cpu = materialize_random(lambda: FluxTransformer2DModel(cfg, dtype=torch.float32),
                             torch.device("cpu"), seed=7, std=0.1)
    gpu = materialize_random(lambda: FluxTransformer2DModel(cfg, dtype=torch.bfloat16),
                             torch.device("cuda"), seed=7, std=0.1)
    gpu.load_state_dict(cpu.state_dict())  # cast to each parameter's dtype
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 64, 16)).astype(np.float32))
    txt = torch.from_numpy(rng.normal(size=(1, 20, 64)).astype(np.float32))
    pooled = torch.from_numpy(rng.normal(size=(1, 32)).astype(np.float32))
    t, g = torch.tensor([0.7]), torch.tensor([3.5])
    with torch.inference_mode():
        ref = cpu(x, txt, pooled, t, g, grid_hw=(8, 8))
        out = gpu(*(a.cuda() for a in (x, txt, pooled, t, g)), grid_hw=(8, 8)).float().cpu()
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    tol = 5e-2  # bf16 weights and activations through 4 blocks against f32
    emit({"phase": "reference", "model": "flux tiny (2+2 blocks, 2 heads of 128)",
          "max_rel_err": rel, "tol": tol, "finite": bool(torch.isfinite(out).all())})
    check(bool(torch.isfinite(out).all()) and rel <= tol,
          f"tiny Flux on the card disagrees with the CPU: {rel}")


# -- int8 / int4 residency ---------------------------------------------------------------


# rows, in, out: Flux Dev's resident Linear shapes at 1024px (image stream 4096
# rows, text stream 512, joined 4608 in the single blocks, adaLN on 1 row)
LINEAR_SHAPES = [
    (4608, 3072, 3072), (4608, 3072, 12288), (4608, 15360, 3072),
    (4096, 3072, 3072), (4096, 3072, 12288), (4096, 12288, 3072),
    (512, 3072, 3072), (512, 3072, 12288), (512, 12288, 3072),
    (1, 3072, 18432), (1, 3072, 9216), (1, 3072, 3072),
]


def resident_linear(k, n, bits, dtype, seed, device="cuda"):
    """A ``Linear`` built on ``meta`` and filled on ``device``; ``bits`` 8 or 4
    makes its weight resident whatever its size, ``None`` leaves it ``dtype``."""
    import torch

    from apex_studio_tpu_torch.models.layers import Linear
    from apex_studio_tpu_torch.quantize.residency import materialize_random_int4, materialize_random_int8

    with torch.device("meta"):
        lin = Linear(k, n, dtype=dtype)
    fill = materialize_random_int4 if bits == 4 else materialize_random_int8
    fill(lin, device=device, seed=seed, min_numel=1 if bits else 1 << 62)
    return lin.eval().requires_grad_(False)


def residency_exact():
    """(i) ``int_mm`` (``torch._int_mm`` behind the row padding) against the
    same product in float64, where every partial sum is an integer below 2**53
    and so exact. Also that the ``[out, in]`` weight goes in as a view: the
    memory one call adds beyond its s32 result stays far below the weight's
    size."""
    import torch

    from apex_studio_tpu_torch.models.layers import int_mm

    g = torch.Generator("cuda").manual_seed(0)
    cases = []
    for k in (3072, 15360):
        for n in (3072, 18432):
            w = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
            w64 = w.double()
            for m in (1, 16, 17, 512, 4608):
                a = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
                int_mm(a, w)  # the library's workspace, if it takes one, is taken here
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                out = int_mm(a, w)
                torch.cuda.synchronize()
                added = torch.cuda.max_memory_allocated() - before
                exact = (out.dtype == torch.int32 and tuple(out.shape) == (m, n)
                         and torch.equal(out.double(), a.double() @ w64.t()))
                beyond_output = added - 4 * max(m, 32 if m <= 16 else m) * n  # the s32 result, padded rows too
                cases.append({"m": m, "k": k, "n": n, "exact": bool(exact), "bytes_added": added,
                              "bytes_beyond_output": beyond_output, "weight_bytes": w.numel(),
                              "weight_copied": beyond_output >= w.numel() // 2})
                del out
            del w, w64
    emit({"phase": "residency", "check": "int_mm_exact", "reference": "float64 product", "cases": cases})
    check(all(c["exact"] for c in cases),
          f"int_mm is not exact at {[(c['m'], c['k'], c['n']) for c in cases if not c['exact']]}")
    check(not any(c["weight_copied"] for c in cases), "int_mm copies the weight")


def residency_against_cpu():
    """(ii) W8A8 and int4 Linears on the card against the same weights on the
    CPU in f32, at one row, 64 rows and a 3-D input."""
    import torch

    from apex_studio_tpu_torch.quantize.residency import apply_int4_residency, apply_int8_residency

    cases = []
    for bits in (8, 4):
        for shape, k, n in (((1,), 3072, 18432), ((64,), 3072, 3072), ((2, 40), 12288, 3072)):
            cpu = resident_linear(k, n, None, torch.float32, seed=bits + k, device="cpu")
            (apply_int4_residency if bits == 4 else apply_int8_residency)(cpu, min_numel=1)
            g = torch.Generator().manual_seed(n)
            x = torch.randn(*shape, k, generator=g).to(torch.bfloat16)
            with torch.inference_mode():
                ref = cpu(x.float())
            for dtype, tol in ((torch.float32, W8A8_REL_L2 if bits == 8 else F32_REL_L2),
                               (torch.bfloat16, BF16_REL_L2)):
                card = resident_linear(k, n, None, dtype, seed=0)
                card.set_quantized(cpu.weight.cuda(), cpu.weight_scale.cuda(), bits)
                card.bias.data.copy_(cpu.bias)
                with torch.inference_mode():
                    out = card(x.cuda())
                torch.cuda.synchronize()
                rel = rel_l2(out.cpu(), ref)
                cases.append({"bits": bits, "x": [*shape, k], "out": n, "compute": str(dtype)[6:],
                              "rel_l2": rel, "tol": tol, "max_abs_err": (out.cpu().float() - ref).abs().max().item(),
                              "ok": out.dtype == dtype and tuple(out.shape) == (*shape, n) and rel <= tol})
    emit({"phase": "residency", "check": "linear_card_vs_cpu_f32", "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"resident Linear on the card disagrees with the CPU: {bad}")


def residency_merges():
    """(iii) ``_merge8`` / ``_merge4`` on the card against the same arithmetic
    in numpy: scales to 1e-6 relative, values equal in 99.9% of entries and
    never more than one step apart."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.lora.manager import _merge4, _merge8

    rng = np.random.default_rng(0)
    n, k = 3072, 3072
    d = (rng.normal(size=(n, LORA_RANK)).astype(np.float32) * 0.01) @ (
        rng.normal(size=(LORA_RANK, k)).astype(np.float32) * 0.01) * np.float32(LORA_SCALE)
    s8 = np.full(n, 0.02 / np.sqrt(k) / 127, np.float32)
    q8 = rng.integers(-127, 128, size=(n, k), dtype=np.int8)
    packed = rng.integers(0, 256, size=(n // 2, k), dtype=np.uint8)
    s4 = np.full(n, 0.02 / np.sqrt(k) / 7, np.float32)

    def requantize(w, qmax, lo):
        absmax = np.abs(w).max(axis=1)
        new_s = np.where(absmax == 0, 1.0, absmax / np.float32(qmax)).astype(np.float32)
        return np.clip(np.rint(w / new_s[:, None]), lo, qmax).astype(np.int16), new_s

    ref8, ref_s8 = requantize(q8.astype(np.float32) * s8[:, None] + d, 127, -127)
    planes = np.concatenate([(packed & 0xF).astype(np.int8) - 8, (packed >> 4).astype(np.int8) - 8])
    ref4, ref_s4 = requantize(planes.astype(np.float32) * s4[:, None] + d, 7, -8)

    cuda = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    new8, new_s8 = _merge8(cuda(q8), cuda(s8), cuda(d))
    new4, new_s4 = _merge4(cuda(packed), cuda(s4), cuda(d))
    torch.cuda.synchronize()
    got4 = torch.cat([(new4 & 0xF).to(torch.int16) - 8, (new4 >> 4).to(torch.int16) - 8]).cpu().numpy()
    rows = []
    for name, got, ref, got_s, ref_s in (("merge8", new8.cpu().numpy().astype(np.int16), ref8, new_s8, ref_s8),
                                         ("merge4", got4, ref4, new_s4, ref_s4)):
        scale_err = float(np.abs(got_s.cpu().numpy() / ref_s - 1).max())
        equal, worst = float((got == ref).mean()), int(np.abs(got - ref).max())
        rows.append({"merge": name, "shape": [n, k], "equal_share": equal, "max_step_diff": worst,
                     "scale_rel_err": scale_err, "ok": equal >= 0.999 and worst <= 1 and scale_err <= 1e-6})
    emit({"phase": "residency", "check": "lora_merge_card_vs_numpy", "cases": rows})
    check(all(r["ok"] for r in rows), f"quantized LoRA merge disagrees with numpy: {rows}")


def residency_timing(shapes=LINEAR_SHAPES, phase="residency"):
    """(iv) One line per Linear shape (Flux's unless ``shapes`` says other):
    bf16 ``F.linear``, W8A8 whole and by pass, int4. Each is the time per call
    of 20 queued calls; the weight rotates through enough copies to exceed the
    50 MB L2, as in the model, where every call has its own weight."""
    import torch

    from apex_studio_tpu_torch.models.layers import int_mm, quantize_rows, rescale

    def rotating(mods, fn):
        turn = [0]

        def call():
            turn[0] += 1
            return fn(mods[turn[0] % len(mods)])
        return call

    rows = []
    for m, k, n in shapes:
        copies = min(8, max(2, -(-100_000_000 // (k * n))))
        plain, w8, w4 = ([resident_linear(k, n, bits, torch.bfloat16, seed=i) for i in range(copies)]
                         for bits in (None, 8, 4))
        g = torch.Generator("cuda").manual_seed(m)
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        with torch.inference_mode():
            xq, sx = quantize_rows(x)
            acc = int_mm(xq, w8[0].weight)
            t = {
                "bf16_ms": queued_ms(rotating(plain, lambda lin: lin(x))),
                "w8a8_ms": queued_ms(rotating(w8, lambda lin: lin(x))),
                "w8a8_quantize_ms": queued_ms(lambda: quantize_rows(x)),
                "w8a8_int_mm_ms": queued_ms(rotating(w8, lambda lin: int_mm(xq, lin.weight))),
                "w8a8_rescale_ms": queued_ms(lambda: rescale(acc, sx, w8[0].weight_scale, torch.bfloat16)),
                "w4_ms": queued_ms(rotating(w4, lambda lin: lin(x))),
            }
        ops = 2.0 * m * k * n
        io = 2 * m * k + 2 * m * n + 2 * n  # x in, y out, bias: bf16
        bounds = {}
        for name, peak, weight_bytes in (("bf16", PEAK_BF16_FLOPS, 2 * k * n),
                                         ("int8", PEAK_INT8_OPS, k * n + 4 * n),
                                         ("int4", PEAK_BF16_FLOPS, k * n // 2 + 4 * n)):
            t_ops, t_bytes = ops / peak * 1e3, (io + weight_bytes) / PEAK_BYTES * 1e3
            bounds[f"{name}_bound_ms"] = max(t_ops, t_bytes)
            bounds[f"{name}_bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        row = {"phase": phase, "check": "linear_timing", "rows": m, "in": k, "out": n,
               "weight_copies": copies, **t, **bounds,
               "int8_tops_achieved": ops / t["w8a8_int_mm_ms"] / 1e9,
               "bf16_tflops_achieved": ops / t["bf16_ms"] / 1e9}
        emit(row)
        rows.append(row)
        del plain, w8, w4, x, xq, sx, acc
        release()
    return rows


def phase_residency():
    residency_exact()
    release()
    residency_against_cpu()
    residency_merges()
    release()
    return residency_timing()


# -- checkpoints -------------------------------------------------------------------------


def phase_checkpoint(home: Path):
    """Write a Flux DiT (full width, 2 double + 2 single blocks, bf16) in the
    BFL single-file naming and the full Flux VAE (f32) in diffusers naming,
    then load both through the engine's checkpoint branch."""
    import torch
    import yaml

    from apex_studio_tpu_torch.engine import UniversalEngine
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.loaders.export import flux_bfl_state_dict, published_state_dict
    from apex_studio_tpu_torch.loaders.safetensors_io import safetensors_keys, save_safetensors
    from apex_studio_tpu_torch.models.transformers.flux import FluxConfig, FluxTransformer2DModel
    from apex_studio_tpu_torch.models.vaes.autoencoder_kl import AutoencoderKL, AutoencoderKLConfig
    from apex_studio_tpu_torch.quantize.residency import apply_int8_residency

    root = home / "checkpoint"
    root.mkdir()
    depth = {"num_layers": 2, "num_single_layers": 2}
    dit = materialize_random(lambda: FluxTransformer2DModel(FluxConfig(**depth), dtype=torch.bfloat16),
                             torch.device("cuda"), seed=11)
    vae = materialize_random(lambda: AutoencoderKL(AutoencoderKLConfig(), dtype=torch.float32),
                             torch.device("cuda"), seed=12)
    t0 = time.perf_counter()
    save_safetensors(root / "flux1-dev.safetensors", flux_bfl_state_dict(dit.state_dict()))
    save_safetensors(root / "vae.safetensors", published_state_dict("autoencoder_kl", vae.state_dict()))
    write_s = time.perf_counter() - t0
    keys = safetensors_keys(root / "flux1-dev.safetensors")
    check("model.diffusion_model.double_blocks.0.img_attn.qkv.weight" in keys
          and "model.diffusion_model.single_blocks.1.linear1.weight" in keys,
          "the DiT checkpoint is not in the BFL single-file naming")

    doc = yaml.safe_load(MANIFEST.read_text())
    for comp in doc["spec"]["components"]:
        if comp["type"] == "transformer":
            comp.pop("config_path", None)
            comp.update(config=dict(depth), model_path=str(root / "flux1-dev.safetensors"))
        elif comp["type"] == "vae":
            comp.pop("config_path", None)
            comp.update(config={"latent_channels": 16}, precision="fp32",
                        model_path=str(root / "vae.safetensors"))
    (root / "manifest.yml").write_text(yaml.safe_dump(doc))

    os.environ.pop("APEX_SYNTHETIC_WEIGHTS", None)  # the checkpoint branch
    os.environ["APEX_HOME_DIR"] = str(root)
    engine = UniversalEngine(root / "manifest.yml", device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.load_component_by_type("transformer")  # strict: raises on a missing or unexpected key
    engine.load_component_by_type("vae")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    def same_state(loaded, source, name):
        got, want = loaded.state_dict(), source.state_dict()
        check(sorted(got) == sorted(want), f"{name}: loaded keys differ from the written module's")
        wrong = [k for k in want if got[k].dtype != want[k].dtype or got[k].device != want[k].device
                 or not torch.equal(got[k], want[k])]
        check(not wrong, f"{name}: parameters differ after loading: {wrong[:5]}")
        return len(want), sum(t.numel() for t in want.values())

    n_dit, params_dit = same_state(engine.transformer, dit, "DiT")
    n_vae, params_vae = same_state(engine.vae, vae, "VAE")

    g = torch.Generator("cuda").manual_seed(3)
    rand = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    args = (rand(1, 4096, 64), rand(1, 512, 4096), rand(1, 768),
            torch.tensor([0.7], device="cuda"), torch.tensor([3.5], device="cuda"))
    z = rand(1, 16, 32, 32)
    with torch.inference_mode():
        direct = dit(*args, grid_hw=(64, 64))
        loaded = engine.transformer(*args, grid_hw=(64, 64))
        vae_same = torch.equal(engine.vae.decode(z), vae.decode(z))
        dit_same = torch.equal(loaded, direct)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resident = apply_int8_residency(engine.transformer)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        w8a8 = engine.transformer(*args, grid_hw=(64, 64))
        os.environ["APEX_INT8_COMPUTE"] = "0"
        try:
            dequant = engine.transformer(*args, grid_hw=(64, 64))
        finally:
            del os.environ["APEX_INT8_COMPUTE"]
    torch.cuda.synchronize()
    row = {"phase": "checkpoint", "dit_tensors": n_dit, "dit_parameters": params_dit,
           "vae_tensors": n_vae, "vae_parameters": params_vae, "file_keys": len(keys),
           "file_gib": (root / "flux1-dev.safetensors").stat().st_size / 2**30,
           "seconds_write": write_s, "seconds_load": load_s, "parameters_bit_equal": True,
           "dit_forward_equal": dit_same, "vae_decode_equal": vae_same,
           "int8_resident_weights": resident, "seconds_int8_residency": quantize_s,
           "finite": bool(torch.isfinite(w8a8.float()).all()),
           "w8a8_vs_dequant_rel_l2": rel_l2(w8a8, dequant), "tol": W8A8_VS_DEQUANT,
           "w8a8_vs_bf16_rel_l2": rel_l2(w8a8, direct), "dequant_vs_bf16_rel_l2": rel_l2(dequant, direct)}
    emit(row)
    check(dit_same, "the loaded DiT's forward differs from the written module's")
    check(vae_same, "the loaded VAE's decode differs from the written module's")
    check(resident > 0 and row["finite"], "int8 residency of the loaded DiT failed")
    check(row["w8a8_vs_dequant_rel_l2"] <= W8A8_VS_DEQUANT,
          f"W8A8 is {row['w8a8_vs_dequant_rel_l2']} from the dequant path")
    shutil.rmtree(root, ignore_errors=True)
    del engine, dit, vae, direct, loaded, w8a8, dequant
    release()


# -- main path ---------------------------------------------------------------------------


def rel_l2(out, ref) -> float:
    import torch

    return (torch.linalg.vector_norm(out.float() - ref.float())
            / torch.linalg.vector_norm(ref.float())).item()


def release() -> None:
    """Hand the memory of what the caller has dropped back to the card."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def write_flux_lora(path: Path) -> int:
    """A rank-16 PEFT-named LoRA on q/k/v of the 19 double blocks (57
    adapters), seeded; returns the adapter count."""
    import numpy as np

    from apex_studio_tpu_torch.loaders.safetensors_io import save_safetensors

    rng = np.random.default_rng(0)
    sd = {}
    for i in range(LORA_BLOCKS):
        for proj in ("to_q", "to_k", "to_v"):
            base = f"transformer_blocks.{i}.attn.{proj}"
            sd[f"{base}.lora_A.weight"] = rng.normal(size=(LORA_RANK, 3072)).astype(np.float32) * 0.01
            sd[f"{base}.lora_B.weight"] = rng.normal(size=(3072, LORA_RANK)).astype(np.float32) * 0.01
    save_safetensors(path, sd)
    return len(sd) // 2


def drive(label: str, weights: str, requests, steps: int, home: Path, lora: Path = None,
          tally_request: int = None):
    """Requests through ``UniversalEngine`` with synthetic ``weights``
    (``bf16`` / ``int8`` / ``int4``), each with the kernels' launch counts set
    to 0 before and read after. ``lora`` goes in as a request LoRA and is
    merged when the transformer loads. Request ``tally_request`` (1-based)
    counts the transformer's Linear calls by shape through forward hooks."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine import UniversalEngine
    from apex_studio_tpu_torch.models.layers import Linear
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention
    from apex_studio_tpu_torch.quantize.residency import count_resident

    os.environ["APEX_SYNTHETIC_WEIGHTS"] = weights
    os.environ["APEX_HOME_DIR"] = str(home / label)  # its own T5 disk cache
    selected = {"loras": [{"source": str(lora), "scale": LORA_SCALE}]} if lora else None
    engine = UniversalEngine(MANIFEST, device="cuda", selected_components=selected)
    tok = make_tokenizer()
    for spec in engine.component_specs.values():
        if spec.get("type") == "text_encoder":
            spec["tokenizer"] = tok

    # Observe the latents the engine hands to the VAE (finite check) without
    # changing the path: the VAE loads first, as the engine's run would load it.
    engine.load_component_by_type("vae")
    decode = engine.vae.decode
    latents_finite = []

    def observed_decode(z):
        latents_finite.append(bool(torch.isfinite(z).all()))
        return decode(z)

    engine.vae.decode = observed_decode

    apply_loras, lora_seconds = engine._apply_loras, []

    def timed_apply_loras(model, family):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        apply_loras(model, family)
        torch.cuda.synchronize()
        lora_seconds.append(time.perf_counter() - t0)

    engine._apply_loras = timed_apply_loras

    results, frames_out = [], []
    for i, (prompt, seed) in enumerate(requests):
        stamps = {}

        def progress(p, message, *_a, **_k):
            torch.cuda.synchronize()
            stamps.setdefault(message, time.perf_counter())

        tally, hooks = {}, []
        if tally_request == i + 1 and engine.transformer is not None:
            def count(mod, args, out):
                x = args[0]
                mode = "bf16" if mod.weight_scale is None else f"int{mod.weight_bits}"
                key = (x.numel() // x.shape[-1], x.shape[-1], out.shape[-1], mode)
                tally[key] = tally.get(key, 0) + 1

            hooks = [m.register_forward_hook(count) for m in engine.transformer.modules()
                     if isinstance(m, Linear)]
        latents_finite.clear()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        frames = engine.run(prompt=prompt, height=SIZE, width=SIZE, num_inference_steps=steps,
                            guidance_scale=3.5, seed=seed, progress_callback=progress)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = flash_attention.launches
        for h in hooks:
            h.remove()

        step_t = [stamps[f"Denoising step {j}/{steps}"] for j in range(1, steps + 1)]
        per_step = [b - a for a, b in zip([stamps["Timesteps computed"]] + step_t[:-1], step_t)]
        row = {
            "phase": label, "weights": weights, "request": i + 1, "prompt": prompt[:40], "seed": seed,
            "seconds_total": total,
            "seconds_encode": stamps["Encoded prompts"] - stamps["Encoding prompts"],
            "seconds_load_transformer": stamps["Initialized latent noise"] - stamps["Encoded prompts"],
            "seconds_per_step": per_step,
            "seconds_decode": stamps["Completed t2i pipeline"] - stamps["Denoising complete"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "flash_launches": launches, "flash_launches_expected": BLOCKS * steps,
            "frames": [list(f.shape) for f in frames], "latents_finite": latents_finite,
            "card": torch.cuda.get_device_name(0),
        }
        if hooks:
            row["linear_hooks_on"] = True  # this request's step times carry the hooks' host cost
            row["linear_calls_per_step"] = [
                {"rows": m, "in": k, "out": n, "weights": mode, "calls": c / steps}
                for (m, k, n, mode), c in sorted(tally.items(), key=lambda kv: -kv[1])]
        if i == 0:
            row["resident_weights"] = count_resident(engine.transformer)
            row["seconds_lora_merge"] = sum(lora_seconds)
            row["loras"] = [{"scale": r["scale"], "applied": r["applied"], "skipped": len(r["skipped"])}
                            for r in engine.lora_results]
        emit(row)
        check(len(frames) == 1 and frames[0].shape == (SIZE, SIZE, 3) and frames[0].dtype == np.uint8,
              f"{label} request {i + 1}: bad frames {row['frames']}")
        check(latents_finite == [True], f"{label} request {i + 1}: latents not finite")
        check(launches == BLOCKS * steps,
              f"{label} request {i + 1}: flash launched {launches} times, expected {BLOCKS * steps}")
        results.append(row)
        frames_out.append(frames[0])
    return results, frames_out, engine


def phase_main(home: Path):
    """The main path: int8-resident weights computed W8A8, a rank-16 LoRA
    merged into them at load, three requests."""
    import numpy as np

    lora = home / "style_rank16.safetensors"
    adapters = write_flux_lora(lora)
    rows, frames, engine = drive("main", "int8", [(PROMPT_A, 0), (PROMPT_B, 1), (PROMPT_A, 0)],
                                 STEPS, home, lora=lora, tally_request=2)
    first = rows[0]
    check(first["loras"] == [{"scale": LORA_SCALE, "applied": adapters, "skipped": 0}] and adapters == 57,
          f"LoRA merge: {first['loras']}, expected {adapters} applied and 0 skipped")
    check(first["resident_weights"] > 0, "no weight of the transformer is int8-resident")
    quantized_calls = sum(c["calls"] for c in rows[1]["linear_calls_per_step"] if c["weights"] == "int8")
    check(quantized_calls > 0, "the main path ran no int8 Linear")
    same = bool(np.array_equal(frames[0], frames[2]))
    differ = not np.array_equal(frames[0], frames[1])
    emit({"phase": "main", "requests_1_3_identical": same, "requests_1_2_differ": differ,
          "int8_linear_calls_per_step": quantized_calls})
    check(same, "requests 1 and 3 (same prompt and seed) differ")
    check(differ, "requests 1 and 2 (other prompt and seed) are identical")
    return rows, engine


def kernel_class(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_attention"
    if any(tag in name.lower() for tag in ("gemm", "xmma", "nvjet", "cutlass", "wgmma")):
        return "gemm"
    if name.startswith(("Memcpy", "Memset")):
        return "memcpy_memset"
    return "other"


W8A8_PASSES = ("quantize_rows", "int_mm", "rescale")


def phase_trace(engine):
    """One more request on the main path's engine (prompt A, seed 0: T5 from
    the disk cache, latents returned, no decode) under torch.profiler: device
    time by kernel class, by W8A8 pass (each pass of models/layers.py runs
    inside a named profiler range for the length of this phase, and a kernel
    that starts inside a range counts for that pass), the top kernels, and the
    device's idle share between its first and last kernel."""
    import functools

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from apex_studio_tpu_torch.models import layers

    def ranged(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with record_function(f"w8a8.{name}"):
                return fn(*args, **kwargs)
        return call

    passes = {name: getattr(layers, name) for name in W8A8_PASSES}
    try:
        for name, fn in passes.items():
            setattr(layers, name, ranged(name, fn))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.run(prompt=PROMPT_A, height=SIZE, width=SIZE, num_inference_steps=STEPS,
                       guidance_scale=3.5, seed=0, return_latents=True)
            torch.cuda.synchronize()
    finally:
        for name, fn in passes.items():
            setattr(layers, name, fn)
    device = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    # a named range shows on the device too, from its first kernel to its last
    ranges = sorted((start, end, name) for name, start, end in device if name.startswith("w8a8."))
    spans = [d for d in device if not d[0].startswith("w8a8.")]
    if not spans:
        emit({"phase": "trace", "result": "not measured: the profiler recorded no device kernel"})
        return
    starts = [r[0] for r in ranges]
    by_class, by_name = {}, {}
    for name, start, end in spans:
        c = kernel_class(name)
        i = bisect.bisect_right(starts, start + 0.5) - 1  # timestamps are microseconds
        if i >= 0 and start < ranges[i][1] + 0.5:
            c = ranges[i][2]  # launched by a W8A8 pass, whatever the kernel
        by_class[c] = by_class.get(c, 0.0) + (end - start)
        n, total = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, total + (end - start))
    busy, last = 0.0, None  # union of kernel intervals (us)
    for _, start, end in sorted(spans, key=lambda x: x[1]):
        if last is None or start >= last:
            busy += end - start
            last = end
        elif end > last:
            busy += end - last
            last = end
    window = max(e for _, _, e in spans) - min(s for _, s, _ in spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:14]
    emit({"phase": "trace", "weights": os.environ.get("APEX_SYNTHETIC_WEIGHTS"),
          "window_ms": window / 1e3, "busy_ms": busy / 1e3,
          "idle_share": 1.0 - busy / window, "kernels": len(spans),
          "w8a8_ranges_on_device": len(ranges),
          "ms_by_class": {c: t / 1e3 for c, t in sorted(by_class.items())},
          "share_of_busy": {c: t / busy for c, t in sorted(by_class.items())},
          "top_kernels": [{"name": n[:90], "calls": c, "ms": t / 1e3} for n, (c, t) in top]})


# -- HunyuanVideo 1.5 i2v ------------------------------------------------------------------


def hyv15_kernel_rows():
    """The flash kernel at the HunyuanVideo 1.5 path's three shapes: the joint
    attention at 121 and 33 frames (unmasked) and the token refiner's masked
    attention. The plain version's f32 scores cannot be held whole at 113,457
    tokens (824 GB), so there the kernel is held against it on query row
    subsets over all keys: the first 128-row tile, the last (ragged) tile and
    128 rows across an interior tile edge. Each row is timed beside
    ``scaled_dot_product_attention`` and its bound."""
    import torch
    import torch.nn.functional as F

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention, flash_attention_reference

    rows, cases = [], []
    for name, s, bias_valid in (("joint_121f", HYV15_TOKENS[121], None),
                                ("joint_33f", HYV15_TOKENS[33], None),
                                ("refiner", HYV15_MLLM_TOKENS, 612)):
        q, k, v = qkv(1, s, s, HYV15_HEADS, 128, 20 + len(rows))
        bias = None
        if bias_valid is not None:  # the refiner's text mask as a [1, Sk] bias
            bias = torch.zeros(1, s, device="cuda")
            bias[:, bias_valid:] = -1e30
        out = flash_attention(q, k, v, bias=bias)
        torch.cuda.synchronize()
        tail = s % 128 or 128
        subsets = ({"all_rows": slice(0, s)} if s <= 4096 else
                   {"first_tile": slice(0, 128), "last_tile": slice(s - tail, s),
                    "interior_tile_edge": slice(s // 256 * 128 - 64, s // 256 * 128 + 64)})
        for label, sl in subsets.items():
            ref = flash_attention_reference(q[:, sl], k, v, bias=bias)
            agree = agreement(out[:, sl], ref)
            finite = bool(torch.isfinite(out[:, sl].float()).all())
            cases.append({"case": f"hyv15_{name}_{label}", "shape": list(q.shape), "rows": [sl.start, sl.stop],
                          "bias": bias is not None, **agree, "finite": finite,
                          "ok": finite and agree["within"]})
            del ref
        plain_rows = slice(0, min(s, 128))
        plain_ms = time_ms(lambda: flash_attention_reference(q[:, plain_rows], k, v, bias=bias), reps=5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None
        if bias is not None:
            mask = torch.zeros(1, 1, 1, s + (-s) % 8, device="cuda", dtype=torch.bfloat16)[..., :s]
            mask.copy_(bias[:, None, None, :])
        reps = 5 if s > 4096 else 25
        kernel_ms = time_ms(lambda: flash_attention(q, k, v, bias=bias), reps=reps)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps=reps)
        kernel_q = queued_ms(lambda: flash_attention(q, k, v, bias=bias), calls=reps)
        library_q = queued_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), calls=reps)
        flops = 4.0 * HYV15_HEADS * s * s * 128
        nbytes = 4 * q.numel() * q.element_size() + (s * 4 if bias is not None else 0)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        row = {"phase": "timing", "kernel": "flash_attention", "case": f"hyv15_{name}",
               "shape": list(q.shape), "sk": s, "bias": bias is not None, "ms": kernel_ms,
               "queued_ms": kernel_q, "plain_ms_first_rows": plain_ms,
               "plain_rows": plain_rows.stop - plain_rows.start, "library_ms": library_ms,
               "library_queued_ms": library_q,
               "library_call": "torch.nn.functional.scaled_dot_product_attention",
               "bound_ms": bound_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "of_bound": bound_ms / kernel_ms, "vs_library": kernel_ms / library_ms,
               "queued_of_bound": bound_ms / kernel_q, "flops": flops, "bytes": nbytes,
               "blocks": -(-s // 128) * HYV15_HEADS}
        emit(row)
        rows.append(row)
        del q, k, v, qt, kt, vt, out, bias, mask
        release()
    emit({"phase": "kernels", "path": "hyv15", "cases": cases})
    bad = [c["case"] for c in cases if not c["ok"]]
    check(not bad, f"flash kernel disagrees with its plain version at the HYV15 shapes: {bad}")
    return rows, max(c["max_abs_err"] for c in cases)


def write_byt5_config(home: Path) -> None:
    """byT5-small's published config.json where the manifest's glyph encoder
    names it (components/<config_path>); the other components' family
    defaults are their published configs."""
    import yaml

    doc = yaml.safe_load(HYV15_MANIFEST.read_text())
    spec = next(c for c in doc["spec"]["components"] if c.get("name") == "text_encoder_2")
    path = home / "components" / spec["config_path"]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(BYT5_SMALL))


def phase_hyv15(home: Path):
    """HunyuanVideo 1.5 i2v through ``UniversalEngine`` from its manifest at
    full width and depth, synthetic int8 weights: two identical 33-frame
    requests decoded through the tiled path, one preview through the TAE,
    then one request at 121 frames (latents returned)."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine import UniversalEngine
    from apex_studio_tpu_torch.models.layers import Linear
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    kernel_rows, kernel_err = hyv15_kernel_rows()
    label = "hyv15"
    os.environ["APEX_SYNTHETIC_WEIGHTS"] = "int8"
    os.environ["APEX_HOME_DIR"] = str(home / label)
    write_byt5_config(home / label)
    engine = UniversalEngine(HYV15_MANIFEST, device="cuda")
    tok = make_tokenizer()
    for spec in engine.component_specs.values():
        if spec.get("type") == "text_encoder":
            spec["tokenizer"] = tok
    (height, width), (t_scale, s_scale) = HYV15_SIZE, HYV15_SCALES
    image = np.random.default_rng(0).integers(0, 256, size=(height, width, 3), dtype=np.uint8)

    decoded = []
    decode = engine.decode_latents

    def observed_decode(z):
        decoded.append(z.detach().clone())
        return decode(z)

    engine.decode_latents = observed_decode

    rows, frames_by_request = [], []
    for i, frames_n in enumerate(HYV15_FRAMES):
        stamps, peaks, tally, hooks = {}, {}, {}, []
        last = [None]

        def progress(p, message, *_a, **_k):
            torch.cuda.synchronize()
            now = time.perf_counter()
            stamps.setdefault(message, now)
            if last[0] is not None:  # the peak of the stage that ends here
                peaks[last[0]] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            last[0] = message
            if message == "Components ready" and i == 2:
                def count(mod, args, out):
                    mode = "bf16" if mod.weight_scale is None else f"int{mod.weight_bits}"
                    key = (args[0].numel() // args[0].shape[-1], args[0].shape[-1], out.shape[-1], mode)
                    tally[key] = tally.get(key, 0) + 1
                hooks.extend(m.register_forward_hook(count) for m in engine.transformer.modules()
                             if isinstance(m, Linear))

        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        out = engine.run(prompt=HYV15_PROMPT, negative_prompt="", image=image, height=height, width=width,
                         num_frames=frames_n, num_inference_steps=HYV15_STEPS, guidance_scale=6.0,
                         seed=42, progress_callback=progress, return_latents=i == 2)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = flash_attention.launches
        for h in hooks:
            h.remove()
        steps = [stamps[f"Denoising step {j}/{HYV15_STEPS}"] for j in range(1, HYV15_STEPS + 1)]
        per_step = [b - a for a, b in zip([stamps["Timesteps computed; starting denoise"]] + steps[:-1], steps)]
        grid = [(frames_n - 1) // t_scale + 1, height // s_scale, width // s_scale]
        row = {
            "phase": label, "weights": "int8", "request": i + 1, "frames_requested": frames_n,
            "latent_grid": grid, "tokens": math.prod(grid) + HYV15_CONTEXT_TOKENS,
            "seconds_total": total,
            "seconds_encode_mllm": stamps["Encoded mllm prompts"] - stamps["Starting pipeline"],
            "seconds_load": stamps["Components ready"] - stamps["Encoded mllm prompts"],
            "seconds_conditioning": stamps["Initialized latent noise"] - stamps["Components ready"],
            "seconds_denoise": stamps["Denoising complete"] - stamps["Timesteps computed; starting denoise"],
            "seconds_per_step": per_step,
            "peak_gib_by_stage": peaks, "peak_gib": max(peaks.values()),
            "flash_launches": launches, "flash_launches_expected": HYV15_LAUNCHES_PER_STEP * HYV15_STEPS,
            "card": torch.cuda.get_device_name(0),
        }
        if i == 2:
            check(tuple(out.shape) == (1, engine.transformer.cfg.out_channels, *grid)
                  and bool(torch.isfinite(out).all()),
                  f"hyv15 request {i + 1}: latents {tuple(out.shape)} not finite or misshapen")
            median = statistics.median(per_step[1:]) if len(per_step) > 1 else per_step[0]
            row.update({"median_seconds_per_step_after_the_first": median,
                        "seconds_per_frame_at_50_steps": median * 50 / frames_n,
                        "linear_hooks_on": True,
                        "linear_calls_per_step_by_weights": {
                            mode: sum(c for (_, _, _, m), c in tally.items() if m == mode) / HYV15_STEPS
                            for mode in sorted({k[3] for k in tally})},
                        "linear_calls_per_step": [
                            {"rows": m, "in": k, "out": n, "weights": mode, "calls": c / HYV15_STEPS}
                            for (m, k, n, mode), c in sorted(tally.items(), key=lambda kv: -kv[1])]})
        else:
            row.update({"seconds_decode": stamps["Completed pipeline"] - stamps["Denoising complete"],
                        "frames": len(out), "frame_shape": list(out[0].shape), "frame_dtype": str(out[0].dtype),
                        "latents_finite": bool(torch.isfinite(decoded[-1]).all())})
            check(len(out) == frames_n and all(f.shape == (height, width, 3) and f.dtype == np.uint8 for f in out),
                  f"hyv15 request {i + 1}: {len(out)} frames of {out[0].shape}, expected {frames_n} of "
                  f"{height}x{width}x3")
            check(row["latents_finite"], f"hyv15 request {i + 1}: latents not finite")
            frames_by_request.append(out)
        emit(row)
        check(launches == HYV15_LAUNCHES_PER_STEP * HYV15_STEPS,
              f"hyv15 request {i + 1}: flash launched {launches} times, expected "
              f"{HYV15_LAUNCHES_PER_STEP * HYV15_STEPS}")
        if i == 1:
            same_latents = torch.equal(decoded[0], decoded[1])
            same_frames = all(np.array_equal(a, b) for a, b in zip(*frames_by_request))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preview = engine.preview_frames(decoded[1])
            torch.cuda.synchronize()
            emit({"phase": label, "requests_1_2_identical_latents": same_latents,
                  "requests_1_2_identical_frames": same_frames, "preview_through": type(
                      engine._get_preview_vae()).__name__, "preview_frames": len(preview),
                  "preview_frame_shape": list(preview[0].shape), "seconds_preview": time.perf_counter() - t0})
            check(same_latents and same_frames, "hyv15 requests 1 and 2 (same image, prompt, seed) differ")
            vae_tile_precision(engine.vae, decoded[1][..., :8, :8].contiguous())
            check(type(engine._get_preview_vae()).__name__ == "TAEVAE" and len(preview) == frames_n,
                  f"hyv15 preview: {len(preview)} frames, expected {frames_n}")
            del frames_by_request[:], preview
        rows.append(row)
    del engine, out, decoded
    release()
    linear_rows = residency_timing(list(HYV15_LINEAR_CALLS), phase=label)
    step = rows[2]["median_seconds_per_step_after_the_first"]
    joint = next(r for r in kernel_rows if r["case"] == "hyv15_joint_121f")
    refiner = next(r for r in kernel_rows if r["case"] == "hyv15_refiner")
    attention_s = (2 * 54 * joint["queued_ms"] + 2 * 2 * refiner["queued_ms"]) / 1e3
    linear_s = sum(HYV15_LINEAR_CALLS[(r["rows"], r["in"], r["out"])] * r["w8a8_ms"] for r in linear_rows) / 1e3
    emit({"phase": label, "step_breakdown_121_frames": {
        "seconds_per_step": step, "attention_seconds": attention_s, "w8a8_linear_seconds": linear_s,
        "other_seconds": step - attention_s - linear_s, "attention_share": attention_s / step,
        "w8a8_linear_share": linear_s / step,
        "reckoning": "queued kernel ms x 108 joint + 4 refiner calls; queued W8A8 ms x calls by shape"}})
    return rows, kernel_rows, kernel_err


def vae_tile_precision(vae, z_denoised) -> dict:
    """One 8x8-latent tile of the tiled decode on the card as the engine runs
    it (timed), against the same VAE in float64 (its norms and attention
    upcast to f32 by design). The engine builds the VAE in the manifest's
    component dtype, which both packages resolve to bf16 here (the manifest
    declares fp32 per weight variant): bf16 keeps 8 mantissa bits, so the
    tile is held to 2e-2 relative through its some forty convolutions. Held
    on seeded normal latents; the request's denoised latents are read beside
    them. The tile's convolution FLOP are counted from the shapes the
    convolutions see."""
    import copy

    import torch

    from apex_studio_tpu_torch.models.vaes.hunyuanvideo15_vae import CausalConv3dRep

    g = torch.Generator("cuda").manual_seed(6)
    tiles = {"seeded_normal": torch.randn(z_denoised.shape, generator=g, device="cuda"),
             "denoised": z_denoised}
    flops = [0]

    def count(mod, args, out):
        flops[0] += 2 * out.numel() * mod.weight[0].numel()

    convs = [m for m in vae.modules() if isinstance(m, CausalConv3dRep)]
    row = {"phase": "hyv15", "check": "vae_tile_vs_float64", "tile_latents": list(z_denoised.shape),
           "compute_dtype": str(convs[0].dtype), "parameter_dtype": str(convs[0].weight.dtype), "tol": 2e-2}
    with torch.inference_mode():
        hooks = [m.register_forward_hook(count) for m in convs]
        outs = {name: vae.decode(z) for name, z in tiles.items()}
        for h in hooks:
            h.remove()
        row["conv_flops"] = flops[0] // len(tiles)
        for name, z in tiles.items():
            ms = time_ms(lambda: vae.decode(z), reps=3, warmup=1)
            row[name] = {"tile_ms": ms, "conv_tflops_reckoned": row["conv_flops"] / ms / 1e9}
        vae64 = copy.deepcopy(vae).double()
        for m in vae64.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
        for name, z in tiles.items():
            row[name]["rel_l2_vs_float64"] = rel_l2(outs[name].double(), vae64.decode(z.double()))
    del vae64, outs
    release()
    emit(row)
    check(row["seeded_normal"]["rel_l2_vs_float64"] <= 2e-2,
          f"the VAE's decode is {row['seeded_normal']['rel_l2_vs_float64']} from float64")
    return row


def ptxas_report(log: str) -> dict:
    """What ptxas said in the build log (``-Xptxas -v``): registers and spill
    bytes of each kernel for sm_90a, and every warning, C7508 (``setmaxnreg``
    ignored) among them."""
    import re

    functions, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)' for 'sm_90a'", line)
        if m:
            name = m.group(1)
            functions.append({"name": name, "registers": None, "spill_bytes": 0})
        elif name and "spill stores" in line:
            functions[-1]["spill_bytes"] = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif name and "Used" in line and "registers" in line:
            functions[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    warnings = [ln.strip() for ln in log.splitlines() if "warning" in ln.lower() or "C75" in ln]
    return {"functions": functions, "warnings": warnings,
            "setmaxnreg_ignored": any("C7508" in w for w in warnings)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=DEFAULT_PHASES)
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "apex_studio_tpu_torch" / "csrc" / "flash_attn.cu").is_file():
        print("chip_smoke: FAIL: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    (REPO / "build").mkdir(exist_ok=True)
    home = Path(tempfile.mkdtemp(prefix="smoke_home_", dir=REPO / "build"))
    os.environ["APEX_HOME_DIR"] = str(home)
    wall_start, wall = time.perf_counter(), {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        return out

    try:
        card = card_line()
        from apex_studio_tpu_torch.ops.attention import flash as flash_mod

        t0 = time.perf_counter()
        lib = flash_mod.build()
        build_s = time.perf_counter() - t0
        log = sorted(flash_mod.build_dir().glob("flash_attn_*.log"))
        ptxas = ptxas_report(log[-1].read_text() if log else "")
        emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernel_build_seconds": build_s,
              "smem_bytes_a_block": {d: lib.apex_flash_attn_smem_bytes(d) for d in (64, 128)},
              **ptxas})
        check(bool(ptxas["functions"]), "the build log names no kernel")
        spilled = [f["name"] for f in ptxas["functions"] if f["spill_bytes"]]
        check(not spilled, f"ptxas spilled registers in {spilled}")
        flux_err = timed("kernels", phase_kernels) if "kernels" in phases else None
        timing = timed("timing", phase_timing) if "timing" in phases else None
        if "reference" in phases:
            timed("reference", phase_reference)
        if "residency" in phases:
            timed("residency", phase_residency)
        if "checkpoint" in phases:
            timed("checkpoint", phase_checkpoint, home)
        # The paths through the engine, each request with the launch count set
        # to 0 just before it and read just after.
        paths = {}
        if "main" in phases:
            paths["main_int8_lora"], engine = timed("main", phase_main, home)
            if "trace" in phases:
                timed("trace", phase_trace, engine)
            del engine
            release()
        else:
            check("trace" not in phases, "the trace phase runs after the main phase")
        if "bf16" in phases:
            paths["bf16"] = timed("bf16", drive, "bf16", "bf16", [(PROMPT_A, 0)], STEPS, home)[0]
            release()
        if "int4" in phases:
            paths["int4"] = timed("int4", drive, "int4", "int4", [(PROMPT_A, 0)], 2, home)[0]
            release()
        hyv15_rows, hyv15_err = [], None
        if "hyv15" in phases:
            paths["hyv15"], hyv15_rows, hyv15_err = timed("hyv15", phase_hyv15, home)
        if len(paths) > 1:
            emit({"phase": "steps", "median_seconds_per_step_after_the_first": {
                name: statistics.median(t for r in rows if not r.get("linear_hooks_on")
                                        for t in r["seconds_per_step"][1:])
                for name, rows in paths.items()}})
        by_path = {name: sum(r["flash_launches"] for r in rows) for name, rows in paths.items()}
        per_step = {name: by_path[name] // sum(len(r["seconds_per_step"]) for r in rows)
                    for name, rows in paths.items()}
        launches = sum(by_path.values())
        emit({"phase": "wall", "seconds": time.perf_counter() - wall_start, "limit_seconds": 1200,
              "seconds_by_phase": wall})
        emit({"kernels": [{
            "name": "flash_attention", "route": "cuda",
            "source": "apex_studio_tpu_torch/csrc/flash_attn.cu",
            "replaces": "apex_studio_tpu/ops/attention/pallas_flash.py:218",
            "launches": launches, "launches_by_path": by_path, "launches_per_step_by_path": per_step,
            "max_abs_err": flux_err,
            "ms": timing and timing["ms"], "plain_ms": timing and timing["plain_ms"],
            "bound_ms": timing and timing["bound_ms"], "bound_by": timing and timing["bound_by"],
            "library_ms": timing and timing["library_ms"],
            "max_abs_err_hyv15": hyv15_err,
            "hyv15_rows": [{k: r[k] for k in ("case", "shape", "bias", "ms", "queued_ms", "plain_ms_first_rows",
                                              "plain_rows", "bound_ms", "bound_by", "library_ms")}
                           for r in hyv15_rows],
        }]})
        print(card)
    except CheckFailed as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(home, ignore_errors=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
