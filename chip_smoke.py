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
  main       Flux Dev text-to-image at 1024x1024 through UniversalEngine with
             synthetic bf16 weights: three requests of 4 steps each, with the
             kernels' launch counts read around each request
  trace      (only when asked for) one more request under torch.profiler:
             device time by kernel class and the device's idle share
then a ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line. Run from the root of a
checkout: ``python3 chip_smoke.py`` (``--phases kernels,timing`` for a short run,
``--phases kernels,timing,reference,main,trace`` to add the trace).
"""

from __future__ import annotations

import argparse
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
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# Kernel against its plain version, bf16 on unit-normal inputs. Both limits
# scale with the output: at Flux's shape a typical |out| is about 0.02, so a
# flat limit such as 3e-2 would pass a kernel that dropped a whole key tile.
MAX_ERR_OF_MAX_REF = 2e-2  # max|Δ| ≤ 2e-2·max|ref|, about 2.5 bf16 ulps of the largest output
REL_L2_TOL = 1e-2          # ‖Δ‖₂ ≤ 1e-2·‖ref‖₂
FLUX_SHAPE = dict(b=1, s=4096 + 512, h=24, d=128)
STEPS = 4
BLOCKS = 19 + 38
PROMPT_A = "A cinematic photograph of a lighthouse on a rocky coast at golden hour"
PROMPT_B = "An oil painting of a red fox asleep in fresh snow under pine trees"


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


# -- main path ---------------------------------------------------------------------------


def phase_main():
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine import UniversalEngine
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    os.environ["APEX_SYNTHETIC_WEIGHTS"] = "bf16"
    engine = UniversalEngine(MANIFEST, device="cuda")
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

    requests = [(PROMPT_A, 0), (PROMPT_B, 1), (PROMPT_A, 0)]
    results, frames_out = [], []
    for i, (prompt, seed) in enumerate(requests):
        stamps = {}

        def progress(p, message, *_a, **_k):
            torch.cuda.synchronize()
            stamps.setdefault(message, time.perf_counter())

        latents_finite.clear()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        frames = engine.run(prompt=prompt, height=1024, width=1024, num_inference_steps=STEPS,
                            guidance_scale=3.5, seed=seed, progress_callback=progress)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = flash_attention.launches

        step_t = [stamps[f"Denoising step {j}/{STEPS}"] for j in range(1, STEPS + 1)]
        steps = [b - a for a, b in zip([stamps["Timesteps computed"]] + step_t[:-1], step_t)]
        row = {
            "phase": "main", "request": i + 1, "prompt": prompt[:40], "seed": seed,
            "seconds_total": total,
            "seconds_encode": stamps["Encoded prompts"] - stamps["Encoding prompts"],
            "seconds_load_transformer": stamps["Initialized latent noise"] - stamps["Encoded prompts"],
            "seconds_per_step": steps,
            "seconds_decode": stamps["Completed t2i pipeline"] - stamps["Denoising complete"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "flash_launches": launches, "flash_launches_expected": BLOCKS * STEPS,
            "frames": [list(f.shape) for f in frames], "latents_finite": latents_finite,
            "card": torch.cuda.get_device_name(0),
        }
        emit(row)
        check(len(frames) == 1 and frames[0].shape == (1024, 1024, 3) and frames[0].dtype == np.uint8,
              f"request {i + 1}: bad frames {row['frames']}")
        check(latents_finite == [True], f"request {i + 1}: latents not finite")
        check(launches == BLOCKS * STEPS,
              f"request {i + 1}: flash launched {launches} times, expected {BLOCKS * STEPS}")
        results.append(row)
        frames_out.append(frames[0])
    same = bool(np.array_equal(frames_out[0], frames_out[2]))
    differ = not np.array_equal(frames_out[0], frames_out[1])
    emit({"phase": "main", "requests_1_3_identical": same, "requests_1_2_differ": differ})
    check(same, "requests 1 and 3 (same prompt and seed) differ")
    check(differ, "requests 1 and 2 (other prompt and seed) are identical")
    return results, engine


def kernel_class(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_attention"
    if any(tag in name.lower() for tag in ("gemm", "xmma", "nvjet", "cutlass", "wgmma")):
        return "gemm"
    if name.startswith(("Memcpy", "Memset")):
        return "memcpy_memset"
    return "other"


def phase_trace(engine):
    """One more request (prompt A, seed 0: T5 from the disk cache, latents
    returned, no decode) under torch.profiler: device time by kernel class,
    the top kernels, and the device's idle share between its first and last
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.run(prompt=PROMPT_A, height=1024, width=1024, num_inference_steps=STEPS,
                   guidance_scale=3.5, seed=0, return_latents=True)
        torch.cuda.synchronize()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        emit({"phase": "trace", "result": "not measured: the profiler recorded no device kernel"})
        return
    by_class, by_name = {}, {}
    for name, start, end in spans:
        c = kernel_class(name)
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    emit({"phase": "trace", "window_ms": window / 1e3, "busy_ms": busy / 1e3,
          "idle_share": 1.0 - busy / window,
          "ms_by_class": {c: t / 1e3 for c, t in sorted(by_class.items())},
          "top_kernels": [{"name": n[:90], "calls": c, "ms": t / 1e3} for n, (c, t) in top]})


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
    ap.add_argument("--phases", default="kernels,timing,reference,main")
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
        flux_err = phase_kernels() if "kernels" in phases else None
        timing = phase_timing() if "timing" in phases else None
        if "reference" in phases:
            phase_reference()
        main_rows, engine = phase_main() if "main" in phases else ([], None)
        if "trace" in phases:
            check(engine is not None, "the trace phase runs after the main phase")
            phase_trace(engine)
        launches = sum(r["flash_launches"] for r in main_rows)
        emit({"kernels": [{
            "name": "flash_attention", "route": "cuda",
            "source": "apex_studio_tpu_torch/csrc/flash_attn.cu",
            "replaces": "apex_studio_tpu/ops/attention/pallas_flash.py:218",
            "launches": launches,
            "launches_per_step": launches // (STEPS * len(main_rows)) if main_rows else None,
            "max_abs_err": flux_err,
            "ms": timing and timing["ms"], "plain_ms": timing and timing["plain_ms"],
            "bound_ms": timing and timing["bound_ms"], "bound_by": timing and timing["bound_by"],
            "library_ms": timing and timing["library_ms"],
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
