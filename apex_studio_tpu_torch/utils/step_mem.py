"""step_mem — pause-and-print memory tracing for debugging (port of
``apex_studio_tpu/utils/step_mem.py``, the reference's
``src/utils/step_mem.py`` step_mem:274).

Prints host + CUDA memory and the largest live tensors at a callsite,
optionally resetting the peak counter and pausing for a keypress:
- ``collect_device_mem``: the CUDA caching allocator's statistics per device
  (``torch.cuda.memory_stats``: allocated / peak / reserved bytes, allocation
  count) and the card's total memory (``torch.cuda.mem_get_info``);
- ``collect_live_tensors``: every live ``torch.Tensor`` found by the garbage
  collector, grouped by (shape, dtype, device) so thousands of identical
  block parameters collapse to one line;
- host RSS from psutil.

Usage (same contract as the reference):

    from apex_studio_tpu_torch.utils.step_mem import step_mem
    step_mem("before forward")
    out = fn(x)
    step_mem("after forward", top=5)
"""

from __future__ import annotations

import gc
import inspect
import os
import sys
from collections import defaultdict
from typing import IO, Any, Dict, List, Optional

__all__ = ["step_mem", "collect_device_mem", "collect_live_tensors"]


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "n/a"
    n_f = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n_f) < 1024.0:
            return f"{n_f:,.2f} {unit}"
        n_f /= 1024.0
    return f"{n_f:,.2f} PiB"


def _callsite(skip: int = 2) -> str:
    try:
        frame = inspect.stack()[skip]
        return (f"{os.path.basename(frame.filename)}:{frame.lineno} "
                f"in {frame.function}")
    except Exception:
        return "unknown"


def _collect_host_mem() -> Dict[str, Any]:
    try:
        import psutil

        info = psutil.Process(os.getpid()).memory_info()
        return {"rss": info.rss, "vms": info.vms}
    except Exception:
        try:  # stdlib fallback
            import resource

            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
            return {"rss": rss, "vms": None}
        except Exception:
            return {"rss": None, "vms": None}


def collect_device_mem(device_filter: Optional[str] = None) -> List[Dict[str, Any]]:
    """Per-CUDA-device allocator statistics; [] without a card."""
    import torch

    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        name = f"cuda:{i}"
        if device_filter and device_filter not in name:
            continue
        s = torch.cuda.memory_stats(i)
        out.append({
            "device": name,
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_reserved": s.get("reserved_bytes.all.current"),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
            "num_allocs": s.get("allocation.all.allocated"),
        })
    return out


def collect_live_tensors(top: int = 10,
                         device_filter: Optional[str] = None
                         ) -> List[Dict[str, Any]]:
    """Largest live tensor groups, grouped by (shape, dtype, device). Shapes
    print as tuples, as the JAX package prints array shapes."""
    import torch

    groups: Dict[tuple, Dict[str, Any]] = defaultdict(
        lambda: {"count": 0, "nbytes": 0})
    for obj in gc.get_objects():
        try:
            # type(), not isinstance: the latter reads __class__, which some module proxies warn on
            if not issubclass(type(obj), torch.Tensor) or obj.is_meta:
                continue
            dev = str(obj.device)
            if device_filter and device_filter not in dev:
                continue
            g = groups[(str(tuple(obj.shape)), str(obj.dtype).removeprefix("torch."), dev)]
            g["count"] += 1
            g["nbytes"] += obj.numel() * obj.element_size()
        except Exception:  # noqa: BLE001 — objects the collector holds mid-teardown
            continue
    rows = [
        {"shape": k[0], "dtype": k[1], "device": k[2], **v}
        for k, v in groups.items()
    ]
    rows.sort(key=lambda r: -r["nbytes"])
    return rows[:top]


def step_mem(
    label: str = "",
    *,
    top: int = 10,
    reset_peak: bool = False,
    pause: Optional[bool] = None,
    device_filter: Optional[str] = None,
    file: Optional[IO[str]] = None,
) -> Dict[str, Any]:
    """Print a memory snapshot (host RSS, CUDA allocator, largest live
    tensors). Returns the collected dict so tests/tools can assert on it.

    ``reset_peak=True`` resets CUDA's peak counters after the snapshot.
    ``pause=True`` (or APEX_STEP_MEM_PAUSE=1) waits for Enter, mirroring the
    reference's breakpoint-style usage."""
    out = file or sys.stderr
    site = _callsite()
    host = _collect_host_mem()
    devices = collect_device_mem(device_filter)
    tensors = collect_live_tensors(top=top, device_filter=device_filter)
    snapshot = {"label": label, "callsite": site, "host": host,
                "devices": devices, "arrays": tensors}

    print(f"[step_mem] {label or '-'} @ {site}", file=out)
    print(f"  host rss={_fmt_bytes(host['rss'])}"
          f" vms={_fmt_bytes(host.get('vms'))}", file=out)
    for d in devices:
        print(f"  {d['device']}: in_use={_fmt_bytes(d.get('bytes_in_use'))}"
              f" peak={_fmt_bytes(d.get('peak_bytes_in_use'))}"
              f" limit={_fmt_bytes(d.get('bytes_limit'))}", file=out)
    for r in tensors:
        print(f"    {r['count']:4d}× {r['shape']:<24} {r['dtype']:<10}"
              f" {_fmt_bytes(r['nbytes'])}  {r['device']}", file=out)

    if reset_peak and devices:
        import torch

        torch.cuda.reset_peak_memory_stats()
    if pause or (pause is None and os.environ.get("APEX_STEP_MEM_PAUSE") == "1"):
        try:
            input("  [step_mem] paused — press Enter to continue…")
        except EOFError:
            pass
    return snapshot
