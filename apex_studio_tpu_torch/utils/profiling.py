"""Tracing / profiling (port of ``apex_studio_tpu/utils/profiling.py``).

- ``step_trace(name)``: env-gated (APEX_STEP_TRACE=1) per-stage wall-clock +
  host-RSS + device-memory snapshots, logged and accumulated — the reference's
  per-step memory tracer on CUDA's allocator statistics. ``wall_s`` is host
  time around the stage: a stage that ends on a host copy of its result (as
  an engine run does) includes the card's work.
- ``profile_to(dir)``: context manager around ``torch.profiler`` (CPU and
  CUDA activities) that writes a Chrome trace into ``dir``.
- ``device_memory_report()``: one entry per CUDA device, for the records.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger("apex.profiling")

_records: List[Dict[str, Any]] = []


def enabled() -> bool:
    return os.environ.get("APEX_STEP_TRACE", "0") in ("1", "true")


def device_memory_report() -> List[Dict[str, Any]]:
    """``bytes_in_use`` (allocated by tensors), ``peak_bytes_in_use``,
    ``bytes_reserved`` (held by the caching allocator) and ``bytes_limit``
    (the card's total memory) of every CUDA device; [] without one."""
    import torch

    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append(
            {
                "id": i,
                "platform": "gpu",
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "bytes_limit": torch.cuda.mem_get_info(i)[1],
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
                "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
            }
        )
    return out


def _host_rss_bytes() -> Optional[int]:
    try:
        import psutil

        return psutil.Process().memory_info().rss
    except Exception:
        return None


@contextlib.contextmanager
def step_trace(name: str, extra: Optional[Dict[str, Any]] = None):
    """Record wall time + memory around a pipeline stage (no-op unless enabled)."""
    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    rss0 = _host_rss_bytes()
    try:
        yield
    finally:
        rec = {
            "name": name,
            "wall_s": round(time.perf_counter() - t0, 4),
            "rss_before": rss0,
            "rss_after": _host_rss_bytes(),
            "devices": device_memory_report(),
            **(extra or {}),
        }
        _records.append(rec)
        logger.info("step_trace %s: %.3fs", name, rec["wall_s"])


def records() -> List[Dict[str, Any]]:
    return list(_records)


def clear() -> None:
    _records.clear()


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
