"""Engine warm pool — reuse fully-loaded engines across jobs (port of
``apex_studio_tpu/server/warm_pool.py``).

Counterpart of ``src/utils/warm_pool.py:86`` (EngineWarmPool). Keyed like the
reference (manifest path + selected components + engine kwargs) so a repeat
render skips weight loading entirely. Eviction is LRU by count (HBM pressure
is handled by weight residency, not a VRAM probe); `APEX_DISABLE_WARM_WEIGHTS`
disables pooling like the reference's flag.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple


def make_pool_key(manifest_path: str, selected_components: Dict[str, Any],
                  engine_kwargs: Optional[Dict[str, Any]] = None) -> str:
    return json.dumps(
        {
            "manifest": str(manifest_path),
            "selected": selected_components or {},
            "kwargs": engine_kwargs or {},
        },
        sort_keys=True,
    )


class EngineWarmPool:
    def __init__(self, max_entries: int = 2):
        self.max_entries = max_entries
        self._entries: Dict[str, Tuple[Any, float]] = {}
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return os.environ.get("APEX_DISABLE_WARM_WEIGHTS", "0") not in ("1", "true")

    def acquire(self, key: str, factory: Callable[[], Any]) -> Any:
        if not self.enabled:
            return factory()
        with self._lock:
            entry = self._entries.pop(key, None)
        if entry is not None:
            return entry[0]
        return factory()

    def release(self, key: str, engine: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._entries[key] = (engine, time.time())
            while len(self._entries) > self.max_entries:
                oldest = min(self._entries, key=lambda k: self._entries[k][1])
                self._entries.pop(oldest)

    def discard(self, key: Optional[str] = None) -> None:
        with self._lock:
            if key is None:
                self._entries.clear()
            else:
                self._entries.pop(key, None)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"entries": len(self._entries), "keys": list(self._entries)}


warm_pool = EngineWarmPool()


def free_device_memory() -> None:
    """Drop every pooled engine and hand its memory back to the card.
    Departure: JAX frees a buffer when its last reference goes; PyTorch's
    caching allocator keeps freed blocks for reuse until ``empty_cache``."""
    import gc

    import torch

    warm_pool.discard()
    gc.collect()
    torch.cuda.empty_cache()
