"""Disk-backed embedding cache (counterpart of mixins/cache_mixin.py:99).

Text-encoder outputs are cached under the APEX cache dir, keyed by a
canonicalized hash of the encode kwargs (reference :121), so repeat prompts
skip the LM forward entirely. The newest entries this process wrote or read
are also held in host memory (``MEMORY_BYTES`` in all, by file path), so a
repeat prompt reads no file while its file is there: FIBO's two encodes are
620 MB each.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger("apex.cache")

MEMORY_BYTES = 2 << 30
_MEMORY: "OrderedDict[str, Tuple[np.ndarray, ...]]" = OrderedDict()


def _remember(path: Path, arrays: Tuple[np.ndarray, ...]) -> None:
    key = str(path)
    _MEMORY.pop(key, None)
    if sum(a.nbytes for a in arrays) > MEMORY_BYTES:
        return
    _MEMORY[key] = arrays
    while sum(a.nbytes for v in _MEMORY.values() for a in v) > MEMORY_BYTES:
        _MEMORY.popitem(last=False)


def canonical_hash(payload: Dict[str, Any]) -> str:
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:32]


class EmbeddingCache:
    def __init__(self, namespace: str, root: Optional[Path] = None):
        from apex_studio_tpu_torch.utils.defaults import get_cache_path

        self.dir = (root or get_cache_path()) / "embeddings" / namespace
        self.enabled = os.environ.get("APEX_DISABLE_EMBED_CACHE", "0") not in ("1", "true")

    def _path(self, key: str) -> Path:
        return self.dir / f"{key}.npz"

    def load(self, payload: Dict[str, Any]) -> Optional[Tuple[np.ndarray, ...]]:
        if not self.enabled:
            return None
        p = self._path(canonical_hash(payload))
        if not p.exists():
            _MEMORY.pop(str(p), None)
            return None
        held = _MEMORY.get(str(p))
        if held is not None:
            _MEMORY.move_to_end(str(p))
            return tuple(a.copy() for a in held)
        try:
            with np.load(p) as z:
                arrays = tuple(z[k] for k in sorted(z.files))
        except (OSError, ValueError):
            logger.warning("corrupt embedding cache entry %s; ignoring", p)
            return None
        _remember(p, tuple(a.copy() for a in arrays))
        return arrays

    def store(self, payload: Dict[str, Any], *arrays: np.ndarray) -> None:
        if not self.enabled:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        p = self._path(canonical_hash(payload))
        tmp = p.with_suffix(".tmp.npz")
        try:
            np.savez(tmp, **{f"a{i}": np.asarray(a) for i, a in enumerate(arrays)})
            os.replace(tmp, p)
        except OSError:
            logger.exception("failed to write embedding cache %s", p)
            return
        _remember(p, tuple(np.array(a) for a in arrays))
