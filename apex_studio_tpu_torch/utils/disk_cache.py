"""Disk-backed embedding cache (counterpart of mixins/cache_mixin.py:99).

Text-encoder outputs are cached under the APEX cache dir, keyed by a
canonicalized hash of the encode kwargs (reference :121), so repeat prompts
skip the LM forward entirely.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger("apex.cache")


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
            return None
        try:
            with np.load(p) as z:
                return tuple(z[k] for k in sorted(z.files))
        except (OSError, ValueError):
            logger.warning("corrupt embedding cache entry %s; ignoring", p)
            return None

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
