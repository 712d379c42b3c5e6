"""Preprocessor manifest catalog (port of
``apex_studio_tpu/preprocess/manifests.py``).

Counterpart of the reference's ``apps/api/manifest/preprocessor/*.yml`` (45
YAMLs with display metadata + parameter schemas the editor's preprocessor
panel renders). Scans the same manifest search paths as the model catalog,
under the ``preprocessor`` category subdirectory.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml

logger = logging.getLogger("apex.preprocess.manifests")


def load_preprocessor_manifests(extra: Optional[List[Path]] = None) -> Dict[str, Dict[str, Any]]:
    """name → manifest dict, scanned in priority order (first hit wins)."""
    from apex_studio_tpu_torch.utils.defaults import get_manifest_search_paths

    out: Dict[str, Dict[str, Any]] = {}
    for root in get_manifest_search_paths(extra):
        d = root / "preprocessor"
        if not d.is_dir():
            continue
        for path in sorted(d.glob("*.yml")) + sorted(d.glob("*.yaml")):
            try:
                doc = yaml.safe_load(path.read_text())
            except Exception as e:
                logger.warning("bad preprocessor manifest %s: %s", path, e)
                continue
            if not isinstance(doc, dict) or not doc.get("name"):
                continue
            out.setdefault(doc["name"], {**doc, "manifest_path": str(path)})
    return out
