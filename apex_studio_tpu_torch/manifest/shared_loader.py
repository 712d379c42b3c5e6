"""Shared manifest fragments.

A manifest's ``spec.shared`` lists other manifest files whose components /
preprocessors / postprocessors are merged in (reference:
``src/manifest/shared_loader.py:20``). Components from the including manifest
win on (type, name) collisions so models can override shared defaults.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from apex_studio_tpu_torch.utils.yaml_io import load_yaml

_MERGED_LIST_KEYS = ("components", "preprocessors", "postprocessors")


def load_shared_fragment(path: Union[str, Path]) -> Dict[str, Any]:
    """Load a shared fragment, normalizing v1 docs to top-level lists."""
    doc = load_yaml(path)
    if "api_version" not in doc and "apiVersion" not in doc:
        return doc
    spec = doc.get("spec") or {}
    out: Dict[str, Any] = {"metadata": doc.get("metadata") or {}}
    for key in _MERGED_LIST_KEYS:
        if key in spec:
            out[key] = spec[key]
    return out


def _comp_identity(comp: Dict[str, Any]) -> tuple:
    return (comp.get("type"), comp.get("name") or comp.get("type"))


def _find_fragment(ref: str, base_dir: Optional[Path]) -> Optional[Path]:
    candidates: List[Path] = []
    p = Path(ref)
    if p.is_absolute():
        candidates.append(p)
    if base_dir is not None:
        candidates.append(base_dir / ref)
        candidates.append(base_dir.parent / ref)
        candidates.append(base_dir.parent / "shared" / ref)
    for cand in candidates:
        for suffix in ("", ".yml", ".yaml"):
            fp = Path(str(cand) + suffix)
            if fp.is_file():
                return fp
    return None


def expand_shared(doc: Dict[str, Any], base_dir: Optional[Path] = None) -> Dict[str, Any]:
    """Expand ``spec.shared`` includes in-place and return the document."""
    if not isinstance(doc, dict):
        return doc
    spec = doc.get("spec")
    container = spec if isinstance(spec, dict) else doc
    shared_refs = container.get("shared") or []
    if not shared_refs:
        return doc

    for ref in shared_refs:
        frag_path = _find_fragment(str(ref), base_dir)
        if frag_path is None:
            raise FileNotFoundError(f"shared manifest fragment not found: {ref}")
        frag = load_shared_fragment(frag_path)
        for key in _MERGED_LIST_KEYS:
            frag_items = frag.get(key) or []
            if not frag_items:
                continue
            own = container.setdefault(key, [])
            own_ids = {_comp_identity(c) for c in own if isinstance(c, dict)}
            for item in frag_items:
                if isinstance(item, dict) and _comp_identity(item) in own_ids:
                    continue  # manifest's own definition wins
                own.append(item)
    return doc
