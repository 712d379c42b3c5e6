"""Manifest catalog: scan manifest directories, index by id/slug/reference.

Port of ``apex_studio_tpu/manifest/resolver.py``: counterpart of
``src/manifest/resolver.py:149`` (resolve_manifest_reference)
and the catalog side of ``src/api/manifest.py``. References resolve in the
following priority:

  1. an existing YAML file path
  2. ``metadata.id`` exact match
  3. docker-style ``engine/model_type/slug:version`` (and shorter forms),
     ``:latest`` implied when no version is given
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml

_SEMVER_PREFIX = re.compile(r"^(\d+)\.(\d+)\.(\d+)")


def slugify(text: str) -> str:
    out = re.sub(r"[^a-z0-9]+", "-", text.strip().lower())
    return re.sub(r"-+", "-", out).strip("-")


def _semver(s: Optional[str]) -> tuple:
    if not s:
        return (0, 0, 0)
    m = _SEMVER_PREFIX.match(str(s))
    return (int(m.group(1)), int(m.group(2)), int(m.group(3))) if m else (0, 0, 0)


@dataclass
class ManifestInfo:
    path: Path
    manifest_id: str
    name: str
    slug: str
    engine: str
    model_type: str
    version: tuple
    category: str  # subdirectory (image / video / upscalers / preprocessor / ...)
    metadata: Dict[str, Any] = field(default_factory=dict)

    def summary(self) -> Dict[str, Any]:
        return {
            "id": self.manifest_id,
            "name": self.name,
            "engine": self.engine,
            "model_type": self.model_type,
            "version": ".".join(map(str, self.version)),
            "category": self.category,
            "path": str(self.path),
            "full_path": str(self.path),
            "metadata": self.metadata,
        }


def _scan_one(path: Path, root: Path) -> Optional[ManifestInfo]:
    try:
        doc = yaml.safe_load(path.read_text()) or {}
    except Exception:
        return None
    if not isinstance(doc, dict):
        return None

    if "api_version" in doc or "apiVersion" in doc:
        md = doc.get("metadata") or {}
        spec = doc.get("spec") or {}
        name = md.get("name") or path.stem
        engine = spec.get("engine") or ""
        mt = spec.get("model_type") or spec.get("modelType") or ""
        if isinstance(mt, list):
            mt = mt[0] if mt else ""
        version = _semver(md.get("version"))
        manifest_id = md.get("id") or slugify(name)
    else:
        name = doc.get("name") or path.stem
        engine = doc.get("engine") or ""
        mt = doc.get("type") or ""
        if isinstance(mt, list):
            mt = mt[0] if mt else ""
        m = _SEMVER_PREFIX.search(path.stem)
        version = (int(m.group(1)), int(m.group(2)), int(m.group(3))) if m else (0, 0, 0)
        manifest_id = slugify(name)
        md = {"name": name, "id": manifest_id}

    try:
        category = path.relative_to(root).parts[0]
    except ValueError:
        category = ""
    if category == path.name:
        category = ""

    return ManifestInfo(
        path=path.resolve(),
        manifest_id=manifest_id,
        name=name,
        slug=slugify(name),
        engine=engine,
        model_type=mt,
        version=version,
        category=category,
        metadata=md,
    )


class ManifestResolver:
    """Index of every manifest under the configured search paths."""

    def __init__(self, search_paths: Optional[List[Path]] = None):
        self._explicit_paths = search_paths
        self._lock = threading.Lock()
        self._infos: Optional[List[ManifestInfo]] = None
        self._index: Dict[str, ManifestInfo] = {}

    # -- index construction ---------------------------------------------------

    def _search_paths(self) -> List[Path]:
        if self._explicit_paths is not None:
            return [p for p in self._explicit_paths if p.is_dir()]
        from apex_studio_tpu_torch.utils.defaults import get_manifest_search_paths

        return get_manifest_search_paths()

    def refresh(self) -> None:
        with self._lock:
            self._infos = None
            self._index = {}

    def _ensure_index(self) -> List[ManifestInfo]:
        with self._lock:
            if self._infos is not None:
                return self._infos
            infos: List[ManifestInfo] = []
            for root in self._search_paths():
                for path in sorted(root.rglob("*.yml")) + sorted(root.rglob("*.yaml")):
                    if not path.is_file():
                        continue
                    info = _scan_one(path, root)
                    if info:
                        infos.append(info)
            index: Dict[str, ManifestInfo] = {}
            best: Dict[str, ManifestInfo] = {}

            def offer(key: str, info: ManifestInfo) -> None:
                prev = best.get(key)
                if prev is None or info.version > prev.version:
                    best[key] = info

            for info in infos:
                ver = ".".join(map(str, info.version))
                keys = [info.manifest_id, info.slug]
                if info.engine:
                    keys.append(f"{info.engine}/{info.slug}")
                    if info.model_type:
                        keys.append(f"{info.engine}/{info.model_type}/{info.slug}")
                for k in keys:
                    index.setdefault(f"{k}:{ver}", info)
                    offer(k, info)
            for k, info in best.items():
                index[f"{k}:latest"] = info
                index.setdefault(k, info)
            # metadata.aliases: alternate ids (e.g. the reference catalog's
            # spelling of the same model) resolve to this manifest, but never
            # shadow a real manifest_id.
            for info in infos:
                aliases = info.metadata.get("aliases") or []
                if isinstance(aliases, str):
                    aliases = [aliases]
                for a in aliases:
                    index.setdefault(str(a), info)
                    index.setdefault(f"{a}:latest", info)
            self._infos = infos
            self._index = index
            return infos

    # -- public API -------------------------------------------------------------

    def list(self, category: Optional[str] = None) -> List[ManifestInfo]:
        infos = self._ensure_index()
        if category:
            infos = [i for i in infos if i.category == category]
        return infos

    def get(self, manifest_id: str) -> Optional[ManifestInfo]:
        self._ensure_index()
        info = self._index.get(manifest_id) or self._index.get(manifest_id.lower())
        if info is None and ":" not in manifest_id:
            info = self._index.get(manifest_id + ":latest")
        return info

    def resolve(self, ref: str) -> Optional[str]:
        """Resolve a manifest reference to an absolute file path (or None)."""
        p = Path(ref)
        if p.suffix in (".yml", ".yaml") and p.exists():
            return str(p.resolve())
        info = self.get(ref)
        return str(info.path) if info else None


_default_resolver: Optional[ManifestResolver] = None
_default_lock = threading.Lock()


def default_resolver() -> ManifestResolver:
    global _default_resolver
    with _default_lock:
        if _default_resolver is None:
            _default_resolver = ManifestResolver()
        return _default_resolver


def resolve_manifest_reference(ref: str) -> Optional[str]:
    return default_resolver().resolve(ref)
