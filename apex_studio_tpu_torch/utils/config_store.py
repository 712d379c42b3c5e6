"""Cross-process, file-locked, atomic JSON config store (port of
``apex_studio_tpu/utils/config_store.py``).

Writes go to a temp file and are atomically renamed under an exclusive file
lock so multiple server/worker processes never observe torn JSON.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, Optional

from filelock import FileLock

_local_lock = threading.Lock()


def _config_path() -> Path:
    from apex_studio_tpu_torch.utils.defaults import get_config_file_path

    return get_config_file_path()


def _lock_for(path: Path) -> FileLock:
    return FileLock(str(path) + ".lock")


def _load(path: Path) -> Dict[str, Any]:
    try:
        return json.loads(path.read_text()) if path.exists() else {}
    except (json.JSONDecodeError, OSError):
        return {}


def _replace(path: Path, config: Dict[str, Any]) -> None:
    """Write ``config`` to a temp file beside ``path`` and rename it over it."""
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(config, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def read_config(path: Optional[Path] = None) -> Dict[str, Any]:
    path = path or _config_path()
    if not path.exists():
        return {}
    with _local_lock, _lock_for(path):
        return _load(path)


def write_config(config: Dict[str, Any], path: Optional[Path] = None) -> None:
    path = path or _config_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    with _local_lock, _lock_for(path):
        _replace(path, config)


def get_config_value(key: str, default: Any = None, path: Optional[Path] = None) -> Any:
    return read_config(path).get(key, default)


def set_config_value(key: str, value: Any, path: Optional[Path] = None) -> None:
    path = path or _config_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    with _local_lock, _lock_for(path):
        cfg = _load(path)
        cfg[key] = value
        _replace(path, cfg)


def delete_config_value(key: str, path: Optional[Path] = None) -> None:
    path = path or _config_path()
    if not path.exists():
        return
    with _local_lock, _lock_for(path):
        cfg = _load(path)
        if key in cfg:
            del cfg[key]
            _replace(path, cfg)
