"""Filesystem roots and the server's address (port of
``apex_studio_tpu/utils/defaults.py``).

Every path is overridable by environment variable. Departure: the JAX
``home_dir`` also reads a persisted ``home_dir`` from the config store, but
that lookup finds the config file through ``home_dir`` itself, so it recurses
and its ``except`` drops it whenever ``APEX_HOME_DIR`` is unset; the port
reads ``APEX_HOME_DIR``, else ``~/.apex``, which is what the JAX function
returns in either case.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional


def home_dir() -> Path:
    """Root directory for everything the engine persists (``APEX_HOME_DIR``,
    else ``~/.apex``)."""
    env = os.environ.get("APEX_HOME_DIR")
    if env:
        return Path(env).expanduser()
    return Path.home() / ".apex"


def _sub(name: str, env: str) -> Path:
    raw = os.environ.get("APEX_" + env)
    return Path(raw).expanduser() if raw else home_dir() / name


def get_components_path() -> Path:
    return _sub("components", "COMPONENTS_PATH")


def get_lora_path() -> Path:
    return _sub("loras", "LORA_PATH")


def get_cache_path() -> Path:
    return _sub("cache", "CACHE_PATH")


def get_offload_path() -> Path:
    return _sub("offload", "OFFLOAD_PATH")


def get_results_path() -> Path:
    return _sub("results", "RESULTS_PATH")


def get_config_file_path() -> Path:
    raw = os.environ.get("APEX_CONFIG_PATH")
    return Path(raw).expanduser() if raw else home_dir() / "config.json"


def get_preprocessor_models_path() -> Path:
    """Where learned pre- and postprocessors find their checkpoints
    (``APEX_PREPROCESSOR_MODELS_PATH``, else ``<home>/preprocessor_models``)."""
    return _sub("preprocessor_models", "PREPROCESSOR_MODELS_PATH")


def get_manifest_search_paths(extra: Optional[List[Path]] = None) -> List[Path]:
    """Directories scanned for apex/v1 manifest YAMLs, in priority order:
    ``APEX_MANIFEST_PATHS``, the repository's ``manifests/``, the user's
    ``<home>/manifests``, then ``extra``; only those that exist."""
    paths: List[Path] = []
    env = os.environ.get("APEX_MANIFEST_PATHS")
    if env:
        paths.extend(Path(p).expanduser() for p in env.split(os.pathsep) if p)
    paths.append(Path(__file__).resolve().parent.parent.parent / "manifests")
    paths.append(home_dir() / "manifests")
    if extra:
        paths.extend(extra)
    return [p for p in paths if p.is_dir()]


def ensure_dirs() -> None:
    for p in (
        home_dir(),
        get_components_path(),
        get_lora_path(),
        get_cache_path(),
        get_offload_path(),
        get_results_path(),
    ):
        p.mkdir(parents=True, exist_ok=True)


DEFAULT_HOST = os.environ.get("APEX_HOST", "127.0.0.1")
DEFAULT_PORT = int(os.environ.get("APEX_PORT", "8765"))
