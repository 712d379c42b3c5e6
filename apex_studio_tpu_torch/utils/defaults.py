"""Filesystem roots.

The part of ``apex_studio_tpu/utils/defaults.py`` that this slice uses,
without the persisted JSON config store: every path is overridable by
environment variable.
"""

from __future__ import annotations

import os
from pathlib import Path


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


def get_preprocessor_models_path() -> Path:
    """Where learned pre- and postprocessors find their checkpoints
    (``APEX_PREPROCESSOR_MODELS_PATH``, else ``<home>/preprocessor_models``)."""
    return _sub("preprocessor_models", "PREPROCESSOR_MODELS_PATH")
