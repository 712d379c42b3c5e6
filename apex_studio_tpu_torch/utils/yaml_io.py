"""YAML helpers (counterpart of the reference's ``src/utils/yaml.py``)."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Union

import yaml


def load_yaml(path: Union[str, Path]) -> Dict[str, Any]:
    with open(path, "r") as f:
        doc = yaml.safe_load(f)
    if doc is None:
        return {}
    if not isinstance(doc, dict):
        raise ValueError(f"YAML root of {path} must be a mapping, got {type(doc).__name__}")
    return doc


def dump_yaml(doc: Dict[str, Any], path: Union[str, Path]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)
