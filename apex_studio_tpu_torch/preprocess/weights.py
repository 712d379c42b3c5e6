"""Checkpoint resolution for model-backed preprocessors (port of
``apex_studio_tpu/preprocess/weights.py``).

A detector's checkpoint is looked up in the preprocessor models dir by stem
(``.safetensors``, ``.pth``, ``.pt``, ``.bin``) and loaded as a flat state
dict of CPU tensors: safetensors natively, torch pickles through
``torch.load(weights_only=True)``, trainer containers unwrapped as the JAX
module unwraps them.

Departure: nothing is fetched. The JAX module downloads a missing checkpoint
from its published Hugging Face repository; here a missing checkpoint raises
``FileNotFoundError`` naming the file and the directory expected.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import torch

_EXTS = (".safetensors", ".pth", ".pt", ".bin")


def _load_any(path: Path) -> Dict[str, torch.Tensor]:
    if path.suffix == ".safetensors":
        from apex_studio_tpu_torch.loaders.safetensors_io import load_safetensors

        return dict(load_safetensors(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    # unwrap trainer containers: metric3d uses model_state_dict, leres'
    # res101.pth nests under depth_model, generic trainers use state_dict
    for container in ("state_dict", "model_state_dict", "depth_model"):
        if isinstance(sd, dict) and container in sd and isinstance(sd[container], dict):
            sd = sd[container]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def find_local(stem: str, root: Optional[Path] = None) -> Optional[Path]:
    from apex_studio_tpu_torch.utils.defaults import get_preprocessor_models_path

    root = root or get_preprocessor_models_path()
    for ext in _EXTS:
        p = root / f"{stem}{ext}"
        if p.exists():
            return p
    return None


def load_preprocessor_weights(stem: str, filename: Optional[str] = None,
                              root: Optional[Path] = None) -> Dict[str, torch.Tensor]:
    """The detector's checkpoint ``<stem>.*`` under ``root`` (the preprocessor
    models dir by default) as a flat state dict. Raises ``FileNotFoundError``
    naming ``filename`` (the published file name) and the directory when it
    is not there."""
    from apex_studio_tpu_torch.utils.defaults import get_preprocessor_models_path

    root = root or get_preprocessor_models_path()
    local = find_local(stem, root)
    if local is None:
        raise FileNotFoundError(
            f"no checkpoint '{stem}.*' under {root}: place the published "
            f"{filename or stem + '.safetensors'} there (nothing is fetched)")
    return _load_any(local)
