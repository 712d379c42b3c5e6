"""Checkpoint resolution for model-backed preprocessors (port of
``apex_studio_tpu/preprocess/weights.py``).

A detector's checkpoint is looked up in the preprocessor models dir by stem
(``.safetensors``, ``.pth``, ``.pt``, ``.bin``), then under its published
file name (where the JAX module's download puts it, ``Annotators/7_model.pth``
or ``scribble/anime_style/netG_A_latest.pth`` with their folders, or with
the folders left out), and loaded as a flat state dict of CPU tensors:
safetensors natively, torch pickles through ``torch.load(weights_only=True)``,
trainer containers unwrapped as the JAX modules unwrap them (``model``:
NormalBAE's ``scannet.pt`` and DSINE's ``dsine.pt``).

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
    for container in ("state_dict", "model_state_dict", "depth_model", "model"):
        if isinstance(sd, dict) and container in sd and isinstance(sd[container], dict):
            sd = sd[container]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def find_local(stem: str, root: Optional[Path] = None, filename: Optional[str] = None) -> Optional[Path]:
    """``<stem>.<ext>`` under ``root``, else the published ``filename`` there,
    as published (folders included) or by its base name."""
    from apex_studio_tpu_torch.utils.defaults import get_preprocessor_models_path

    root = root or get_preprocessor_models_path()
    candidates = [root / f"{stem}{ext}" for ext in _EXTS]
    if filename:
        candidates += [root / filename, root / Path(filename).name]
    return next((p for p in candidates if p.is_file()), None)


def load_preprocessor_weights(stem: str, filename: Optional[str] = None,
                              root: Optional[Path] = None) -> Dict[str, torch.Tensor]:
    """The detector's checkpoint ``<stem>.*`` under ``root`` (the preprocessor
    models dir by default) as a flat state dict. Raises ``FileNotFoundError``
    naming ``filename`` (the published file name) and the directory when it
    is not there."""
    from apex_studio_tpu_torch.utils.defaults import get_preprocessor_models_path

    root = root or get_preprocessor_models_path()
    local = find_local(stem, root, filename)
    if local is None:
        raise FileNotFoundError(
            f"no checkpoint '{stem}.*' under {root}: place the published "
            f"{filename or stem + '.safetensors'} there (nothing is fetched)")
    return _load_any(local)


def load_detector(build, stem: str, filename: str, convert, device=None):
    """A detector's network on ``device`` (``None`` is the card), f32 with
    products in full f32: ``build()`` on the ``meta`` device, then filled
    strictly from ``convert`` of its checkpoint (``load_preprocessor_weights``:
    a missing file raises, nothing is fetched)."""
    from apex_studio_tpu_torch.device import resolve_device
    from apex_studio_tpu_torch.engine.base import configure_float32_matmul
    from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict

    configure_float32_matmul()
    sd = load_preprocessor_weights(stem, filename=filename)
    dev = resolve_device(device)
    with torch.device("meta"):
        model = build()
    apply_state_dict(model, convert(sd), device=dev, strict=True)
    return model.eval().requires_grad_(False)
