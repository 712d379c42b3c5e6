"""Checkpoint resolution for model-backed preprocessors (port of
``apex_studio_tpu/preprocess/weights.py``).

A detector's checkpoint is looked up in the preprocessor models dir by stem
(``.safetensors``, ``.pth``, ``.pt``, ``.bin``), then under its published
file name (where the JAX module's download puts it, ``Annotators/7_model.pth``
or ``scribble/anime_style/netG_A_latest.pth`` with their folders, or with
the folders left out), and loaded as a flat state dict of CPU tensors:
safetensors natively, torch pickles through ``torch.load(weights_only=True)``,
trainer containers unwrapped as the JAX modules unwrap them (``model``:
NormalBAE's ``scannet.pt``, DSINE's ``dsine.pt`` and GMFlow's files;
``state_dict``: a Lightning checkpoint such as the anime matting net's
``isnetis.ckpt``), and only the tensors kept.

A Lightning checkpoint pickles its trainer's state beside the weights
(``hyper_parameters`` as an ``AttributeDict`` or an ``argparse.Namespace``,
loop and callback state), classes that ``weights_only`` refuses. Such a file
is read again with each refused class replaced by an inert stand-in (an empty
``OrderedDict`` that takes the pickled items and attributes): no code of the
file's runs, and what the stand-ins hold is dropped with the other
non-tensors.

Departure: nothing is fetched. The JAX module downloads a missing checkpoint
from its published Hugging Face repository; here a missing checkpoint raises
``FileNotFoundError`` naming the file and the directory expected.
"""

from __future__ import annotations

import collections
import pickle
from pathlib import Path
from typing import Dict, Optional

import torch

_EXTS = (".safetensors", ".pth", ".pt", ".bin", ".ckpt")


class _Inert:
    """What a class that ``weights_only`` refuses unpickles as: an empty
    ``OrderedDict``, which the restricted unpickler lets take the object's
    items (SETITEMS) and attributes (BUILD)."""

    def __new__(cls, *args, **kwargs):
        return collections.OrderedDict()


def _torch_load(path: Path):
    """``torch.load(weights_only=True)``; a file that pickles other classes
    (a trainer's state) is read again with each of them as ``_Inert``."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        refused = torch.serialization.get_unsafe_globals_in_checkpoint(str(path))
        if not refused:
            raise
    with torch.serialization.safe_globals([(_Inert, name) for name in refused]):
        return torch.load(path, map_location="cpu", weights_only=True)


def _load_any(path: Path) -> Dict[str, torch.Tensor]:
    if path.suffix == ".safetensors":
        from apex_studio_tpu_torch.loaders.safetensors_io import load_safetensors

        return dict(load_safetensors(path))
    sd = _torch_load(path)
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
