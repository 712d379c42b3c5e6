"""The SAM2 predictor (port of ``apex_studio_tpu/mask/predictor.py``):
checkpoint resolution, prompt normalization, video tracking over the memory
bank, and the process-wide predictor the /mask routes use.

Resolution: ``APEX_SAM2_PATH``, else the config key ``mask_model_path``, else
the published checkpoint of the configured ``MASK_MODEL`` type (default
``sam2_base_plus``) under ``<preprocessor_models>/sam2/``. The predictor runs
on ``device`` (``None`` is the card).

Departures from the JAX module (ROADMAP "Departures"):
- Nothing is fetched. With nothing configured and no file under
  ``<preprocessor_models>/sam2/``, masks use GrabCut and ``mask_backend`` says
  so ("no checkpoint on disk; nothing is fetched").
- A configured path that does not exist, and a checkpoint that fails to load,
  raise: the JAX module logs them and falls back to GrabCut.
- The JAX jit cache per point bucket becomes plain calls.

Mirrored as the JAX module serves it: without a ``config.json`` beside the
checkpoint the model is ``SAM2Config()`` (a Hiera-S-like trunk, embed 96, one
head), whatever ``MASK_MODEL`` says; and the predictor always builds
``SAM2ImageModel`` and runs only the ``sam2`` converter, so
``sam2_track_video`` on a served predictor takes the flow-tracking branch
(ROADMAP Queue 3).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger("apex.mask.sam2")

_lock = threading.Lock()
_predictor: Optional["SAM2Predictor"] = None
_checked = False
_status: Dict[str, object] = {"backend": "classical", "model_type": None,
                              "checkpoint": None, "error": None}

# The published checkpoints per model type (their file names; the JAX module
# fetches them from dl.fbaipublicfiles.com / huggingface.co).
MODEL_WEIGHTS = {
    "sam2_tiny": "sam2.1_hiera_tiny.pt",
    "sam2_small": "sam2.1_hiera_small.pt",
    "sam2_base_plus": "sam2.1_hiera_base_plus.pt",
    "sam2_large": "sam2.1_hiera_large.pt",
    "sam3": "sam3.pt",
}
NO_CHECKPOINT = "no checkpoint on disk; nothing is fetched"


def mask_backend_status() -> Dict[str, object]:
    """Which segmentation backend /mask requests use, and why (GET
    /system/memory ``mask_backend``)."""
    with _lock:
        return dict(_status)


def _resolve_checkpoint() -> Optional[Path]:
    """The configured checkpoint (env or config; raises where it does not
    exist), else the configured type's published file under
    ``<preprocessor_models>/sam2/``, else None."""
    path = os.environ.get("APEX_SAM2_PATH")
    if not path:
        from apex_studio_tpu_torch.utils.config_store import get_config_value

        path = get_config_value("mask_model_path")
    if path:
        p = Path(path)
        if not p.exists():
            raise FileNotFoundError(f"configured SAM2 checkpoint missing: {path}")
        return p

    model_type = (os.environ.get("MASK_MODEL") or "sam2_base_plus").lower()
    _status["model_type"] = model_type
    name = MODEL_WEIGHTS.get(model_type)
    if name is None:
        raise ValueError(f"unknown MASK_MODEL {model_type!r} (have {sorted(MODEL_WEIGHTS)})")
    from apex_studio_tpu_torch.utils.defaults import get_preprocessor_models_path

    dest = get_preprocessor_models_path() / "sam2" / name
    if dest.exists():
        return dest
    _status["error"] = f"{dest.name}: {NO_CHECKPOINT}"
    return None


def _load_state_dict(path: Path) -> Optional[Dict[str, Any]]:
    from apex_studio_tpu_torch.loaders.safetensors_io import (
        load_safetensors,
        load_sharded_safetensors,
        load_torch_checkpoint,
    )

    if path.is_dir():
        return load_sharded_safetensors(path) if any(path.glob("*.safetensors")) else None
    if path.suffix == ".safetensors":
        return load_safetensors(path)
    if path.suffix in (".pt", ".pth", ".ckpt"):
        # the published sam2.1_hiera_*.pt checkpoints
        return load_torch_checkpoint(path)
    return None


class SAM2Predictor:
    def __init__(self, model, img_size: int = 1024):
        self.model = model
        self.img_size = img_size

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def from_checkpoint(cls, path: Path, device=None) -> "SAM2Predictor":
        """The model of ``config.json`` beside ``path`` (``SAM2Config()``
        without one) on ``device``, filled from the checkpoint through the
        ``sam2`` converter (strict); random weights where ``path`` is a
        directory without safetensors. f32 products in full f32, as the
        engines set them (``configure_float32_matmul``)."""
        from apex_studio_tpu_torch.device import resolve_device
        from apex_studio_tpu_torch.engine.base import configure_float32_matmul
        from apex_studio_tpu_torch.loaders.converters import convert_keys
        from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict
        from apex_studio_tpu_torch.mask.sam2 import SAM2Config, SAM2ImageModel

        dev = resolve_device(device)
        configure_float32_matmul()
        path = Path(path)
        cfg_file = path / "config.json" if path.is_dir() else path.parent / "config.json"
        cfg = SAM2Config.from_dict(json.loads(cfg_file.read_text())) if cfg_file.exists() else SAM2Config()
        model = SAM2ImageModel(cfg)
        sd = _load_state_dict(path)
        if sd:
            apply_state_dict(model, convert_keys("sam2", sd), strict=True)
        return cls(model.to(dev).eval().requires_grad_(False), img_size=cfg.img_size)

    def _image(self, frame: np.ndarray) -> torch.Tensor:
        import cv2

        side = self.img_size
        resized = cv2.resize(frame, (side, side), interpolation=cv2.INTER_LINEAR)
        return torch.from_numpy(resized.astype(np.float32) / 255.0)[None].to(self.device)

    def _prompt(self, pts, labels):
        return (torch.from_numpy(np.asarray(pts, np.float32))[None].to(self.device),
                torch.from_numpy(np.asarray(labels, np.int32))[None].to(self.device))

    @torch.no_grad()
    def predict(
        self,
        image: np.ndarray,                      # HWC uint8 RGB
        points: Sequence[Dict[str, float]],
        point_labels: Optional[Sequence[int]] = None,
        box: Optional[Dict[str, float]] = None,
    ) -> np.ndarray:
        """→ binary mask HxW uint8 (best of the multimask outputs by IoU)."""
        import cv2

        h, w = image.shape[:2]
        pts, labels = [], []
        for i, p in enumerate(points or []):
            pts.append([p["x"] / w, p["y"] / h])
            labels.append(1 if point_labels is None else int(point_labels[i]))
        if box is not None:
            pts.append([box["x1"] / w, box["y1"] / h])
            labels.append(2)
            pts.append([box["x2"] / w, box["y2"] / h])
            labels.append(3)
        if not pts:
            raise ValueError("SAM2 predict requires points or a box")
        # Padded to a bucket of 4, as the JAX module pads to bound its recompiles.
        bucket = max(4, int(np.ceil(len(pts) / 4) * 4))
        while len(pts) < bucket:
            pts.append([0.0, 0.0])
            labels.append(-1)

        masks, iou, _obj = self.model.predict(self._image(image), *self._prompt(pts, labels))
        masks = masks[0].float().cpu().numpy()  # [M, side/4, side/4]
        iou = iou[0].float().cpu().numpy()
        best = int(np.argmax(iou[1:]) + 1) if masks.shape[0] > 1 else 0
        full = cv2.resize(masks[best], (w, h), interpolation=cv2.INTER_LINEAR)
        return (full > 0).astype(np.uint8)


def get_sam2_predictor(device=None) -> Optional[SAM2Predictor]:
    """The process-wide SAM2 predictor on ``device`` (``None`` is the card),
    or None when no checkpoint is configured or on disk: then the mask API
    uses the classical segmenter and ``mask_backend`` says so. A configured
    checkpoint that is missing or fails to load raises."""
    global _predictor, _checked
    with _lock:
        if _checked:
            return _predictor
        path = _resolve_checkpoint()
        if path is not None:
            _predictor = SAM2Predictor.from_checkpoint(path, device=device)
            _status.update(backend="sam2", checkpoint=str(path), error=None)
            logger.info("SAM2 predictor loaded from %s", path)
        _checked = True
        return _predictor


def reset_sam2_predictor() -> None:
    global _predictor, _checked
    with _lock:
        _predictor = None
        _checked = False
        _status.update(backend="classical", model_type=None, checkpoint=None, error=None)


@torch.no_grad()
def sam2_track_video(
    predictor: SAM2Predictor,
    frames: Sequence[np.ndarray],
    points: Sequence[Dict[str, float]],
    point_labels: Optional[Sequence[int]] = None,
    start_frame: int = 0,
    direction: str = "forward",
    progress_callback=None,
    frame_callback=None,
) -> Dict[int, np.ndarray]:
    """SAM2 memory-bank video tracking: the prompted frame's memory is the
    permanent conditioning entry; each later frame is decoded promptless after
    memory attention over [conditioning + up to 6 most recent memories], and
    its own memory rolls into the bank. An image-only model (no memory
    weights) tracks by optical flow from the prompted frame's mask."""
    import cv2

    from apex_studio_tpu_torch.mask.sam2 import SAM2VideoModel
    from apex_studio_tpu_torch.utils.progress import safe_emit_progress

    model = predictor.model
    if not isinstance(model, SAM2VideoModel):
        from apex_studio_tpu_torch.mask.segment import track_mask

        init = predictor.predict(frames[start_frame], points, point_labels)
        return track_mask(frames, init, start_frame, direction,
                          progress_callback=progress_callback, frame_callback=frame_callback)

    h, w = frames[start_frame].shape[:2]
    pts = [[p["x"] / w, p["y"] / h] for p in points]
    labels = [1 if point_labels is None else int(point_labels[i]) for i in range(len(points))]
    while len(pts) < 4:
        pts.append([0.0, 0.0])
        labels.append(-1)

    # conditioning frame: prompted
    mask0, _, mem0 = model.track_step(predictor._image(frames[start_frame]), [],
                                      *predictor._prompt(pts, labels))

    def to_full(logit):
        m = cv2.resize(logit[0].float().cpu().numpy(), (w, h), interpolation=cv2.INTER_LINEAR)
        return (m > 0).astype(np.uint8)

    results = {start_frame: to_full(mask0)}

    def run(indices):
        recent = []  # rolling memories in insertion order; the conditioning one kept
        for step, idx in enumerate(indices):
            memories = [(mem0, 0)] + [(m, min(age + 1, SAM2VideoModel.NUM_MASKMEM - 1))
                                      for age, m in enumerate(reversed(recent))]
            mask, _, mem = model.track_step(predictor._image(frames[idx]), memories)
            results[idx] = to_full(mask)
            if frame_callback is not None:
                frame_callback(idx, results[idx])
            recent.append(mem)
            if len(recent) > SAM2VideoModel.NUM_MASKMEM - 1:
                recent.pop(0)
            safe_emit_progress(progress_callback, (step + 1) / max(1, len(indices)), f"tracked frame {idx}")

    n = len(frames)
    if direction in ("forward", "both"):
        run(range(start_frame + 1, n))
    if direction in ("backward", "both"):
        run(range(start_frame - 1, -1, -1))
    return results
