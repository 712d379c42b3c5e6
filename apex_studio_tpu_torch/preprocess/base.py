"""Preprocessor framework (port of ``apex_studio_tpu/preprocess/base.py``).

Counterpart of the reference's ``src/preprocess/base_preprocessor.py`` +
``processor.py`` (45 vendored ControlNet-style detectors behind YAML
manifests). Same contract: a preprocessor takes an image / list of frames
(HWC uint8 RGB) plus params and returns processed frames; video inputs map
over frames. Model-backed detectors (depth, pose, segmentation) plug in via
the same registry with lazy weight loading.

Departure: ``run_preprocessor`` and a preprocessor's call take a ``device``
(``None`` is the card), where a model-backed detector builds its model; the
weight-free ones run on the host and ignore it. A name the registry lacks
raises its ``KeyError``, as the JAX registry does.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from apex_studio_tpu_torch.registry import Registry
from apex_studio_tpu_torch.utils.progress import ProgressCallback, safe_emit_progress

logger = logging.getLogger("apex.preprocess")

preprocessor_registry = Registry("preprocessor")

Frame = np.ndarray  # HWC uint8 RGB


class BasePreprocessor:
    """Subclass and implement ``process_frame``; register with the decorator."""

    name: str = ""
    params_schema: Dict[str, Any] = {}
    device: Any = None

    def setup(self) -> None:
        """Lazy one-time initialization (weight loading for model detectors)."""

    def process_frame(self, frame: Frame, **params: Any) -> Frame:
        raise NotImplementedError

    def __call__(
        self,
        frames: Union[Frame, Sequence[Frame]],
        progress_callback: Optional[ProgressCallback] = None,
        device: Any = None,
        **params: Any,
    ) -> List[Frame]:
        single = isinstance(frames, np.ndarray) and frames.ndim == 3
        batch = [frames] if single else list(frames)
        self.device = device
        self.setup()
        out: List[Frame] = []
        for i, frame in enumerate(batch):
            out.append(self.process_frame(frame, **params))
            safe_emit_progress(
                progress_callback, (i + 1) / len(batch), f"frame {i + 1}/{len(batch)}"
            )
        return out


def run_preprocessor(
    name: str,
    frames: Union[Frame, Sequence[Frame]],
    params: Optional[Dict[str, Any]] = None,
    progress_callback: Optional[ProgressCallback] = None,
    device: Any = None,
) -> List[Frame]:
    """Run the registered preprocessor ``name`` over ``frames``; a
    model-backed one on ``device`` (``None`` is the card)."""
    proc_cls = preprocessor_registry.get(name)
    proc = proc_cls() if isinstance(proc_cls, type) else proc_cls
    return proc(frames, progress_callback=progress_callback, device=device, **(params or {}))


def load_frames(path: Union[str, Path], max_frames: Optional[int] = None) -> List[Frame]:
    """Load an image or video file into HWC uint8 RGB frames."""
    path = Path(path)
    if path.suffix.lower() in (".png", ".jpg", ".jpeg", ".webp", ".bmp"):
        from PIL import Image

        return [np.asarray(Image.open(path).convert("RGB"))]
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames: List[Frame] = []
    while True:
        ok, bgr = cap.read()
        if not ok or (max_frames is not None and len(frames) >= max_frames):
            break
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return frames
