"""MiDaS / ZoeDepth / Depth Anything (v1) preprocessors through Hugging Face
``transformers`` depth models (port of ``apex_studio_tpu/preprocess/depth_hf.py``).

The JAX module itself delegates these depth families to ``transformers``'
torch models (DPT, ZoeDepth, Depth Anything), as the reference does
("Modern MiDaS implementation using HuggingFace transformers"); the port
copies that delegation and the depth → normal conversion (Sobel gradients
with a background threshold, midas/transformers.py:198-208). None of these
models reaches the flash kernel: ``transformers`` runs its own attention.

Departures from the JAX module:

- **Device.** The model and its inputs go to the preprocessor's ``device``
  (``None`` is the card, as ``run_preprocessor`` passes it); only the
  prediction comes back to the host. Products run in full f32
  (``configure_float32_matmul``) and cuDNN's deterministic algorithms
  (DPT's reassemble stage upsamples by a transposed convolution), so two
  calls give the same bytes.
- **The processor's class.** The JAX classes take ``AutoImageProcessor``,
  which ``transformers`` 5 refuses to run without torchvision; the port
  reads the class the directory names and takes its PIL variant where one
  exists (``image_processor_class``), 4.x's one class otherwise.
- **Local files only.** The JAX classes call ``from_pretrained`` on a Hub id
  with a ``cache_dir``; here ``from_pretrained`` reads a local directory with
  ``local_files_only=True``: ``model_name`` when it is a directory, else
  ``<preprocessor models>/<name>/``, else ``<preprocessor models>/<Hub id>/``
  (so ``zoe`` and ``zoe_depth_anything`` share ``Intel/zoedepth-nyu-kitti``).
  A missing model raises ``RuntimeError``, as the JAX classes do; nothing is
  fetched.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry

logger = logging.getLogger(__name__)

_MODEL_MAP = {
    "dpt_large": "Intel/dpt-large",
    "dpt_hybrid": "Intel/dpt-hybrid-midas",
    "midas_v21": "Intel/dpt-large",
    "midas_v21_small": "Intel/dpt-large",
}


def local_model_dir(name: str, model_name: str) -> Optional[Path]:
    """The local directory a ``transformers`` delegate loads from:
    ``model_name`` itself when it is a directory, else the preprocessor
    models dir's ``<name>/`` or ``<model_name>/`` (the Hub id as folders)."""
    from apex_studio_tpu_torch.utils.defaults import get_preprocessor_models_path

    root = get_preprocessor_models_path()
    for cand in (Path(model_name), root / name, root / model_name):
        if cand.is_dir():
            return cand
    return None


def image_processor_class(path: Path):
    """The ``transformers`` image processor class a saved model directory
    names (``preprocessor_config.json``'s ``image_processor_type``, or its
    ``feature_extractor_type``), its PIL variant where the installed version
    has one: ``transformers`` 5 splits each processor into a torchvision
    class and a ``…Pil`` one, and ``AutoImageProcessor`` refuses to run
    without torchvision; 4.x has the one class, which ``AutoImageProcessor``
    would pick too."""
    import json

    import transformers

    cfg = json.loads((path / "preprocessor_config.json").read_text())
    name = cfg.get("image_processor_type") or cfg.get("feature_extractor_type", "").replace(
        "FeatureExtractor", "ImageProcessor")
    base = name.removesuffix("Fast").removesuffix("Pil")
    for cand in (base + "Pil", base):
        if hasattr(transformers, cand):
            return getattr(transformers, cand)
    raise RuntimeError(f"{path}: no transformers image processor named {name!r}")


def load_hf_delegate(name: str, model_name: str, model_class, device, processor=None):
    """(processor, model, device) from ``local_model_dir``, read with
    ``local_files_only``: the processor by ``processor(dir)`` (the directory's
    image processor by default, ``image_processor_class``), the model by
    ``model_class.from_pretrained``, f32 in eval mode on ``device`` (``None``
    is the card). A missing directory or a failed load raises
    ``RuntimeError``; nothing is fetched."""
    import torch

    from apex_studio_tpu_torch.device import resolve_device
    from apex_studio_tpu_torch.engine.base import configure_float32_matmul
    from apex_studio_tpu_torch.utils.defaults import get_preprocessor_models_path

    dev = resolve_device(device)
    path = local_model_dir(name, model_name)
    if path is None:
        raise RuntimeError(
            f"{name}: transformers model {model_name!r} not found: place its directory (saved with "
            f"save_pretrained) at {get_preprocessor_models_path() / name} or pass it as model_name "
            f"(nothing is fetched)")
    try:
        proc = (processor or (lambda d: image_processor_class(d).from_pretrained(str(d), local_files_only=True)))(path)
        model = model_class.from_pretrained(str(path), local_files_only=True)
    except Exception as e:
        raise RuntimeError(f"{name}: transformers model at {path} unavailable ({e})") from e
    configure_float32_matmul()
    return proc, model.to(device=dev, dtype=torch.float32).eval().requires_grad_(False), dev


def depth_to_normal(depth: np.ndarray, a: float = 2.0 * np.pi, bg_th: float = 0.1) -> np.ndarray:
    """midas/transformers.py:198-208: Sobel-gradient pseudo-normals with the
    background suppressed; the BGR flip baked into the output, as in the
    reference."""
    import cv2

    depth = depth.astype(np.float32)
    rel = depth - depth.min()
    rel = rel / max(rel.max(), 1e-6)
    gx = cv2.Sobel(depth, cv2.CV_32F, 1, 0, ksize=3)
    gy = cv2.Sobel(depth, cv2.CV_32F, 0, 1, ksize=3)
    gz = np.ones_like(gx) * a
    gx[rel < bg_th] = 0
    gy[rel < bg_th] = 0
    normal = np.stack([gx, gy, gz], axis=2)
    normal /= np.sum(normal ** 2.0, axis=2, keepdims=True) ** 0.5
    return (normal * 127.5 + 127.5).clip(0, 255).astype(np.uint8)[:, :, ::-1]


class _HFDepthBase(BasePreprocessor):
    model_name: str = "Intel/dpt-large"

    def __init__(self, model_name: Optional[str] = None):
        if model_name:
            self.model_name = _MODEL_MAP.get(model_name, model_name)
        self._model = None
        self._processor = None

    def setup(self) -> None:
        if self._model is not None:
            return
        from transformers import AutoModelForDepthEstimation

        self._processor, self._model, self._dev = load_hf_delegate(
            self.name, self.model_name, AutoModelForDepthEstimation, self.device)

    def _predict_depth(self, frame: Frame, detect_resolution: int) -> np.ndarray:
        import cv2
        import torch

        from apex_studio_tpu_torch.device import cudnn_deterministic

        h, w = frame.shape[:2]
        size = int(detect_resolution)
        img = cv2.resize(frame, (size, size), interpolation=cv2.INTER_CUBIC)
        with torch.no_grad(), cudnn_deterministic():
            inputs = self._processor(images=img, return_tensors="pt").to(self._dev)
            depth = self._model(**inputs).predicted_depth
            depth = torch.nn.functional.interpolate(depth.unsqueeze(1), size=(size, size), mode="bicubic",
                                                    align_corners=False)[0, 0].cpu().numpy()
        return cv2.resize(depth, (w, h), interpolation=cv2.INTER_CUBIC)


@preprocessor_registry.register("midas", aliases=("depth_midas", "MidasDetector"))
class MidasPreprocessor(_HFDepthBase):
    """Relative depth (or a normal map) through DPT (the midas family)."""

    name = "midas"
    params_schema = {"a": float(2 * np.pi), "bg_th": 0.1, "depth_and_normal": False, "detect_resolution": 512}

    def process_frame(self, frame: Frame, a: float = 2 * np.pi, bg_th: float = 0.1,
                      depth_and_normal: bool = False, detect_resolution: int = 512, **_) -> Frame:
        depth = self._predict_depth(frame, detect_resolution)
        rel = depth - depth.min()
        rel = rel / max(rel.max(), 1e-6)
        depth_img = (rel * 255.0).clip(0, 255).astype(np.uint8)
        depth_img = np.stack([depth_img] * 3, axis=-1)
        if depth_and_normal:
            return depth_to_normal(depth, a=a, bg_th=bg_th)
        return depth_img


@preprocessor_registry.register("normal_midas", aliases=("midas_normal",))
class MidasNormalPreprocessor(MidasPreprocessor):
    """The midas path's normal map (``depth_and_normal=True``)."""

    name = "normal_midas"

    def process_frame(self, frame: Frame, **params) -> Frame:
        params["depth_and_normal"] = True
        return super().process_frame(frame, **params)


@preprocessor_registry.register("zoe", aliases=("depth_zoe", "ZoeDetector"))
class ZoePreprocessor(_HFDepthBase):
    """Metric depth through ZoeDepth (zoe/transformers.py:17), inverted so
    that near is bright, as the reference renders it."""

    name = "zoe"
    model_name = "Intel/zoedepth-nyu-kitti"
    params_schema = {"detect_resolution": 512, "gamma_corrected": False}

    def process_frame(self, frame: Frame, detect_resolution: int = 512, gamma_corrected: bool = False,
                      **_) -> Frame:
        depth = self._predict_depth(frame, detect_resolution)
        vis = depth.max() - depth
        vis = vis / max(vis.max(), 1e-6)
        if gamma_corrected:
            vis = vis ** 2.2
        img = (vis * 255.0).clip(0, 255).astype(np.uint8)
        return np.stack([img] * 3, axis=-1)


@preprocessor_registry.register("depth_anything", aliases=("DepthAnythingDetector",))
class DepthAnythingV1Preprocessor(MidasPreprocessor):
    """Depth Anything v1 relative depth through ``transformers``
    (depth_anything/transformers.py:22, LiheYoung/depth-anything-large-hf);
    v2 is the port's own module (``depth_anything.py``)."""

    name = "depth_anything"
    model_name = "LiheYoung/depth-anything-large-hf"
    params_schema = {"detect_resolution": 512}

    def process_frame(self, frame: Frame, **params) -> Frame:
        params.pop("depth_and_normal", None)
        return super().process_frame(frame, **params)


@preprocessor_registry.register("zoe_depth_anything", aliases=("ZoeDepthAnythingDetector",))
class ZoeDepthAnythingPreprocessor(ZoePreprocessor):
    """Metric depth under the zoe_depth_anything id: the reference delegates
    it to the same Intel/zoedepth-nyu-kitti checkpoint as ``zoe``
    (zoe/transformers.py:178-183)."""

    name = "zoe_depth_anything"
