"""Semantic segmentation (ADE20K colour maps) and the dependency-gated
preprocessors (port of ``apex_studio_tpu/preprocess/segmentation.py``).

``segmentation`` (``seg``, ``uniformer``) and ``oneformer`` delegate to
``transformers``' SegFormer and OneFormer models, as the JAX module does; the
ADE20K palette is copied. ``mediapipe_face``, ``diffusion_edge`` and
``mesh_graphormer`` raise at setup without their optional packages
(mediapipe; pywt and fvcore; trimesh), as the JAX ones do. DensePose, which
the JAX module also holds, is the port's ``densepose.py``: it is imported
here, between ``oneformer`` and ``diffusion_edge``, so that the registry
lists the names in the JAX module's order.

Departures, as in ``depth_hf.py`` (whose ``load_hf_delegate`` loads these):
the model and its inputs run on the preprocessor's ``device`` (``None`` is
the card) in full f32, OneFormer's image processor is the class the
directory names (its PIL variant under ``transformers`` 5) with the
directory's tokenizer beside it, SegFormer's image processing is
``SegformerInputs`` (``transformers`` 5 cannot build its processor without
torchvision), and ``from_pretrained`` reads a
local directory only (``local_files_only``); a missing model raises
``RuntimeError`` and nothing is fetched.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_hf import image_processor_class, load_hf_delegate

logger = logging.getLogger(__name__)


def ade20k_palette() -> np.ndarray:
    """A deterministic 150-class palette of well-separated colours (the JAX
    module's: ``default_rng(42)``)."""
    rng = np.random.default_rng(42)
    return rng.integers(0, 255, size=(150, 3), dtype=np.int64).astype(np.uint8)


class SegformerInputs:
    """SegFormer's image processing (resize, rescale, normalize, channels
    first) by the saved ``preprocessor_config.json``'s settings, through
    ``transformers.image_transforms``' functions, the steps of 4.x's
    ``SegformerImageProcessor``: ``transformers`` 5 declares both of its
    SegFormer processors (the PIL one too) to need torchvision, so neither
    can be built without it."""

    def __init__(self, path):
        import json

        self.cfg = json.loads((Path(path) / "preprocessor_config.json").read_text())

    def __call__(self, images, return_tensors="pt"):
        from transformers import BatchFeature
        from transformers.image_transforms import normalize, rescale, resize, to_channel_dimension_format
        from transformers.image_utils import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, ChannelDimension, PILImageResampling

        cfg, last = self.cfg, ChannelDimension.LAST
        image = np.asarray(images)
        if cfg.get("do_resize", True):
            size = cfg.get("size") or {"height": 512, "width": 512}
            image = resize(image, (size["height"], size["width"]), resample=PILImageResampling(cfg.get("resample", 2)),
                           input_data_format=last)
        if cfg.get("do_rescale", True):
            image = rescale(image, cfg.get("rescale_factor", 1 / 255), input_data_format=last)
        if cfg.get("do_normalize", True):
            image = normalize(image, cfg.get("image_mean", IMAGENET_DEFAULT_MEAN),
                              cfg.get("image_std", IMAGENET_DEFAULT_STD), input_data_format=last)
        image = to_channel_dimension_format(image, ChannelDimension.FIRST, input_channel_dim=last)
        return BatchFeature(data={"pixel_values": image[None]}, tensor_type=return_tensors)


@preprocessor_registry.register("segmentation", aliases=("seg", "uniformer", "seg_ufade20k"))
class SegmentationPreprocessor(BasePreprocessor):
    """ADE20K semantic segmentation colour map (SegFormer)."""

    name = "segmentation"
    model_name = "nvidia/segformer-b4-finetuned-ade-512-512"
    params_schema = {"detect_resolution": 512}

    def __init__(self, model_name: Optional[str] = None):
        if model_name:
            self.model_name = model_name
        self._model = None
        self._processor = None
        self._palette = ade20k_palette()

    def setup(self) -> None:
        if self._model is not None:
            return
        from transformers import AutoModelForSemanticSegmentation

        self._processor, self._model, self._dev = load_hf_delegate(
            self.name, self.model_name, AutoModelForSemanticSegmentation, self.device, SegformerInputs)

    def process_frame(self, frame: Frame, detect_resolution: int = 512, **_) -> Frame:
        import cv2
        import torch

        h, w = frame.shape[:2]
        size = int(detect_resolution)
        img = cv2.resize(frame, (size, size), interpolation=cv2.INTER_CUBIC)
        with torch.no_grad():
            inputs = self._processor(images=img, return_tensors="pt").to(self._dev)
            logits = self._model(**inputs).logits
            logits = torch.nn.functional.interpolate(logits, size=(size, size), mode="bilinear",
                                                     align_corners=False)
            labels = logits.argmax(dim=1)[0].cpu().numpy()
        seg = self._palette[labels % len(self._palette)]
        return cv2.resize(seg, (w, h), interpolation=cv2.INTER_NEAREST)


class _GatedPreprocessor(BasePreprocessor):
    required: str = ""
    hint: str = ""

    def setup(self) -> None:
        raise RuntimeError(
            f"{self.name}: requires the optional '{self.required}' package "
            f"(not bundled, same gating as the reference). {self.hint}")

    def process_frame(self, frame: Frame, **_) -> Frame:  # pragma: no cover
        raise NotImplementedError


@preprocessor_registry.register("mediapipe_face", aliases=("MediapipeFaceDetector",))
class MediapipeFacePreprocessor(_GatedPreprocessor):
    """Gated on mediapipe (reference mediapipe_face/)."""

    name = "mediapipe_face"
    required = "mediapipe"
    hint = "Use 'dwpose' (face keypoints included) as the available face map."

    def setup(self) -> None:
        try:
            import mediapipe  # noqa: F401
        except ImportError:
            super().setup()


@preprocessor_registry.register("oneformer", aliases=("OneformerSegmentor",))
class OneFormerPreprocessor(BasePreprocessor):
    """OneFormer universal segmentation's semantic task, drawn as an ADE20K
    colour map (oneformer/transformers.py:20)."""

    name = "oneformer"
    model_name = "shi-labs/oneformer_ade20k_swin_tiny"
    params_schema = {"detect_resolution": 512}

    def __init__(self, model_name: Optional[str] = None):
        if model_name:
            self.model_name = model_name
        self._model = None
        self._processor = None
        self._palette = ade20k_palette()

    def setup(self) -> None:
        if self._model is not None:
            return
        from transformers import AutoTokenizer, OneFormerForUniversalSegmentation, OneFormerProcessor

        def processor(path):  # OneFormerProcessor's parts, its image processor as depth_hf picks one
            return OneFormerProcessor(
                image_processor=image_processor_class(path).from_pretrained(str(path), local_files_only=True),
                tokenizer=AutoTokenizer.from_pretrained(str(path), local_files_only=True))

        self._processor, self._model, self._dev = load_hf_delegate(
            self.name, self.model_name, OneFormerForUniversalSegmentation, self.device, processor)

    def process_frame(self, frame: Frame, detect_resolution: int = 512, **_) -> Frame:
        import cv2
        import torch

        h, w = frame.shape[:2]
        size = int(detect_resolution)
        img = cv2.resize(frame, (size, size), interpolation=cv2.INTER_CUBIC)
        with torch.no_grad():
            inputs = self._processor(images=img, task_inputs=["semantic"], return_tensors="pt").to(self._dev)
            outputs = self._model(**inputs)
            labels = self._processor.post_process_semantic_segmentation(
                outputs, target_sizes=[(size, size)])[0].cpu().numpy()
        seg = self._palette[labels % len(self._palette)]
        return cv2.resize(seg, (w, h), interpolation=cv2.INTER_NEAREST)


from apex_studio_tpu_torch.preprocess import densepose  # noqa: E402,F401  (registers "densepose" here, as JAX)


@preprocessor_registry.register("diffusion_edge", aliases=("DiffusionEdgeDetector",))
class DiffusionEdgePreprocessor(_GatedPreprocessor):
    """Gated on pywt + fvcore (the reference's diffusion_edge chain imports
    fvcore's CfgNode and pywt's wavelets)."""

    name = "diffusion_edge"
    required = "pywt"
    hint = "Use 'teed', 'hed' or 'pidinet' for learned edge maps."

    def setup(self) -> None:
        try:
            import fvcore  # noqa: F401
            import pywt  # noqa: F401
        except ImportError:
            super().setup()


@preprocessor_registry.register("mesh_graphormer", aliases=("MeshGraphormerDetector",))
class MeshGraphormerPreprocessor(_GatedPreprocessor):
    """Gated on trimesh and the Graphormer hand-mesh stack (reference
    mesh_graphormer/)."""

    name = "mesh_graphormer"
    required = "trimesh"
    hint = "Use 'dwpose' (hand keypoints included) for hand conditioning."

    def setup(self) -> None:
        try:
            import trimesh  # noqa: F401
        except ImportError:
            super().setup()
