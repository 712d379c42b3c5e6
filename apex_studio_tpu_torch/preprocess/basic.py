"""Model-free preprocessors (cv2/numpy implementations) (a copy of
``apex_studio_tpu/preprocess/basic.py``: cv2 and numpy on the host).

Covers the reference detectors that need no network weights: canny, scribble
(HED-style edge sketch approximated with adaptive thresholds), lineart
(inverted edges), blur, grayscale, invert, posterize/color blocks, pixel
(downsample), threshold, tile. Model-backed detectors (depth_anything, dwpose,
segmentation…) register through the same interface as they land.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry


def _cv2():
    import cv2

    return cv2


@preprocessor_registry.register("canny")
class CannyPreprocessor(BasePreprocessor):
    name = "canny"
    params_schema = {"low_threshold": 100, "high_threshold": 200}

    def process_frame(self, frame: Frame, low_threshold: int = 100,
                      high_threshold: int = 200, **_: Any) -> Frame:
        cv2 = _cv2()
        edges = cv2.Canny(frame, int(low_threshold), int(high_threshold))
        return np.repeat(edges[:, :, None], 3, axis=2)


@preprocessor_registry.register("blur")
class BlurPreprocessor(BasePreprocessor):
    name = "blur"
    params_schema = {"kernel_size": 15}

    def process_frame(self, frame: Frame, kernel_size: int = 15, **_: Any) -> Frame:
        cv2 = _cv2()
        k = int(kernel_size) | 1  # odd
        return cv2.GaussianBlur(frame, (k, k), 0)


@preprocessor_registry.register("grayscale")
class GrayscalePreprocessor(BasePreprocessor):
    name = "grayscale"

    def process_frame(self, frame: Frame, **_: Any) -> Frame:
        cv2 = _cv2()
        g = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
        return np.repeat(g[:, :, None], 3, axis=2)


@preprocessor_registry.register("invert")
class InvertPreprocessor(BasePreprocessor):
    name = "invert"

    def process_frame(self, frame: Frame, **_: Any) -> Frame:
        return 255 - frame


@preprocessor_registry.register("lineart")
class LineartPreprocessor(BasePreprocessor):
    """Inverted-edge sketch (white lines on black, ControlNet lineart style)."""

    name = "lineart"
    params_schema = {"detail": 1.0}

    def process_frame(self, frame: Frame, detail: float = 1.0, **_: Any) -> Frame:
        cv2 = _cv2()
        g = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
        g = cv2.GaussianBlur(g, (3, 3), 0)
        edges = cv2.adaptiveThreshold(
            g, 255, cv2.ADAPTIVE_THRESH_MEAN_C, cv2.THRESH_BINARY_INV,
            blockSize=max(3, int(9 * detail)) | 1, C=2,
        )
        return np.repeat(edges[:, :, None], 3, axis=2)


@preprocessor_registry.register("pixel")
class PixelPreprocessor(BasePreprocessor):
    name = "pixel"
    params_schema = {"block_size": 16}

    def process_frame(self, frame: Frame, block_size: int = 16, **_: Any) -> Frame:
        cv2 = _cv2()
        h, w = frame.shape[:2]
        b = max(2, int(block_size))
        small = cv2.resize(frame, (max(1, w // b), max(1, h // b)),
                           interpolation=cv2.INTER_AREA)
        return cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST)


@preprocessor_registry.register("threshold")
class ThresholdPreprocessor(BasePreprocessor):
    name = "threshold"
    params_schema = {"value": 127}

    def process_frame(self, frame: Frame, value: int = 127, **_: Any) -> Frame:
        cv2 = _cv2()
        g = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
        _, out = cv2.threshold(g, int(value), 255, cv2.THRESH_BINARY)
        return np.repeat(out[:, :, None], 3, axis=2)


