"""Second batch of model-free preprocessors (a copy of
``apex_studio_tpu/preprocess/basic2.py``: cv2 and numpy on the host).

Behavioral counterparts of the reference's weight-free detectors:
``src/preprocess/binary`` (Otsu/fixed binarization), ``color`` (64x block
palette), ``shuffle`` (content shuffle via smooth noise-disk remap),
``recolor`` (luminance/intensity gamma recolor), ``lineart_standard``
(gaussian-difference line extraction) and ``pyracanny`` (multi-scale canny
pyramid, Fooocus-style).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry


def _cv2():
    import cv2

    return cv2


def make_noise_disk(h: int, w: int, c: int, f: int,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Smooth [0,1] noise field (reference preprocess/util.py:84)."""
    cv2 = _cv2()
    g = rng if rng is not None else np.random.default_rng()
    noise = g.uniform(0.0, 1.0, size=((h // f) + 2, (w // f) + 2, c))
    noise = cv2.resize(noise, (w + 2 * f, h + 2 * f),
                       interpolation=cv2.INTER_CUBIC)
    noise = noise[f:f + h, f:f + w]
    noise -= noise.min()
    noise /= max(noise.max(), 1e-8)
    return noise[:, :, None] if c == 1 else noise


@preprocessor_registry.register("binary")
class BinaryPreprocessor(BasePreprocessor):
    """Inverse-threshold binarization; threshold 0/255 → Otsu
    (reference preprocess/binary)."""

    name = "binary"
    params_schema = {"bin_threshold": 0}

    def process_frame(self, frame: Frame, bin_threshold: int = 0, **_: Any) -> Frame:
        cv2 = _cv2()
        gray = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
        if bin_threshold in (0, 255):
            _, img = cv2.threshold(gray, 0, 255,
                                   cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)
        else:
            _, img = cv2.threshold(gray, int(bin_threshold), 255,
                                   cv2.THRESH_BINARY_INV)
        return np.repeat((255 - img)[:, :, None], 3, axis=2)


@preprocessor_registry.register("color")
class ColorPalettePreprocessor(BasePreprocessor):
    """64x downsample + nearest upsample color palette (reference
    preprocess/color)."""

    name = "color"

    def process_frame(self, frame: Frame, **_: Any) -> Frame:
        cv2 = _cv2()
        h, w = frame.shape[:2]
        small = cv2.resize(frame, (max(w // 64, 1), max(h // 64, 1)),
                           interpolation=cv2.INTER_CUBIC)
        return cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST)


@preprocessor_registry.register("shuffle", aliases=("content_shuffle",))
class ContentShufflePreprocessor(BasePreprocessor):
    """Spatially remap content along smooth random flow fields (reference
    preprocess/shuffle)."""

    name = "shuffle"
    params_schema = {"f": 256, "seed": -1}

    def process_frame(self, frame: Frame, f: int = 256, seed: int = -1,
                      **_: Any) -> Frame:
        cv2 = _cv2()
        h, w = frame.shape[:2]
        f = max(int(f), 8)
        rng = np.random.default_rng(seed) if seed >= 0 else None
        x = make_noise_disk(h, w, 1, f, rng) * float(w - 1)
        y = make_noise_disk(h, w, 1, f, rng) * float(h - 1)
        flow = np.concatenate([x, y], axis=2).astype(np.float32)
        return cv2.remap(frame, flow, None, cv2.INTER_LINEAR)


@preprocessor_registry.register("recolor")
class RecolorPreprocessor(BasePreprocessor):
    """Gamma-corrected luminance / intensity recolor (reference
    preprocess/recolor)."""

    name = "recolor"
    params_schema = {"mode": "luminance", "gamma_correction": 1.0}

    def process_frame(self, frame: Frame, mode: str = "luminance",
                      gamma_correction: float = 1.0, **_: Any) -> Frame:
        cv2 = _cv2()
        if mode == "intensity":
            chan = cv2.cvtColor(frame, cv2.COLOR_RGB2HSV)[:, :, 2]
        else:
            chan = cv2.cvtColor(frame, cv2.COLOR_RGB2LAB)[:, :, 0]
        out = (chan.astype(np.float32) / 255.0) ** float(gamma_correction)
        out = (out * 255.0).clip(0, 255).astype(np.uint8)
        return np.repeat(out[:, :, None], 3, axis=2)


@preprocessor_registry.register("lineart_standard")
class LineartStandardPreprocessor(BasePreprocessor):
    """Gaussian-difference line extraction (reference
    preprocess/lineart_standard)."""

    name = "lineart_standard"
    params_schema = {"gaussian_sigma": 6.0, "intensity_threshold": 8}

    def process_frame(self, frame: Frame, gaussian_sigma: float = 6.0,
                      intensity_threshold: int = 8, **_: Any) -> Frame:
        cv2 = _cv2()
        x = frame.astype(np.float32)
        g = cv2.GaussianBlur(x, (0, 0), float(gaussian_sigma))
        intensity = np.min(g - x, axis=2).clip(0, 255)
        above = intensity[intensity > intensity_threshold]
        denom = max(16.0, float(np.median(above)) if above.size else 16.0)
        intensity = intensity / denom * 127.0
        out = intensity.clip(0, 255).astype(np.uint8)
        return np.repeat(out[:, :, None], 3, axis=2)


@preprocessor_registry.register("pyracanny")
class PyraCannyPreprocessor(BasePreprocessor):
    """Multi-scale per-channel canny pyramid with percentile normalization
    (reference preprocess/pyracanny)."""

    name = "pyracanny"
    params_schema = {"low_threshold": 64, "high_threshold": 128}

    def process_frame(self, frame: Frame, low_threshold: int = 64,
                      high_threshold: int = 128, **_: Any) -> Frame:
        cv2 = _cv2()
        h, w = frame.shape[:2]
        acc = None
        for k in (0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0):
            hs, ws = max(int(h * k), 8), max(int(w * k), 8)
            small = cv2.resize(frame, (ws, hs), interpolation=cv2.INTER_AREA)
            edge = np.stack(
                [cv2.Canny(small[..., i], int(low_threshold),
                           int(high_threshold)).astype(np.float32) / 255.0
                 for i in range(3)], axis=2)
            if acc is None:
                acc = edge
            else:
                acc = cv2.resize(acc, (edge.shape[1], edge.shape[0]),
                                 interpolation=cv2.INTER_LINEAR)
                acc = acc * 0.75 + edge * 0.25
        gray = acc.max(axis=2)
        v_min, v_max = np.percentile(gray, 4), np.percentile(gray, 96)
        gray = ((gray - v_min) / max(v_max - v_min, 1e-5) * 255.0)
        out = gray.clip(0, 255).astype(np.uint8)
        return np.repeat(out[:, :, None], 3, axis=2)
