"""Third batch of model-free preprocessors (a copy of
``apex_studio_tpu/preprocess/basic3.py``: cv2 and numpy on the host).

Behavioral counterparts of the reference's weight-free detectors:
``src/preprocess/scribble`` (min-channel threshold scribble + XDoG),
``src/preprocess/tile`` (pyramid blur tile, TTPlanet guided-filter tile and
simple resample tile).  The fast guided filter follows the standard
He et al. color-guidance formulation (reference
src/preprocess/tile/guided_filter.py behavior) re-derived in vectorized
numpy rather than per-channel OpenCV loops.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry


def _cv2():
    import cv2

    return cv2


@preprocessor_registry.register("scribble")
class ScribblePreprocessor(BasePreprocessor):
    """Dark-region scribble: pixels whose min channel < 127 become black
    strokes on white (reference src/preprocess/scribble ScribbleDetector)."""

    name = "scribble"

    def process_frame(self, frame: Frame, **_: Any) -> Frame:
        mask = np.zeros_like(frame, dtype=np.uint8)
        mask[np.min(frame, axis=2) < 127] = 255
        return 255 - mask


@preprocessor_registry.register("scribble_xdog")
class ScribbleXDogPreprocessor(BasePreprocessor):
    """Extended difference-of-gaussians scribble (reference
    src/preprocess/scribble ScribbleXDogDetector): DoG with sigmas 0.5/5.0,
    min over channels, threshold ``thr_a``."""

    name = "scribble_xdog"
    params_schema = {"thr_a": 32}

    def process_frame(self, frame: Frame, thr_a: int = 32, **_: Any) -> Frame:
        cv2 = _cv2()
        f32 = frame.astype(np.float32)
        g1 = cv2.GaussianBlur(f32, (0, 0), 0.5)
        g2 = cv2.GaussianBlur(f32, (0, 0), 5.0)
        dog = (255 - np.min(g2 - g1, axis=2)).clip(0, 255).astype(np.uint8)
        result = np.zeros_like(frame, dtype=np.uint8)
        result[2 * (255 - dog) > int(thr_a)] = 255
        return result


@preprocessor_registry.register("tile")
class TilePreprocessor(BasePreprocessor):
    """Pyramid-blur tile map: downsample by 2**iters then pyrUp back
    (reference src/preprocess/tile TileDetector)."""

    name = "tile"
    params_schema = {"pyrUp_iters": 3}

    def process_frame(self, frame: Frame, pyrUp_iters: int = 3,
                      **_: Any) -> Frame:
        cv2 = _cv2()
        h, w = frame.shape[:2]
        h64 = max(int(np.round(h / 64.0)) * 64, 64)
        w64 = max(int(np.round(w / 64.0)) * 64, 64)
        it = max(int(pyrUp_iters), 0)
        out = cv2.resize(frame, (max(w64 >> it, 1), max(h64 >> it, 1)),
                         interpolation=cv2.INTER_AREA)
        for _i in range(it):
            out = cv2.pyrUp(out)
        return out


def fast_guided_filter(img: np.ndarray, radius: int = 5, eps: float = 0.2,
                       scale: float = 4.0) -> np.ndarray:
    """Self-guided color guided filter with subsampled coefficient solve.

    a/b are computed on a ``scale``-times downsampled copy (He et al. fast
    variant) then bilinearly upsampled and applied at full resolution.
    ``img`` is float32 in [0,1], HWC.
    """
    cv2 = _cv2()
    h, w = img.shape[:2]
    hs, ws = max(int(h / scale), 4), max(int(w / scale), 4)
    I = cv2.resize(img, (ws, hs), interpolation=cv2.INTER_NEAREST)
    r = max(int(radius / scale), 1)
    k = 2 * r + 1

    def box(x):
        return cv2.blur(x, (k, k))

    mean_I = box(I)                               # (hs,ws,3)
    # 3x3 covariance of the guide at every pixel (6 unique entries)
    outer = I[..., :, None] * I[..., None, :]     # (hs,ws,3,3)
    mean_outer = box(outer.reshape(hs, ws, 9)).reshape(hs, ws, 3, 3)
    cov_I = mean_outer - mean_I[..., :, None] * mean_I[..., None, :]
    cov_I += np.eye(3, dtype=np.float32) * float(eps)
    # self-guided: p == I, so cov(I, p_c) is just row c of cov_I - eps*e_c;
    # recompute explicitly for clarity
    cov_Ip = mean_outer - mean_I[..., :, None] * mean_I[..., None, :]
    a = np.linalg.solve(cov_I, cov_Ip)            # (hs,ws,3,3): a[..., :, c]
    b = mean_I - np.einsum("hwic,hwi->hwc", a, mean_I)
    mean_a = box(a.reshape(hs, ws, 9)).reshape(hs, ws, 3, 3)
    mean_b = box(b)
    mean_a = cv2.resize(mean_a.reshape(hs, ws, 9), (w, h),
                        interpolation=cv2.INTER_LINEAR).reshape(h, w, 3, 3)
    mean_b = cv2.resize(mean_b, (w, h), interpolation=cv2.INTER_LINEAR)
    out = np.einsum("hwic,hwi->hwc", mean_a, img) + mean_b
    return out.astype(np.float32)


@preprocessor_registry.register("tile_gf")
class TileGuidedFilterPreprocessor(BasePreprocessor):
    """TTPlanet guided-filter tile: blur → guided filter → down/up resample
    (reference src/preprocess/tile TTPlanet_Tile_Detector_GF)."""

    name = "tile_gf"
    params_schema = {"scale_factor": 2.0, "blur_strength": 2.0,
                     "radius": 5, "eps": 0.2}

    def process_frame(self, frame: Frame, scale_factor: float = 2.0,
                      blur_strength: float = 2.0, radius: int = 5,
                      eps: float = 0.2, **_: Any) -> Frame:
        cv2 = _cv2()
        k = int(blur_strength) | 1
        img = cv2.GaussianBlur(frame, (k, k), sigmaX=blur_strength / 2)
        img = fast_guided_filter(img.astype(np.float32) / 255.0,
                                 radius=int(radius), eps=float(eps),
                                 scale=float(scale_factor) * 2)
        img = (img * 255.0).clip(0, 255).astype(np.uint8)
        h, w = img.shape[:2]
        nw, nh = max(int(w / scale_factor), 1), max(int(h / scale_factor), 1)
        down = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)
        return cv2.resize(down, (w, h), interpolation=cv2.INTER_CUBIC)


@preprocessor_registry.register("tile_simple")
class TileSimplePreprocessor(BasePreprocessor):
    """TTPlanet simple tile: down/up resample then gaussian blur
    (reference src/preprocess/tile TTPLanet_Tile_Detector_Simple)."""

    name = "tile_simple"
    params_schema = {"scale_factor": 2.0, "blur_strength": 2.0}

    def process_frame(self, frame: Frame, scale_factor: float = 2.0,
                      blur_strength: float = 2.0, **_: Any) -> Frame:
        cv2 = _cv2()
        h, w = frame.shape[:2]
        nw, nh = max(int(w / scale_factor), 1), max(int(h / scale_factor), 1)
        down = cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_AREA)
        up = cv2.resize(down, (w, h), interpolation=cv2.INTER_LANCZOS4)
        k = int(blur_strength) | 1
        return cv2.GaussianBlur(up, (k, k), sigmaX=blur_strength / 2)
