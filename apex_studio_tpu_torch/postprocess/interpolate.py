"""Frame interpolation postprocessors (port of
``apex_studio_tpu/postprocess/interpolate.py``; cv2 and numpy, copied).

``frame_interpolation`` is model-free bidirectional optical-flow warping
(Farneback flow + inverse-mapped remap, blended); when a ``rife_v4``
checkpoint is installed it runs the learned RIFE interpolator instead.
Unlike the JAX package, an error inside RIFE propagates: it is not turned
into a silent fall back to flow warping. ``blend`` is a plain cross-fade.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from apex_studio_tpu_torch.postprocess.base import BasePostprocessor, postprocessor_registry
from apex_studio_tpu_torch.utils.progress import ProgressCallback, safe_emit_progress


def _flow(a_gray: np.ndarray, b_gray: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.calcOpticalFlowFarneback(
        a_gray, b_gray, None,
        pyr_scale=0.5, levels=4, winsize=21, iterations=3,
        poly_n=5, poly_sigma=1.2, flags=0,
    )


def _warp(img: np.ndarray, flow: np.ndarray, t: float) -> np.ndarray:
    import cv2

    h, w = img.shape[:2]
    grid_x, grid_y = np.meshgrid(np.arange(w, dtype=np.float32),
                                 np.arange(h, dtype=np.float32))
    map_x = grid_x + t * flow[..., 0]
    map_y = grid_y + t * flow[..., 1]
    return cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REPLICATE)


def interpolate_pair(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """Middle frame at fraction t ∈ (0,1) between frames a and b."""
    import cv2

    ag = cv2.cvtColor(a, cv2.COLOR_RGB2GRAY)
    bg = cv2.cvtColor(b, cv2.COLOR_RGB2GRAY)
    fwd = _flow(ag, bg)   # a → b
    bwd = _flow(bg, ag)   # b → a
    # Inverse mapping: sample a along the backward-in-time flow.
    from_a = _warp(a, bwd, 1.0 - t)
    from_b = _warp(b, fwd, t)
    out = (1.0 - t) * from_a.astype(np.float32) + t * from_b.astype(np.float32)
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


@postprocessor_registry.register("frame_interpolation", aliases=("rife", "interpolate"))
class FrameInterpolationPostprocessor(BasePostprocessor):
    name = "frame_interpolation"

    def __call__(
        self,
        frames: Sequence[np.ndarray],
        progress_callback: Optional[ProgressCallback] = None,
        multiplier: int = 2,
        **_: Any,
    ) -> List[np.ndarray]:
        frames = list(frames)
        if len(frames) < 2 or multiplier < 2:
            return frames
        from apex_studio_tpu_torch.postprocess.rife import RIFEPostprocessor, find_local

        if find_local("rife_v4") is not None:
            return RIFEPostprocessor(device=self.device)(
                frames, progress_callback=progress_callback, multiplier=multiplier)
        out: List[np.ndarray] = []
        n_pairs = len(frames) - 1
        for i in range(n_pairs):
            out.append(frames[i])
            for j in range(1, multiplier):
                out.append(interpolate_pair(frames[i], frames[i + 1], j / multiplier))
            safe_emit_progress(
                progress_callback, (i + 1) / n_pairs, f"interpolated pair {i + 1}/{n_pairs}"
            )
        out.append(frames[-1])
        return out


@postprocessor_registry.register("blend")
class BlendInterpolationPostprocessor(BasePostprocessor):
    """Cheap cross-fade (no motion compensation)."""

    name = "blend"

    def __call__(self, frames: Sequence[np.ndarray], progress_callback=None,
                 multiplier: int = 2, **_: Any) -> List[np.ndarray]:
        frames = list(frames)
        if len(frames) < 2 or multiplier < 2:
            return frames
        out: List[np.ndarray] = []
        for i in range(len(frames) - 1):
            out.append(frames[i])
            for j in range(1, multiplier):
                t = j / multiplier
                mix = (1 - t) * frames[i].astype(np.float32) + t * frames[i + 1].astype(np.float32)
                out.append(np.clip(mix + 0.5, 0, 255).astype(np.uint8))
        out.append(frames[-1])
        return out
