"""Point / box mask segmentation and video tracking (port of
``apex_studio_tpu/mask/segment.py``; numpy and OpenCV on the host, as there).

A mask comes from touch points, a lasso path or a box through GrabCut seeded
from the prompt, with morphological cleanup; tracking warps the mask along
dense optical flow with periodic GrabCut refinement. The output formats
(HxW uint8 masks, flat contour polygons, shape bounds) are the JAX module's.

A point or box prompt runs the SAM2 predictor (``mask/predictor.py``) where a
checkpoint is configured or on disk, on ``device`` (``None`` is the card);
without one it runs GrabCut, as the JAX module does, and fetches nothing.

Departure: the JAX ``mask_from_points`` falls back to GrabCut on any SAM2
error; here a SAM2 failure raises (ROADMAP "Departures").
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger("apex.mask")

Point = Dict[str, float]


def _grabcut(
    image: np.ndarray,
    rect: Optional[Tuple[int, int, int, int]] = None,
    fg_points: Optional[np.ndarray] = None,
    bg_points: Optional[np.ndarray] = None,
    seed_mask: Optional[np.ndarray] = None,
    iterations: int = 5,
) -> np.ndarray:
    import cv2

    h, w = image.shape[:2]
    mask = np.full((h, w), cv2.GC_PR_BGD, np.uint8)

    if seed_mask is not None:
        mask[seed_mask > 0] = cv2.GC_PR_FGD
    if rect is not None:
        x1, y1, x2, y2 = rect
        mask[max(0, y1):min(h, y2), max(0, x1):min(w, x2)] = cv2.GC_PR_FGD

    def paint(points, value, radius):
        for x, y in points:
            cv2.circle(mask, (int(x), int(y)), radius, int(value), -1)

    if fg_points is not None and len(fg_points):
        paint(fg_points, cv2.GC_FGD, max(3, min(h, w) // 100))
    if bg_points is not None and len(bg_points):
        paint(bg_points, cv2.GC_BGD, max(3, min(h, w) // 100))

    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    try:
        cv2.grabCut(image, mask, None, bgd, fgd, iterations, cv2.GC_INIT_WITH_MASK)
    except cv2.error as e:
        logger.warning("grabCut failed (%s); falling back to seed region", e)
    out = np.where((mask == 2) | (mask == 0), 0, 1).astype(np.uint8)

    # Morphological cleanup + keep components touching the positive seeds.
    kernel = np.ones((5, 5), np.uint8)
    out = cv2.morphologyEx(out, cv2.MORPH_CLOSE, kernel)
    out = cv2.morphologyEx(out, cv2.MORPH_OPEN, kernel)
    if fg_points is not None and len(fg_points):
        n, labels = cv2.connectedComponents(out)
        keep = set()
        for x, y in fg_points:
            xi, yi = int(np.clip(x, 0, w - 1)), int(np.clip(y, 0, h - 1))
            if labels[yi, xi] > 0:
                keep.add(labels[yi, xi])
        if keep:
            out = np.isin(labels, list(keep)).astype(np.uint8)
    return out


def mask_from_points(
    image: np.ndarray,
    points: Sequence[Point],
    point_labels: Optional[Sequence[int]] = None,
    box: Optional[Dict[str, float]] = None,
    tool: str = "touch",
    device=None,
) -> np.ndarray:
    """HWC uint8 RGB image + prompt → binary mask HxW uint8: SAM2 on
    ``device`` where a checkpoint resolves (``mask/predictor.py``), else
    GrabCut."""
    if tool != "lasso" and (points or box is not None):
        from apex_studio_tpu_torch.mask.predictor import get_sam2_predictor

        predictor = get_sam2_predictor(device)
        if predictor is not None:
            return predictor.predict(image, points, point_labels, box)
    import cv2

    pts = np.array([[p["x"], p["y"]] for p in points], np.float32) if points else np.zeros((0, 2))
    labels = (
        np.asarray(point_labels, np.int32)
        if point_labels is not None
        else np.ones(len(pts), np.int32)
    )
    fg = pts[labels == 1] if len(pts) else None
    bg = pts[labels == 0] if len(pts) else None

    seed_mask = None
    rect = None
    if tool == "lasso" and len(pts) >= 3:
        seed_mask = np.zeros(image.shape[:2], np.uint8)
        cv2.fillPoly(seed_mask, [pts.astype(np.int32)], 1)
    elif box is not None:
        rect = (int(box["x1"]), int(box["y1"]), int(box["x2"]), int(box["y2"]))
    elif fg is not None and len(fg):
        # Touch tool: seed a window around the points.
        h, w = image.shape[:2]
        pad = max(h, w) // 6
        x1 = int(max(0, fg[:, 0].min() - pad))
        y1 = int(max(0, fg[:, 1].min() - pad))
        x2 = int(min(w, fg[:, 0].max() + pad))
        y2 = int(min(h, fg[:, 1].max() + pad))
        rect = (x1, y1, x2, y2)

    return _grabcut(image, rect=rect, fg_points=fg, bg_points=bg, seed_mask=seed_mask)


def mask_from_box(image: np.ndarray, box: Dict[str, float]) -> np.ndarray:
    return mask_from_points(image, [], box=box, tool="shape")


def mask_to_contours(mask: np.ndarray, epsilon_frac: float = 0.002) -> List[List[float]]:
    """Binary mask → contour polygons as flat [x1,y1,x2,y2,…] lists (the
    reference's MaskResponse format, api/mask.py:148)."""
    import cv2

    contours, _ = cv2.findContours(
        (mask > 0).astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    out: List[List[float]] = []
    for c in contours:
        if cv2.contourArea(c) < 16:
            continue
        eps = epsilon_frac * cv2.arcLength(c, True)
        poly = cv2.approxPolyDP(c, eps, True).reshape(-1, 2)
        if len(poly) >= 3:
            out.append([float(v) for v in poly.reshape(-1)])
    return out


def shape_bounds_from_contours(
    contours: List[List[float]], shape_type: Optional[str] = None
) -> Optional[Dict[str, float]]:
    """Oriented shape bounds from the largest contour's min-area rect — the
    frontend shape-layer format the reference emits from /mask/track/shapes
    (``src/mask/mask.py:270`` shape_bounds_from_contours):

    - rectangle: top-left pivot bounds
    - ellipse / star: center-based bounds (star: square, side = min(w, h))
    - polygon / triangle: center-based, width/height = 1.1543665517482078
    """
    import cv2

    if not contours:
        return None
    pts_all = [np.asarray(c, np.float32).reshape(-1, 2) for c in contours]
    largest = max(pts_all, key=cv2.contourArea)
    (cx, cy), (w, h), angle = cv2.minAreaRect(largest)
    st = (shape_type or "rectangle").lower()
    base = {"rotation": float(angle), "scaleX": 1.0, "scaleY": 1.0}
    if st == "ellipse":
        return {"x": float(cx), "y": float(cy), "width": float(w),
                "height": float(h), "shapeType": "ellipse", **base}
    if st == "star":
        side = float(max(1.0, min(w, h)))
        return {"x": float(cx), "y": float(cy), "width": side, "height": side,
                "shapeType": "star", **base}
    if st in ("polygon", "triangle"):
        ratio = 1.1543665517482078  # width / height
        fit_h = float(max(1.0, min(h, w / ratio)))
        fit_w = float(max(1.0, ratio * fit_h))
        return {"x": float(cx), "y": float(cy), "width": fit_w,
                "height": fit_h, "shapeType": "polygon", **base}
    return {"x": float(cx - w / 2.0), "y": float(cy - h / 2.0),
            "width": float(w), "height": float(h),
            "shapeType": st if st != "rectangle" else "rectangle", **base}


def track_mask(
    frames: Sequence[np.ndarray],
    initial_mask: np.ndarray,
    start_frame: int = 0,
    direction: str = "forward",
    refine_every: int = 8,
    progress_callback=None,
    frame_callback=None,
) -> Dict[int, np.ndarray]:
    """Propagate a mask across frames by dense optical-flow warping, with
    periodic GrabCut refinement (counterpart of SAM2 memory tracking,
    api/mask.py:584)."""
    import cv2

    from apex_studio_tpu_torch.utils.progress import safe_emit_progress

    results: Dict[int, np.ndarray] = {start_frame: initial_mask.astype(np.uint8)}

    def propagate(indices):
        prev_mask = initial_mask.astype(np.uint8)
        prev_gray = cv2.cvtColor(frames[start_frame], cv2.COLOR_RGB2GRAY)
        for step, idx in enumerate(indices):
            gray = cv2.cvtColor(frames[idx], cv2.COLOR_RGB2GRAY)
            flow = cv2.calcOpticalFlowFarneback(
                prev_gray, gray, None, 0.5, 4, 21, 3, 5, 1.2, 0
            )
            h, w = gray.shape
            gx, gy = np.meshgrid(np.arange(w, dtype=np.float32),
                                 np.arange(h, dtype=np.float32))
            # Inverse warp: sample previous mask at backward-mapped positions.
            back = cv2.calcOpticalFlowFarneback(
                gray, prev_gray, None, 0.5, 4, 21, 3, 5, 1.2, 0
            )
            warped = cv2.remap(
                prev_mask, gx + back[..., 0], gy + back[..., 1],
                cv2.INTER_NEAREST, borderMode=cv2.BORDER_CONSTANT, borderValue=0,
            )
            if refine_every and (step + 1) % refine_every == 0 and warped.any():
                warped = _grabcut(frames[idx], seed_mask=warped, iterations=2)
            results[idx] = warped
            prev_mask, prev_gray = warped, gray
            if frame_callback is not None:
                frame_callback(idx, warped)
            safe_emit_progress(
                progress_callback, (step + 1) / max(1, len(indices)),
                f"tracked frame {idx}",
            )

    n = len(frames)
    if direction in ("forward", "both"):
        propagate(range(start_frame + 1, n))
    if direction in ("backward", "both"):
        propagate(range(start_frame - 1, -1, -1))
    return results
