"""Wan-Animate pose conditioning preprocessors: pose2d / face2d / animalpose,
and dwpose_nlf for SCAIL (port of ``apex_studio_tpu/preprocess/pose2d.py``).

Behavioural counterparts of the reference's ``src/preprocess/pose2d/``
(Pose2dDetector: whole-body keypoints drawn in the AAPose format
wan-animate takes, ``__init__.py:45`` ``process``), ``src/preprocess/face2d/``
(the same detector, ``mode="face"``: a 512x512 face crop), the
AnimalPoseDetector of ``src/preprocess/dwpose/__init__.py:358`` (the AP10K
skeleton on animal-class detections) and ``src/preprocess/dwpose_nlf/``
(DWPose's 2-D keypoints with NLF's 3-D body as depth-ordered capsules).

All of them run on the ``cv2.dnn`` DWPose stack of ``dwpose.py`` on the host,
as in JAX; the host code is a copy. ``dwpose_nlf``'s NLF crop model
(``nlf.py``) runs on the preprocessor's ``device`` (``None`` is the card).

Ported semantics:
- ``resize_by_area`` (pose2d/utils.py:140): area-preserving resize, divisor 16.
- AAPose body-20 (pose2d_utils.py:182 ``load_from_kp2ds``): an averaged
  index-pair gather that makes the neck and toe points.
- ``draw_aapose_by_meta_new`` (human_visualization.py:237→826): ellipse limbs
  at 0.6-darkened colour, full-colour joints, stickwidth v2.
- ``get_face_bboxes`` (pose2d/utils.py:220): area-scaled expansion with the
  asymmetric 3:1 vertical split, then a 512x512 crop.

Departure: nothing is fetched (``dwpose.dwpose_files`` raises for a missing
ONNX file). Without an NLF checkpoint ``dwpose_nlf`` draws the DWPose 2-D
skeleton alone and logs a warning, the JAX module's documented output for
the missing optional file.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, preprocessor_registry
from apex_studio_tpu_torch.preprocess.dwpose import DWPoseRunner, _hsv, dwpose_files

# AAPose body-20: nose, neck, Rsho, Relb, Rwri, Lsho, Lelb, Lwri, Rhip, Rkne,
# Rank, Lhip, Lkne, Lank, Reye, Leye, Rear, Lear, Ltoe, Rtoe — built by
# averaging two gathers of the 133-kpt wholebody array (the neck is the
# shoulder midpoint, each toe the midpoint of two foot keypoints).
_AA_IDX_A = [0, 6, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3, 17, 20]
_AA_IDX_B = [0, 5, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3, 18, 21]

# 1-indexed limb pairs + colors (human_visualization.py:826 draw_aapose_new).
_AA_LIMBS = [(2, 3), (2, 6), (3, 4), (4, 5), (6, 7), (7, 8), (2, 9), (9, 10),
             (10, 11), (2, 12), (12, 13), (13, 14), (2, 1), (1, 15), (15, 17),
             (1, 16), (16, 18), (14, 19), (11, 20)]
_AA_COLORS = [(255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0),
              (170, 255, 0), (85, 255, 0), (0, 255, 0), (0, 255, 85),
              (0, 255, 170), (0, 255, 255), (0, 170, 255), (0, 85, 255),
              (0, 0, 255), (85, 0, 255), (170, 0, 255), (255, 0, 255),
              (255, 0, 170), (255, 0, 85), (200, 200, 0), (100, 100, 0)]

_HAND_EDGES = [(0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7), (7, 8),
               (0, 9), (9, 10), (10, 11), (11, 12), (0, 13), (13, 14), (14, 15),
               (15, 16), (0, 17), (17, 18), (18, 19), (19, 20)]

# AP10K skeleton (dwpose/__init__.py:43 draw_animalpose), 1-indexed.
_AP10K_PAIRS = [(1, 2), (2, 3), (1, 3), (3, 4), (4, 9), (9, 10), (10, 11),
                (4, 6), (6, 7), (7, 8), (4, 5), (5, 15), (15, 16), (16, 17),
                (5, 12), (12, 13), (13, 14)]
_AP10K_COLORS = [(255, 255, 255), (100, 255, 100), (150, 255, 255),
                 (100, 50, 255), (50, 150, 200), (0, 255, 255), (0, 150, 0),
                 (0, 0, 255), (0, 0, 150), (255, 50, 255), (255, 0, 255),
                 (255, 0, 0), (150, 0, 0), (255, 255, 100), (0, 150, 0),
                 (255, 255, 0), (150, 150, 150)]


def resize_by_area(image: np.ndarray, target_area: int,
                   divisor: int = 16) -> np.ndarray:
    """Resize keeping aspect so h*w ≈ target_area, dims divisible by divisor
    (pose2d/utils.py:140)."""
    import cv2

    h, w = image.shape[:2]
    aspect = w / h
    nh = math.sqrt(target_area / aspect)
    nw = target_area / nh
    nw = max(int(nw // divisor) * divisor, divisor)
    nh = max(int(nh // divisor) * divisor, divisor)
    interp = cv2.INTER_AREA if nw * nh < w * h else cv2.INTER_LINEAR
    return cv2.resize(image, (nw, nh), interpolation=interp)


def wholebody_to_aa(pts: np.ndarray, score: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[133,2]+[133] → (body20 [20,3], lhand [21,3], rhand [21,3]) with the
    AAPose averaged-gather layout (pose2d_utils.py:195)."""
    kp = np.concatenate([pts, score[:, None]], axis=1).astype(np.float32)
    body = (kp[_AA_IDX_A] + kp[_AA_IDX_B]) / 2.0
    return body, kp[91:112].copy(), kp[112:133].copy()


def draw_aapose(canvas: np.ndarray, body: np.ndarray, lhand: np.ndarray,
                rhand: np.ndarray, threshold: float = 0.5,
                draw_hand: bool = True, draw_head: bool = True) -> np.ndarray:
    """AAPose render (human_visualization.py:826 draw_aapose_new, v2
    stickwidth): darkened ellipse limbs + full-color joint dots."""
    import cv2

    h, w = canvas.shape[:2]
    stickwidth = max(int(min(h, w) / 200) - 1, 1)
    body = body.copy()
    if not draw_head:
        body[[0, 14, 15, 16, 17], 2] = 0.0
    for (a, b), color in zip(_AA_LIMBS, _AA_COLORS):
        k1, k2 = body[a - 1], body[b - 1]
        if k1[2] < threshold or k2[2] < threshold:
            continue
        mx, my = (k1[0] + k2[0]) / 2, (k1[1] + k2[1]) / 2
        length = math.hypot(k1[0] - k2[0], k1[1] - k2[1])
        ang = math.degrees(math.atan2(k1[1] - k2[1], k1[0] - k2[0]))
        poly = cv2.ellipse2Poly((int(mx), int(my)),
                                (max(int(length / 2), 1), stickwidth),
                                int(ang), 0, 360, 1)
        cv2.fillConvexPoly(canvas, poly, tuple(int(c * 0.6) for c in color))
    for kp, color in zip(body, _AA_COLORS):
        if kp[2] >= threshold:
            cv2.circle(canvas, (int(kp[0]), int(kp[1])), stickwidth, color, -1)
    if draw_hand:
        for hand in (lhand, rhand):
            for ei, (a, b) in enumerate(_HAND_EDGES):
                if hand[a, 2] < threshold or hand[b, 2] < threshold:
                    continue
                col = tuple(int(c * 255) for c in _hsv(ei / len(_HAND_EDGES)))
                cv2.line(canvas, (int(hand[a, 0]), int(hand[a, 1])),
                         (int(hand[b, 0]), int(hand[b, 1])), col,
                         max(stickwidth // 2, 1))
            for kp in hand:
                if kp[2] >= threshold:
                    cv2.circle(canvas, (int(kp[0]), int(kp[1])),
                               max(stickwidth // 2, 2), (0, 0, 255), -1)
    return canvas


def get_face_bbox(face_pts: np.ndarray, scale: float,
                  image_shape: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """Area-scaled face box with the 3:1 asymmetric vertical expansion
    (pose2d/utils.py:220 get_face_bboxes). Returns (x1, x2, y1, y2)."""
    h, w = image_shape
    mn = face_pts.min(axis=0)
    mx = face_pts.max(axis=0)
    iw, ih = max(mx[0] - mn[0], 1e-6), max(mx[1] - mn[1], 1e-6)
    area = iw * ih * scale
    nw = math.sqrt(area * (iw / ih))
    nh = math.sqrt(area * (ih / iw))
    dw = (nw - iw) / 2
    dh = (nh - ih) / 4
    x1 = max(mn[0] - dw, 0)
    x2 = min(mx[0] + dw, w)
    y1 = max(mn[1] - 3 * dh, 0)
    y2 = min(mx[1] + dh, h)
    return int(x1), int(x2), int(y1), int(y2)


class _Pose2DBase(BasePreprocessor):
    """Shared DWPose-runner lifecycle for the wan-animate pose family."""

    def __init__(self, runner: Optional[DWPoseRunner] = None):
        self._runner = runner

    def setup(self) -> None:
        if self._runner is not None:
            return
        self._runner = DWPoseRunner(*dwpose_files())

    def _best_person(self, bgr: np.ndarray):
        """Largest-box person's (pts [133,2], score [133]) or None."""
        boxes = self._runner.detect_people(bgr)
        if not len(boxes):
            return None
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        return self._runner.pose_one(bgr, boxes[int(np.argmax(areas))])


@preprocessor_registry.register("pose2d", aliases=("Pose2dDetector",))
class Pose2DPreprocessor(_Pose2DBase):
    """Wan-animate body conditioning: AAPose skeleton render on black
    (reference pose2d/__init__.py:45, mode="pose")."""

    name = "pose2d"
    params_schema = {"target_width": 832, "target_height": 480,
                     "threshold": 0.5, "draw_hand": True, "draw_head": True}

    def process_frame(self, frame: np.ndarray, **params) -> np.ndarray:
        tw = int(params.get("target_width", 832))
        th = int(params.get("target_height", 480))
        img = resize_by_area(np.asarray(frame), tw * th, divisor=16)
        canvas = np.zeros_like(img)
        res = self._best_person(img[..., ::-1].copy())
        if res is None:
            return canvas
        body, lh, rh = wholebody_to_aa(*res)
        return draw_aapose(canvas, body, lh, rh,
                           threshold=float(params.get("threshold", 0.5)),
                           draw_hand=bool(params.get("draw_hand", True)),
                           draw_head=bool(params.get("draw_head", True)))


@preprocessor_registry.register("face2d", aliases=("Face2dDetector",))
class Face2DPreprocessor(_Pose2DBase):
    """Wan-animate face conditioning: 512x512 crop of the area-scaled face
    box (reference face2d/__init__.py, pose2d mode="face")."""

    name = "face2d"
    params_schema = {"target_width": 832, "target_height": 480, "scale": 1.3}

    def process_frame(self, frame: np.ndarray, **params) -> np.ndarray:
        import cv2

        tw = int(params.get("target_width", 832))
        th = int(params.get("target_height", 480))
        img = resize_by_area(np.asarray(frame), tw * th, divisor=16)
        res = self._best_person(img[..., ::-1].copy())
        if res is None:
            return cv2.resize(img, (512, 512))
        pts, score = res
        face = pts[23:91]  # 68 face landmarks
        x1, x2, y1, y2 = get_face_bbox(
            face, float(params.get("scale", 1.3)), img.shape[:2])
        crop = img[y1:y2, x1:x2]
        if crop.size == 0:
            crop = img
        return cv2.resize(crop, (512, 512))


@preprocessor_registry.register("animalpose", aliases=("AnimalPoseDetector",
                                                       "animal_pose"))
class AnimalPosePreprocessor(_Pose2DBase):
    """AP10K-skeleton animal pose (reference dwpose/__init__.py:358): YOLOX
    animal-class detections (COCO ids 14-23) → SimCC pose → 17-keypoint
    skeleton render."""

    name = "animalpose"
    params_schema = {"threshold": 0.3}

    def process_frame(self, frame: np.ndarray, **params) -> np.ndarray:
        import cv2

        img = np.asarray(frame)
        h, w = img.shape[:2]
        bgr = img[..., ::-1].copy()
        boxes = self._detect_animals(bgr)
        canvas = np.zeros((h, w, 3), np.uint8)
        thr = float(params.get("threshold", 0.3))
        for box in boxes[:8]:
            pts, score = self._runner.pose_one(bgr, box)
            self._draw_ap10k(canvas, pts[:17], score[:17], thr)
        return canvas

    def _detect_animals(self, bgr: np.ndarray, conf: float = 0.3) -> np.ndarray:
        """YOLOX pass keeping COCO animal classes 14-23 (bird..giraffe)."""
        import cv2

        from apex_studio_tpu_torch.preprocess.dwpose import DET_SIZE, _nms, _yolox_decode

        h, w = bgr.shape[:2]
        r = min(DET_SIZE / h, DET_SIZE / w)
        nh, nw = int(round(h * r)), int(round(w * r))
        pad = np.full((DET_SIZE, DET_SIZE, 3), 114, np.uint8)
        pad[:nh, :nw] = cv2.resize(bgr, (nw, nh))
        self._runner.det.setInput(pad.astype(np.float32).transpose(2, 0, 1)[None])
        out = self._runner.det.forward()
        dets = _yolox_decode(out.reshape(-1, out.shape[-1]))
        keep = (dets[:, 5] >= 14) & (dets[:, 5] <= 23) & (dets[:, 4] > conf)
        dets = dets[keep]
        if not len(dets):
            return np.zeros((0, 4), np.float32)
        return dets[_nms(dets)][:, :4] / r

    @staticmethod
    def _draw_ap10k(canvas: np.ndarray, pts: np.ndarray, score: np.ndarray,
                    thr: float) -> None:
        import cv2

        for (a, b), color in zip(_AP10K_PAIRS, _AP10K_COLORS):
            if score[a - 1] < thr or score[b - 1] < thr:
                continue
            cv2.line(canvas, (int(pts[a - 1, 0]), int(pts[a - 1, 1])),
                     (int(pts[b - 1, 0]), int(pts[b - 1, 1])), color, 5)


@preprocessor_registry.register("dwpose_nlf", aliases=("DwposeNlfDetector",))
class DWPoseNLFPreprocessor(_Pose2DBase):
    """dwpose_nlf id (wan-scail conditioning, reference
    src/preprocess/dwpose_nlf/__init__.py): DWPose whole-body 2D keypoints
    fused with NLF (Neural Localizer Fields) 3D body lifting, rendered as
    depth-ordered limb capsules with the DWPose hands/face overlaid
    (reference ``render_nlf_as_images`` + the ``draw_2d=True`` overlay).

    The NLF crop model (``preprocess/nlf.py``) loads from the published
    ``nlf_l_multi`` safetensors when present (``APEX_NLF_PATH`` or the
    preprocessor models dir) onto the preprocessor's device; detection boxes
    come from the DWPose person detector (the reference re-detects its
    DWPose-box-masked frame with a bundled YOLOv8x ONNX). Without the
    checkpoint this draws the DWPose whole-body skeleton, the 2D projection
    of the capsule render.
    """

    name = "dwpose_nlf"
    params_schema = {"threshold": 0.3, "stickwidth": 6}
    _NLF_FILES = ("nlf_l_multi_0.3.2", "nlf_l_multi")

    def __init__(self, runner=None):
        super().__init__(runner)
        self._nlf = None
        self._nlf_missing = False

    def setup(self) -> None:
        super().setup()
        if self._nlf is not None or self._nlf_missing:
            return
        import logging
        import os

        from apex_studio_tpu_torch.preprocess.weights import find_local

        path = os.environ.get("APEX_NLF_PATH")
        if not path:
            for stem in self._NLF_FILES:
                hit = find_local(stem)
                if hit is not None:
                    path = str(hit)
                    break
        if path:
            from apex_studio_tpu_torch.preprocess.nlf import load_nlf

            self._nlf = load_nlf(path, device=self.device)
        else:
            self._nlf_missing = True
            logging.getLogger("apex.preprocess").warning(
                "dwpose_nlf: NLF checkpoint not found (APEX_NLF_PATH or "
                "nlf_l_multi*.safetensors in the preprocessor models dir); "
                "rendering the DWPose 2D skeleton only")

    def process_frame(self, frame: np.ndarray, **params) -> np.ndarray:
        from apex_studio_tpu_torch.preprocess.dwpose import draw_wholebody

        img = np.asarray(frame)
        h, w = img.shape[:2]
        bgr = img[..., ::-1].copy()
        boxes = self._runner.detect_people(bgr)
        people = []
        for box in boxes[:10]:
            people.append(self._runner.pose_one(bgr, box))

        if self._nlf is None:
            return draw_wholebody(people, h, w,
                                  stickwidth=int(params.get("stickwidth", 6)),
                                  kp_thresh=float(params.get("threshold", 0.3)))

        from apex_studio_tpu_torch.preprocess.nlf import intrinsics_from_fov
        from apex_studio_tpu_torch.preprocess.nlf_render import (
            pose_cylinder_specs, render_capsule_frames)

        # (x, y, w, h, score=1) pixel boxes for the NLF estimator
        nlf_boxes = np.array(
            [[b[0], b[1], b[2] - b[0], b[3] - b[1], 1.0] for b in boxes[:10]],
            np.float32).reshape(-1, 5)
        joints = self._nlf.estimate(img, nlf_boxes)
        k = intrinsics_from_fov(h, w)
        rgba = render_capsule_frames([pose_cylinder_specs(joints)], h, w,
                                     k[0, 0], k[1, 1], k[0, 2], k[1, 2])[0]
        canvas = rgba[..., :3].copy()
        # hands + face 2D overlay on top of the capsule render (reference:
        # nonzero 2D pixels overwrite the 3D frame, __init__.py:423-437)
        overlay = draw_wholebody(people, h, w, stickwidth=2, body=False,
                                 kp_thresh=float(params.get("threshold", 0.3)))
        mask = overlay != 0
        canvas[mask] = overlay[mask]
        return canvas
