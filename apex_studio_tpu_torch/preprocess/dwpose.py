"""DWPose whole-body pose estimation (body + hands + face + feet), port of
``apex_studio_tpu/preprocess/dwpose.py``.

The reference's ``src/preprocess/dwpose/`` (Wholebody, wholebody.py:27):
YOLOX-L person detection and RTMPose-L SimCC whole-body keypoints (133) on
the published ONNX pair (``yzd-v/DWPose``: ``yolox_l.onnx``,
``dw-ll_ucoco_384.onnx``), drawn in the openpose format the editor's pose
panels take. The JAX module runs the pair through ``cv2.dnn`` on the host
(the reference's own ``cv2.dnn`` path, wholebody.py:66), and so does the
port: this module is a copy, with no device part. The detector decode (grid
offsets and exp sizes a stride), the SimCC argmax / 2 decode, the box →
crop affine and the 133-keypoint drawing are the JAX module's.

Keypoint layout (COCO-WholeBody): 0-16 body, 17-22 feet, 23-90 face (68),
91-111 left hand, 112-132 right hand.

Departure: nothing is fetched. The JAX preprocessor downloads a missing
ONNX file from ``yzd-v/DWPose``; here ``dwpose_files`` raises
``FileNotFoundError`` naming the file and the preprocessor models dir.
"""

from __future__ import annotations

import logging
import math
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, preprocessor_registry

logger = logging.getLogger("apex.preprocess.dwpose")

DET_SIZE = 640
DWPOSE_FILES = ("yolox_l.onnx", "dw-ll_ucoco_384.onnx")
POSE_W, POSE_H = 288, 384

# openpose body-18 from COCO-17: [nose, neck, Rsho, Relb, Rwri, Lsho, Lelb,
# Lwri, Rhip, Rkne, Rank, Lhip, Lkne, Lank, Reye, Leye, Rear, Lear]
_COCO_TO_OPENPOSE = [0, -1, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3]

_BODY_LIMBS = [(1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
               (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
               (0, 15), (15, 17)]
_BODY_COLORS = [(255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0),
                (170, 255, 0), (85, 255, 0), (0, 255, 0), (0, 255, 85),
                (0, 255, 170), (0, 255, 255), (0, 170, 255), (0, 85, 255),
                (0, 0, 255), (85, 0, 255), (170, 0, 255), (255, 0, 255),
                (255, 0, 170), (255, 0, 85)]
_HAND_EDGES = [(0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7), (7, 8),
               (0, 9), (9, 10), (10, 11), (11, 12), (0, 13), (13, 14), (14, 15),
               (15, 16), (0, 17), (17, 18), (18, 19), (19, 20)]


def _yolox_decode(pred: np.ndarray, img_size: int = DET_SIZE) -> np.ndarray:
    """Raw YOLOX head output [N, 85] (concat over strides 8/16/32) →
    [N, 6] (x1,y1,x2,y2,score,cls). Grid decode per stride."""
    grids, strides = [], []
    for s in (8, 16, 32):
        n = img_size // s
        gy, gx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        grids.append(np.stack([gx, gy], -1).reshape(-1, 2))
        strides.append(np.full((n * n, 1), s, np.float32))
    grid = np.concatenate(grids, 0).astype(np.float32)
    stride = np.concatenate(strides, 0)
    xy = (pred[:, :2] + grid) * stride
    wh = np.exp(pred[:, 2:4]) * stride
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    obj = pred[:, 4:5]
    cls = pred[:, 5:]
    scores = obj * cls
    cid = scores.argmax(-1)
    conf = scores.max(-1)
    return np.concatenate([boxes, conf[:, None], cid[:, None]], -1)


def _nms(dets: np.ndarray, thresh: float = 0.45) -> List[int]:
    x1, y1, x2, y2, s = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1) * (y2 - y1)
    order = s.argsort()[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        iou = inter / np.maximum(areas[i] + areas[order[1:]] - inter, 1e-9)
        order = order[1:][iou <= thresh]
    return keep


def dwpose_files() -> Tuple[Path, Path]:
    """(detector, pose) ONNX paths in the preprocessor models dir; a missing
    one raises ``FileNotFoundError`` (nothing is fetched)."""
    from apex_studio_tpu_torch.preprocess.weights import find_local
    from apex_studio_tpu_torch.utils.defaults import get_preprocessor_models_path

    out = []
    for filename in DWPOSE_FILES:
        path = find_local(filename.rsplit(".", 1)[0], filename=filename)
        if path is None:
            raise FileNotFoundError(f"no '{filename}' under {get_preprocessor_models_path()}: place the "
                                    f"published yzd-v/DWPose file there (nothing is fetched)")
        out.append(path)
    return out[0], out[1]


class DWPoseRunner:
    """cv2.dnn nets over the published DWPose ONNX pair."""

    def __init__(self, det_path, pose_path):
        import cv2

        self.det = cv2.dnn.readNetFromONNX(str(det_path))
        self.pose = cv2.dnn.readNetFromONNX(str(pose_path))

    def detect_people(self, bgr: np.ndarray, conf: float = 0.3) -> np.ndarray:
        import cv2

        h, w = bgr.shape[:2]
        r = min(DET_SIZE / h, DET_SIZE / w)
        nh, nw = int(round(h * r)), int(round(w * r))
        canvas = np.full((DET_SIZE, DET_SIZE, 3), 114, np.uint8)
        canvas[:nh, :nw] = cv2.resize(bgr, (nw, nh))
        blob = canvas.astype(np.float32).transpose(2, 0, 1)[None]
        self.det.setInput(blob)
        out = self.det.forward()
        pred = out.reshape(-1, out.shape[-1])
        dets = _yolox_decode(pred)
        dets = dets[(dets[:, 5] == 0) & (dets[:, 4] > conf)]
        if not len(dets):
            return np.zeros((0, 4), np.float32)
        dets = dets[_nms(dets)]
        return dets[:, :4] / r

    def pose_one(self, bgr: np.ndarray, box: np.ndarray):
        """→ (keypoints [133,2] in image coords, scores [133])."""
        import cv2

        x1, y1, x2, y2 = box
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        bw, bh = (x2 - x1) * 1.25, (y2 - y1) * 1.25
        # expand to the 288:384 aspect
        if bw / bh > POSE_W / POSE_H:
            bh = bw * POSE_H / POSE_W
        else:
            bw = bh * POSE_W / POSE_H
        src = np.float32([[cx - bw / 2, cy - bh / 2], [cx + bw / 2, cy - bh / 2],
                          [cx - bw / 2, cy + bh / 2]])
        dst = np.float32([[0, 0], [POSE_W, 0], [0, POSE_H]])
        mat = cv2.getAffineTransform(src, dst)
        crop = cv2.warpAffine(bgr, mat, (POSE_W, POSE_H), flags=cv2.INTER_LINEAR)
        mean = np.array([123.675, 116.28, 103.53], np.float32)
        std = np.array([58.395, 57.12, 57.375], np.float32)
        blob = ((crop[..., ::-1].astype(np.float32) - mean) / std)
        blob = blob.transpose(2, 0, 1)[None]
        self.pose.setInput(blob)
        names = self.pose.getUnconnectedOutLayersNames()
        outs = self.pose.forward(names)
        simcc_x, simcc_y = outs[0][0], outs[1][0]  # [133, W*2], [133, H*2]
        if simcc_x.shape[-1] < simcc_y.shape[-1]:
            simcc_x, simcc_y = simcc_y, simcc_x
        if simcc_x.shape[-1] != POSE_W * 2:
            simcc_x, simcc_y = simcc_y, simcc_x
        xs = simcc_x.argmax(-1) / 2.0
        ys = simcc_y.argmax(-1) / 2.0
        score = np.minimum(simcc_x.max(-1), simcc_y.max(-1))
        pts = np.stack([xs, ys], -1).astype(np.float32)
        inv = cv2.invertAffineTransform(mat)
        pts = pts @ inv[:, :2].T + inv[:, 2]
        return pts, score


def draw_wholebody(people, h: int, w: int, stickwidth: int = 4,
                   kp_thresh: float = 0.3, body: bool = True) -> np.ndarray:
    """133-keypoint openpose-style rendering (body sticks, hand edges, face
    dots) on black — the format the reference's util.draw_poses emits.
    ``body=False`` renders hands + face only (the dwpose_nlf 2D overlay on
    top of the 3D capsule body)."""
    import cv2

    canvas = np.zeros((h, w, 3), np.uint8)
    for pts, score in people:
        # body-18 (neck synthesized from shoulders)
        body18 = np.zeros((18, 2), np.float32)
        bscore = np.zeros(18, np.float32)
        for oi, ci in enumerate(_COCO_TO_OPENPOSE):
            if ci >= 0:
                body18[oi] = pts[ci]
                bscore[oi] = score[ci]
        if score[5] > kp_thresh and score[6] > kp_thresh:
            body18[1] = (pts[5] + pts[6]) / 2
            bscore[1] = (score[5] + score[6]) / 2
        if not body:
            bscore[:] = 0.0
        for li, (a, b) in enumerate(_BODY_LIMBS):
            if bscore[a] < kp_thresh or bscore[b] < kp_thresh:
                continue
            ax, ay = body18[a]
            bx, by = body18[b]
            mx, my = (ax + bx) / 2, (ay + by) / 2
            length = math.hypot(ax - bx, ay - by)
            ang = math.degrees(math.atan2(ay - by, ax - bx))
            poly = cv2.ellipse2Poly((int(mx), int(my)),
                                    (max(int(length / 2), 1), stickwidth),
                                    int(ang), 0, 360, 1)
            cv2.fillConvexPoly(canvas, poly, _BODY_COLORS[li % len(_BODY_COLORS)])
        for i in range(18):
            if bscore[i] > kp_thresh:
                cv2.circle(canvas, tuple(np.int32(body18[i])), stickwidth,
                           _BODY_COLORS[i % len(_BODY_COLORS)], -1)
        # hands: rainbow edges
        for base in (91, 112):
            hand = pts[base:base + 21]
            hs = score[base:base + 21]
            for ei, (a, b) in enumerate(_HAND_EDGES):
                if hs[a] < kp_thresh or hs[b] < kp_thresh:
                    continue
                col = tuple(int(c * 255) for c in _hsv(ei / len(_HAND_EDGES)))
                cv2.line(canvas, tuple(np.int32(hand[a])), tuple(np.int32(hand[b])),
                         col, 2)
            for i in range(21):
                if hs[i] > kp_thresh:
                    cv2.circle(canvas, tuple(np.int32(hand[i])), 3, (0, 0, 255), -1)
        # face: white dots
        for i in range(23, 91):
            if score[i] > kp_thresh:
                cv2.circle(canvas, tuple(np.int32(pts[i])), 2, (255, 255, 255), -1)
    return canvas


def _hsv(h: float) -> Tuple[float, float, float]:
    import colorsys

    return colorsys.hsv_to_rgb(h, 1.0, 1.0)


@preprocessor_registry.register("dwpose")
class DWPosePreprocessor(BasePreprocessor):
    """Whole-body pose (body+hands+face) via DWPose; the pose detector the
    editor defaults to. Params: ``detect_hands``/``detect_face`` toggles,
    ``stickwidth``. Weights: yolox_l.onnx + dw-ll_ucoco_384.onnx
    (yzd-v/DWPose)."""

    name = "dwpose"
    params_schema = {"stickwidth": 4, "detect_hands": True, "detect_face": True,
                     "kp_thresh": 0.3}

    def __init__(self, runner: Optional[DWPoseRunner] = None):
        self._runner = runner

    def setup(self) -> None:
        if self._runner is not None:
            return
        self._runner = DWPoseRunner(*dwpose_files())

    def process_frame(self, frame: np.ndarray, **params) -> np.ndarray:
        h, w = frame.shape[:2]
        bgr = np.asarray(frame)[..., ::-1].copy()
        boxes = self._runner.detect_people(bgr)
        people = []
        kp_thresh = float(params.get("kp_thresh", 0.3))
        for box in boxes[:10]:
            pts, score = self._runner.pose_one(bgr, box)
            if not bool(params.get("detect_hands", True)):
                score = score.copy()
                score[91:133] = 0.0
            if not bool(params.get("detect_face", True)):
                score = score.copy()
                score[23:91] = 0.0
            people.append((pts, score))
        return draw_wholebody(people, h, w,
                              int(params.get("stickwidth", 4)), kp_thresh)
