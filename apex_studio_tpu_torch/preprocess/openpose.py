"""OpenPose body pose (port of ``apex_studio_tpu/preprocess/openpose.py``):
the CMU two-branch network, a VGG19 trunk then 6 stages each predicting 38
part-affinity-field and 19 keypoint heatmap channels, NHWC at every function
as in the JAX module and with its attribute names (``loaders/from_jax.py``
carries its parameters); the published ``body_pose_model.pth`` loads through
``convert_openpose_keys`` strictly. The network runs in f32 on ``device``
(``None`` is the card); peak finding, PAF line-integral scoring, greedy limb
assembly and the renderer run in numpy and OpenCV on the host, copied from
the JAX module.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_anything import Conv, resize_bilinear_ac
from apex_studio_tpu_torch.utils.jax_resize import resize as jax_resize

logger = logging.getLogger("apex.preprocess.pose")

# trunk: (name, cin, cout, kernel) with maxpool positions marked
_TRUNK = [
    ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3), ("pool",),
    ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3), ("pool",),
    ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3),
    ("conv3_3", 256, 256, 3), ("conv3_4", 256, 256, 3), ("pool",),
    ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
    ("conv4_3_CPM", 512, 256, 3), ("conv4_4_CPM", 256, 128, 3),
]

N_PAF, N_HEAT = 38, 19


@dataclasses.dataclass
class OpenPoseConfig:
    stages: int = 6
    trunk_width: float = 1.0  # test-size shrink factor (keeps topology)

    @classmethod
    def tiny(cls) -> "OpenPoseConfig":
        return cls(stages=2, trunk_width=0.125)


class _Stage1Branch(nn.Module):
    def __init__(self, cout: int, w: float):
        super().__init__()
        c = lambda n: max(1, int(n * w))  # noqa: E731
        self.convs = nn.ModuleList([
            Conv(c(128), c(128), 3),
            Conv(c(128), c(128), 3),
            Conv(c(128), c(128), 3),
            Conv(c(128), c(512), 1, padding=0),
            Conv(c(512), cout, 1, padding=0),
        ])

    def forward(self, x):
        for conv in self.convs[:-1]:
            x = F.relu(conv(x))
        return self.convs[-1](x)


class _RefineBranch(nn.Module):
    def __init__(self, cin: int, cout: int, w: float):
        super().__init__()
        c = lambda n: max(1, int(n * w))  # noqa: E731
        self.convs = nn.ModuleList(
            [Conv(cin, c(128), 7, padding=3)]
            + [Conv(c(128), c(128), 7, padding=3) for _ in range(4)]
            + [Conv(c(128), c(128), 1, padding=0), Conv(c(128), cout, 1, padding=0)]
        )

    def forward(self, x):
        for conv in self.convs[:-1]:
            x = F.relu(conv(x))
        return self.convs[-1](x)


class OpenPoseBody(nn.Module):
    """NHWC image (normalized) → (paf, heatmap) at stride 8."""

    config_class = OpenPoseConfig

    def __init__(self, cfg: OpenPoseConfig = OpenPoseConfig()):
        super().__init__()
        self.cfg = cfg
        w = cfg.trunk_width
        c = lambda n: max(1, int(n * w))  # noqa: E731
        self.trunk = nn.ModuleList([Conv(3 if cin == 3 else c(cin), c(cout), k)
                                    for _, cin, cout, k in (s for s in _TRUNK if s[0] != "pool")])
        self.stage1_l1 = _Stage1Branch(N_PAF, w)
        self.stage1_l2 = _Stage1Branch(N_HEAT, w)
        feat = c(128) + N_PAF + N_HEAT
        self.refine_l1 = nn.ModuleList([_RefineBranch(feat, N_PAF, w) for _ in range(cfg.stages - 1)])
        self.refine_l2 = nn.ModuleList([_RefineBranch(feat, N_HEAT, w) for _ in range(cfg.stages - 1)])

    def forward(self, x):
        ci = 0
        for spec in _TRUNK:
            if spec[0] == "pool":  # reduce_window(max, 2x2, VALID)
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            else:
                x = F.relu(self.trunk[ci](x))
                ci += 1
        feat = x
        paf = self.stage1_l1(feat)
        heat = self.stage1_l2(feat)
        for l1, l2 in zip(self.refine_l1, self.refine_l2):
            z = torch.cat([paf, heat, feat], dim=-1)
            paf, heat = l1(z), l2(z)
        if self.cfg.stages == 6:
            # Reference quirk (open_pose/model.py:34-46), kept by the JAX
            # module: the deployed torch model ReLUs the final heatmap.
            heat = F.relu(heat)
        return paf, heat


def convert_openpose_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Published ``body_pose_model.pth`` keys → model paths. Layer names
    (conv1_1, Mconv3_stage4_L2, …) are globally unique, so the torch module
    prefix (model0./model4_1. …) is ignored."""
    trunk_order = [s[0] for s in _TRUNK if s[0] != "pool"]
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        parts = k.split(".")
        if len(parts) < 2:
            continue
        layer, leaf = parts[-2], parts[-1]
        tgt = "kernel" if leaf == "weight" else "bias"
        if layer in trunk_order:
            out[f"trunk.{trunk_order.index(layer)}.{tgt}"] = v
        elif layer.startswith("conv5_") and "_CPM_L" in layer:
            i = int(layer.split("_")[1]) - 1  # conv5_1..conv5_5
            br = "stage1_l1" if layer.endswith("L1") else "stage1_l2"
            out[f"{br}.convs.{i}.{tgt}"] = v
        elif layer.startswith("Mconv"):
            i = int(layer[5:].split("_")[0]) - 1  # Mconv1..Mconv7
            stage = int(layer.split("_stage")[1].split("_")[0])  # 2..6
            br = "refine_l1" if layer.endswith("L1") else "refine_l2"
            out[f"{br}.{stage - 2}.convs.{i}.{tgt}"] = v
    return out


# -------- decoding (host numpy) --------------------------------------------------------

# limb connections (0-indexed part pairs) and their PAF channel pairs
LIMB_SEQ = [(1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
            (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
            (0, 15), (15, 17), (2, 16), (5, 17)]
PAF_IDX = [(12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25), (0, 1),
           (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (28, 29), (30, 31),
           (34, 35), (32, 33), (36, 37), (18, 19), (26, 27)]
COLORS = [(255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
          (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
          (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
          (255, 0, 255), (255, 0, 170), (255, 0, 85)]


def find_peaks(heat: np.ndarray, thresh: float = 0.1) -> List[List[Tuple[int, int, float]]]:
    """Per-part local maxima above ``thresh`` → [(x, y, score)] per part."""
    try:
        import cv2

        smooth = np.stack([cv2.GaussianBlur(heat[..., i], (0, 0), 3)
                           for i in range(heat.shape[-1])], axis=-1)
    except ImportError:  # pragma: no cover
        smooth = heat
    peaks = []
    for i in range(min(heat.shape[-1], 18)):  # channel 18 is background
        h = smooth[..., i]
        m = (h >= np.roll(h, 1, 0)) & (h >= np.roll(h, -1, 0)) & \
            (h >= np.roll(h, 1, 1)) & (h >= np.roll(h, -1, 1)) & (h > thresh)
        m[0, :] = m[-1, :] = False
        m[:, 0] = m[:, -1] = False
        ys, xs = np.nonzero(m)
        peaks.append([(int(x), int(y), float(heat[y, x, i])) for x, y in zip(xs, ys)])
    return peaks


def score_connection(paf_x: np.ndarray, paf_y: np.ndarray,
                     a: Tuple[int, int], b: Tuple[int, int],
                     n_samples: int = 10, thresh: float = 0.05) -> Optional[float]:
    """Average PAF alignment along the a→b segment; None when the limb
    evidence fails the 80%-of-samples criterion."""
    ax, ay = a
    bx, by = b
    dx, dy = bx - ax, by - ay
    norm = math.hypot(dx, dy)
    if norm < 1e-6:
        return None
    ux, uy = dx / norm, dy / norm
    xs = np.clip(np.round(np.linspace(ax, bx, n_samples)).astype(int), 0, paf_x.shape[1] - 1)
    ys = np.clip(np.round(np.linspace(ay, by, n_samples)).astype(int), 0, paf_x.shape[0] - 1)
    scores = paf_x[ys, xs] * ux + paf_y[ys, xs] * uy
    if (scores > thresh).sum() < 0.8 * n_samples:
        return None
    prior = min(0.5 * paf_x.shape[0] / norm - 1, 0)
    return float(scores.mean() + prior)


def assemble_people(peaks, paf: np.ndarray) -> List[Dict[int, Tuple[int, int]]]:
    """Greedy limb-by-limb grouping of part candidates into skeletons."""
    people: List[Dict[int, Tuple[int, int, int]]] = []  # part → (x, y, peak_uid)
    uid = {}
    c = 0
    for pi, plist in enumerate(peaks):
        for j, p in enumerate(plist):
            uid[(pi, j)] = c
            c += 1
    for limb, (cx, cy) in zip(LIMB_SEQ, PAF_IDX):
        pa, pb = limb
        cand = []
        for i, a in enumerate(peaks[pa]):
            for j, b in enumerate(peaks[pb]):
                s = score_connection(paf[..., cx], paf[..., cy], a[:2], b[:2])
                if s is not None:
                    cand.append((s + 0.5 * (a[2] + b[2]), i, j))
        cand.sort(reverse=True)
        used_a, used_b = set(), set()
        for s, i, j in cand:
            if i in used_a or j in used_b:
                continue
            used_a.add(i)
            used_b.add(j)
            ida = uid[(pa, i)]
            placed = False
            for person in people:
                if person.get(pa, (None, None, None))[2] == ida:
                    person[pb] = (*peaks[pb][j][:2], uid[(pb, j)])
                    placed = True
                    break
            if not placed:
                people.append({
                    pa: (*peaks[pa][i][:2], ida),
                    pb: (*peaks[pb][j][:2], uid[(pb, j)]),
                })
    # drop skeletons with fewer than 3 parts (noise)
    return [{k: v[:2] for k, v in p.items()} for p in people if len(p) >= 3]


def render_pose(people, h: int, w: int, stickwidth: int = 4) -> np.ndarray:
    """Classic openpose stick-figure on black, HWC uint8 RGB."""
    canvas = np.zeros((h, w, 3), np.uint8)
    try:
        import cv2
    except ImportError:  # pragma: no cover
        return canvas
    for person in people:
        for li, (pa, pb) in enumerate(LIMB_SEQ):
            if pa not in person or pb not in person:
                continue
            ax, ay = person[pa]
            bx, by = person[pb]
            mx, my = (ax + bx) / 2, (ay + by) / 2
            length = math.hypot(ax - bx, ay - by)
            angle = math.degrees(math.atan2(ay - by, ax - bx))
            poly = cv2.ellipse2Poly((int(mx), int(my)), (int(length / 2), stickwidth),
                                    int(angle), 0, 360, 1)
            cv2.fillConvexPoly(canvas, poly, COLORS[li % len(COLORS)])
        for pi, (x, y) in person.items():
            cv2.circle(canvas, (int(x), int(y)), stickwidth, COLORS[pi % len(COLORS)], -1)
    return canvas


@preprocessor_registry.register("openpose", aliases=("open_pose", "OpenposeDetector"))
class OpenPosePreprocessor(BasePreprocessor):
    """Body pose stick-figure map. Params: ``detect_resolution`` (default 368),
    ``stickwidth``. Weights: ``body_pose_model.pth`` in the preprocessor
    models dir (published with the ControlNet annotators)."""

    name = "openpose"
    params_schema = {"detect_resolution": 368, "stickwidth": 4}

    def __init__(self, model: Optional[OpenPoseBody] = None):
        self._model = model

    def setup(self) -> None:
        if self._model is None:
            from apex_studio_tpu_torch.preprocess.weights import load_detector

            self._model = load_detector(lambda: OpenPoseBody(OpenPoseConfig()), "body_pose_model",
                                        "body_pose_model.pth", convert_openpose_keys, self.device)

    def maps(self, frame: np.ndarray, resolution: int = 368):
        """(paf, heat) at the frame's size, HWC f32 numpy."""
        h, w = frame.shape[:2]
        scale = resolution / min(h, w)
        th = max(16, int(round(h * scale / 8)) * 8)
        tw = max(16, int(round(w * scale / 8)) * 8)
        dev = next(self._model.parameters()).device
        x = jax_resize(torch.from_numpy(frame).to(dev).float(), (th, tw, 3), "bilinear")
        x = x / 256.0 - 0.5  # caffe-era normalization the checkpoint expects
        paf, heat = self._model(x[None])
        return (resize_bilinear_ac(paf, h, w)[0].float().cpu().numpy(),
                resize_bilinear_ac(heat, h, w)[0].float().cpu().numpy())

    @torch.no_grad()
    def process_frame(self, frame: np.ndarray, **params) -> np.ndarray:
        h, w = frame.shape[:2]
        paf, heat = self.maps(frame, int(params.get("detect_resolution", 368) or 368))
        people = assemble_people(find_peaks(heat), paf)
        return render_pose(people, h, w, int(params.get("stickwidth", 4)))


# editor alias (reference pose panel name)
preprocessor_registry.register("pose")(OpenPosePreprocessor)
