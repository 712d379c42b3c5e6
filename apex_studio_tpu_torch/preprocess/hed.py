"""HED soft edges, ControlNet's HED (port of ``apex_studio_tpu/preprocess/hed.py``):
a 5-stage VGG-style conv stack with a 1-channel projection per stage, NHWC at
every function as in the JAX module and with its attribute names
(``loaders/from_jax.py`` carries its parameters); the published
``ControlNetHED.pth`` loads through ``convert_hed_keys`` strictly.

The network runs in f32 on ``device`` (``None`` is the card) on the frame
edge-padded to a multiple of 16; the five maps come back to the host, where
cv2 resizes them, they are averaged in float64 and squashed by a sigmoid, as
in JAX. ``safe`` quantizes the edge ramp; ``scribble`` (and
``scribble_hed``) turns it into a binary sketch through ``nms_sketch``, a
blur and a threshold.

Departure: the JAX preprocessor runs random weights where it finds no
checkpoint and loads by shape what it finds; here a missing checkpoint raises
``FileNotFoundError`` and the load is strict.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_anything import Conv
from apex_studio_tpu_torch.preprocess.teed import mean_sigmoid


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """``nnx.max_pool(x, (2, 2), strides=(2, 2))`` on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class _DoubleConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int):
        super().__init__()
        self.convs = nn.ModuleList([Conv(cin if i == 0 else cout, cout, 3, padding=1) for i in range(layers)])
        self.projection = Conv(cout, 1, 1, padding=0)

    def forward(self, x, down_sampling: bool = False):
        if down_sampling:
            x = max_pool_2x2(x)
        for conv in self.convs:
            x = F.relu(conv(x))
        return x, self.projection(x)


class ControlNetHED(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm = nn.Parameter(torch.zeros(1, 1, 1, 3))
        self.block1 = _DoubleConvBlock(3, 64, 2)
        self.block2 = _DoubleConvBlock(64, 128, 2)
        self.block3 = _DoubleConvBlock(128, 256, 3)
        self.block4 = _DoubleConvBlock(256, 512, 3)
        self.block5 = _DoubleConvBlock(512, 512, 3)

    def forward(self, x):  # NHWC raw-pixel-range input
        h = x - self.norm
        h, p1 = self.block1(h)
        h, p2 = self.block2(h, down_sampling=True)
        h, p3 = self.block3(h, down_sampling=True)
        h, p4 = self.block4(h, down_sampling=True)
        h, p5 = self.block5(h, down_sampling=True)
        return p1, p2, p3, p4, p5


def convert_hed_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """ControlNetHED.pth keys → the module's paths (JAX leaf names, torch
    layouts): ``norm`` [1, 3, 1, 1] as its NHWC [1, 1, 1, 3]."""
    out = {}
    for k, v in sd.items():
        if k == "norm":
            out["norm"] = v.reshape(1, 1, 1, 3)
        elif k.endswith(".weight") and v.ndim == 4:
            out[k[: -len("weight")] + "kernel"] = v
        else:
            out[k] = v
    return out


def nms_sketch(x: np.ndarray, t: int, s: float) -> np.ndarray:
    """Directional dilation NMS (reference preprocess/util.py:98)."""
    import cv2

    x = cv2.GaussianBlur(x.astype(np.float32), (0, 0), s)
    kernels = [np.array(k, np.uint8) for k in (
        [[0, 0, 0], [1, 1, 1], [0, 0, 0]],
        [[0, 1, 0], [0, 1, 0], [0, 1, 0]],
        [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
        [[0, 0, 1], [0, 1, 0], [1, 0, 0]])]
    y = np.zeros_like(x)
    for f in kernels:
        np.putmask(y, cv2.dilate(x, kernel=f) == x, x)
    z = np.zeros_like(y, dtype=np.uint8)
    z[y > t] = 255
    return z


def edge_to_frame(edge: np.ndarray, safe: bool, scribble: bool) -> Frame:
    """A [0, 1] edge map → the HWC uint8 frame HED and PiDiNet return:
    ``safe`` quantizes the ramp (util.safe_step), ``scribble`` makes the
    binary sketch."""
    import cv2

    if safe:
        edge = (edge * 3.0).astype(np.int32).astype(np.float32) / 2.0
    out = (edge * 255.0).clip(0, 255).astype(np.uint8)
    if scribble:
        out = nms_sketch(out, 127, 3.0)
        out = cv2.GaussianBlur(out, (0, 0), 3.0)
        out = np.where(out > 4, 255, 0).astype(np.uint8)
    return np.repeat(out[:, :, None], 3, axis=2)


@preprocessor_registry.register("hed", aliases=("softedge_hed", "softedge"))
class HEDPreprocessor(BasePreprocessor):
    """Soft edge map. Weights: ``ControlNetHED.pth`` in the preprocessor
    models dir."""

    name = "hed"
    params_schema = {"safe": False, "scribble": False}

    def __init__(self, model: Optional[ControlNetHED] = None):
        self.model = model

    def setup(self) -> None:
        if self.model is None:
            from apex_studio_tpu_torch.preprocess.weights import load_detector

            self.model = load_detector(ControlNetHED, "hed", "ControlNetHED.pth", convert_hed_keys, self.device)

    def edge(self, frame: Frame) -> np.ndarray:
        """The float64 edge map at the frame's size, before ``safe`` and
        ``scribble``."""
        h, w = frame.shape[:2]
        # pad to /16 so the four maxpools stay aligned
        x = np.pad(frame, ((0, (-h) % 16), (0, (-w) % 16), (0, 0)), mode="edge")
        dev = next(self.model.parameters()).device
        with torch.no_grad():
            maps = self.model(torch.from_numpy(x.astype(np.float32))[None].to(dev))
        return mean_sigmoid(maps, h, w)

    def process_frame(self, frame: Frame, safe: bool = False, scribble: bool = False, **_: Any) -> Frame:
        return edge_to_frame(self.edge(frame), safe, scribble)


@preprocessor_registry.register("scribble_hed")
class ScribbleHEDPreprocessor(HEDPreprocessor):
    name = "scribble_hed"

    def process_frame(self, frame: Frame, **kw: Any) -> Frame:
        kw["scribble"] = True
        return super().process_frame(frame, **kw)
