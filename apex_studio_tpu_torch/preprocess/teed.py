"""TEED, the Tiny and Efficient Edge Detector (port of
``apex_studio_tpu/preprocess/teed.py``): a ~58K-parameter three-block edge
net with smish activations, three upsampling heads and a depthwise
double-fusion head, NHWC at every function as in the JAX module and with its
attribute names (``loaders/from_jax.py`` carries its parameters); the
published ``7_model.pth`` loads through ``convert_teed_keys`` strictly.

Raw 0-255 RGB goes in. The network runs in f32 on ``device`` (``None`` is
the card), its transposed convolutions with cuDNN's deterministic algorithms;
the four maps come back to the host, where cv2 resizes them, they are
averaged, squashed by a sigmoid and quantized by ``safe_steps``, as in JAX.
Departure: a missing checkpoint raises ``FileNotFoundError`` and the load is
strict, where the JAX preprocessor runs random weights or loads by shape.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.device import cudnn_deterministic
from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_anything import Conv, _lecun, conv2d_nhwc


def smish(x):
    """x * tanh(log(1 + sigmoid(x))) (teed/Fsmish.py)."""
    return x * torch.tanh(torch.log1p(torch.sigmoid(x)))


def mean_sigmoid(maps, h: int, w: int) -> np.ndarray:
    """Side maps (each [1, h', w', 1] on the device) → cv2-resized to the
    frame, averaged in float64 and squashed by a sigmoid, on the host."""
    import cv2

    resized = [cv2.resize(m[0, :, :, 0].cpu().numpy(), (w, h), interpolation=cv2.INTER_LINEAR) for m in maps]
    return 1.0 / (1.0 + np.exp(-np.mean(np.stack(resized, 2), axis=2, dtype=np.float64)))


class _Deconv(nn.Module):
    """ConvTranspose2d(k, stride=2, padding=p): ``weight`` [in, out, k, k];
    the JAX module keeps it as an unflipped HWIO ``w`` (``jax_w_flipped``)."""

    jax_w_flipped = False

    def __init__(self, cin: int, cout: int, k: int, p: int):
        super().__init__()
        self.weight = _lecun(cin, cout, k, k, fan_in=k * k * cin)
        self.bias = nn.Parameter(torch.zeros(cout))
        self.p = p

    def forward(self, x):
        with cudnn_deterministic():
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias, stride=2, padding=self.p)
        return y.permute(0, 2, 3, 1)


class _DWConv(nn.Module):
    """Depthwise 3x3 conv (groups == cin), ``weight`` [cin·mult, 1, 3, 3]."""

    def __init__(self, cin: int, mult: int):
        super().__init__()
        self.weight = _lecun(cin * mult, 1, 3, 3, fan_in=9)
        self.bias = nn.Parameter(torch.zeros(cin * mult))
        self.groups = cin

    def forward(self, x):
        return conv2d_nhwc(x, self.weight, self.bias, 1, 1, groups=self.groups)


class _DoubleConvBlock(nn.Module):
    def __init__(self, cin, mid, cout=None, stride=1, use_act=True):
        super().__init__()
        cout = mid if cout is None else cout
        self.conv1 = Conv(cin, mid, 3, stride=stride, padding=1)
        self.conv2 = Conv(mid, cout, 3, padding=1)
        self.use_act = use_act

    def forward(self, x):
        x = self.conv2(smish(self.conv1(x)))
        return smish(x) if self.use_act else x


class _DenseLayer(nn.Module):
    """conv(3x3, pad 2) → smish → conv(3x3, valid); returns
    0.5 * (new + skip) (ted.py:101)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, padding=2)
        self.conv2 = Conv(cout, cout, 3, padding=0)

    def forward(self, x, skip):
        return 0.5 * (self.conv2(smish(self.conv1(smish(x)))) + skip)


class _UpBlock1(nn.Module):
    """UpConvBlock(up_scale=1): 1x1 conv → smish → deconv k2 s2 p0."""

    def __init__(self, cin):
        super().__init__()
        self.conv = Conv(cin, 1, 1, padding=0)
        self.deconv = _Deconv(1, 1, 2, 0)

    def forward(self, x):
        return self.deconv(smish(self.conv(x)))


class _UpBlock2(nn.Module):
    """UpConvBlock(up_scale=2): two rounds of 1x1 conv → smish → deconv k4
    s2 p1 (16 intermediate features)."""

    def __init__(self, cin):
        super().__init__()
        self.conv_a = Conv(cin, 16, 1, padding=0)
        self.deconv_a = _Deconv(16, 16, 4, 1)
        self.conv_b = Conv(16, 1, 1, padding=0)
        self.deconv_b = _Deconv(1, 1, 4, 1)

    def forward(self, x):
        x = self.deconv_a(smish(self.conv_a(x)))
        return self.deconv_b(smish(self.conv_b(x)))


class _DoubleFusion(nn.Module):
    """Depthwise attention fusion (ted.py:73): dw 3→24, dw 24→24, channel
    sum, smish."""

    def __init__(self):
        super().__init__()
        self.dwconv1 = _DWConv(3, 8)
        self.dwconv2 = _DWConv(24, 1)

    def forward(self, x):
        attn = self.dwconv1(smish(x))
        attn2 = self.dwconv2(smish(attn))
        return smish(torch.sum(attn2 + attn, dim=-1, keepdim=True))


class TED(nn.Module):
    """ted.py:212 TED — NHWC raw-pixel input, returns 4 edge logit maps."""

    def __init__(self):
        super().__init__()
        self.block_1 = _DoubleConvBlock(3, 16, 16, stride=2)
        self.block_2 = _DoubleConvBlock(16, 32, use_act=False)
        self.dblock_3 = _DenseLayer(32, 48)
        self.side_1 = Conv(16, 32, 1, stride=2, padding=0)
        self.pre_dense_3 = Conv(32, 48, 1, padding=0)
        self.up_block_1 = _UpBlock1(16)
        self.up_block_2 = _UpBlock1(32)
        self.up_block_3 = _UpBlock2(48)
        self.block_cat = _DoubleFusion()

    def forward(self, x):
        b1 = self.block_1(x)                         # H/2, 16
        b1_side = self.side_1(b1)                    # H/4, 32
        b2 = self.block_2(b1)                        # H/2, 32
        b2_down = F.max_pool2d(b2.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
        b2_add = b2_down + b1_side                   # H/4, 32
        b3 = self.dblock_3(b2_add, self.pre_dense_3(b2_down))  # H/4, 48
        o1 = self.up_block_1(b1)
        o2 = self.up_block_2(b2)
        o3 = self.up_block_3(b3)
        fused = self.block_cat(torch.cat([o1, o2, o3], dim=-1))
        return o1, o2, o3, fused


_RENAMES = {
    "dblock_3.denselayer1.": "dblock_3.",
    "side_1.conv.": "side_1.",
    "pre_dense_3.conv.": "pre_dense_3.",
    "up_block_1.features.0.": "up_block_1.conv.",
    "up_block_1.features.2.": "up_block_1.deconv.",
    "up_block_2.features.0.": "up_block_2.conv.",
    "up_block_2.features.2.": "up_block_2.deconv.",
    "up_block_3.features.0.": "up_block_3.conv_a.",
    "up_block_3.features.2.": "up_block_3.deconv_a.",
    "up_block_3.features.3.": "up_block_3.conv_b.",
    "up_block_3.features.5.": "up_block_3.deconv_b.",
    "block_cat.DWconv1.": "block_cat.dwconv1.",
    "block_cat.DWconv2.": "block_cat.dwconv2.",
}


def convert_teed_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """7_model.pth keys → the module's paths (JAX leaf names, torch layouts;
    a transposed conv's weight under the port's name)."""
    out = {}
    for k, v in sd.items():
        for old, new in _RENAMES.items():
            if k.startswith(old):
                k = new + k[len(old):]
                break
        if k.endswith(".weight") and v.ndim == 4 and ".deconv" not in k:
            k = k[: -len("weight")] + "kernel"
        out[k] = v
    return out


@preprocessor_registry.register("teed", aliases=("softedge_teed", "ted"))
class TEEDPreprocessor(BasePreprocessor):
    """Soft edge map. Weights: ``7_model.pth`` (published as
    ``Annotators/7_model.pth``) in the preprocessor models dir."""

    name = "teed"
    params_schema = {"safe_steps": 2}

    def __init__(self, model: Optional[TED] = None):
        self.model = model

    def setup(self) -> None:
        if self.model is None:
            from apex_studio_tpu_torch.preprocess.weights import load_detector

            self.model = load_detector(TED, "teed", "Annotators/7_model.pth", convert_teed_keys, self.device)

    def edge(self, frame: Frame) -> np.ndarray:
        """The float64 edge map at the frame's size, before ``safe_steps``."""
        h, w = frame.shape[:2]
        x = np.pad(frame, ((0, (-h) % 8), (0, (-w) % 8), (0, 0)), mode="edge")
        dev = next(self.model.parameters()).device
        with torch.no_grad():
            maps = self.model(torch.from_numpy(x.astype(np.float32))[None].to(dev))
        return mean_sigmoid(maps, h, w)

    def process_frame(self, frame: Frame, safe_steps: int = 2, **_: Any) -> Frame:
        edge = self.edge(frame)
        if safe_steps:
            edge = (edge.astype(np.float32) * (safe_steps + 1)).astype(np.int32).astype(np.float32) / safe_steps
        out = (edge * 255.0).clip(0, 255).astype(np.uint8)
        return np.repeat(out[:, :, None], 3, axis=2)
