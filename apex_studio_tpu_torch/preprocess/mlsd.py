"""M-LSD line segments, MobileV2_MLSD_Large (port of
``apex_studio_tpu/preprocess/mlsd.py``): a truncated MobileNetV2 trunk (14
features, TFLite-style stride-2 padding of one row and column at the bottom
and right) feeding an FPN of A / B blocks up to ¼ of the input and a dilated
C head; NHWC at every function as in the JAX module and with its attribute
names (``loaders/from_jax.py`` carries its parameters). The published
``mlsd_large_512_fp32.pth`` loads through ``convert_mlsd_keys`` strictly.

The network runs in f32 on ``device`` (``None`` is the card); the line decode
(``decode_lines``: sigmoid centre heat, 3×3 local-max NMS, top 200, start /
end displacements over the score and length thresholds) and the drawing stay
in numpy and OpenCV on the host, copied from the JAX module. Departure: a
missing checkpoint raises ``FileNotFoundError``, where the JAX preprocessor
runs random weights.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_anything import _bn, _bn_params, _lecun, conv2d_nhwc


class _ConvBNReLU6(nn.Module):
    """ConvBNReLU (mbv2_mlsd_large.py:96): TFLite padding — stride 2 pads
    (0,1,0,1) explicitly, stride 1 pads symmetrically; ReLU6. ``tf_pad=False``
    pads symmetrically at every stride (torchvision's MobileNetV2, the anime
    face U-Net's trunk)."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1, groups: int = 1,
                 tf_pad: bool = True):
        super().__init__()
        self.weight = _lecun(cout, cin // groups, k, k, fan_in=cin // groups * k * k)
        _bn_params(self, cout)
        self.k, self.stride, self.groups, self.tf_pad = k, stride, groups, tf_pad

    def forward(self, x):
        pad = ((0, 1), (0, 1)) if self.stride == 2 and self.tf_pad else (self.k - 1) // 2
        y = conv2d_nhwc(x, self.weight, None, self.stride, pad, groups=self.groups)
        return torch.clamp(_bn(self, y), 0.0, 6.0)


class _ConvBN(nn.Module):
    """1×1 pointwise-linear conv + eval BN (no activation)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = _lecun(cout, cin, 1, 1, fan_in=cin)
        _bn_params(self, cout)

    def forward(self, x):
        return _bn(self, conv2d_nhwc(x, self.weight))


class _InvertedResidual(nn.Module):
    """mbv2_mlsd_large.py:132 — pw-expand → dw → pw-linear, skip on s1."""

    def __init__(self, cin: int, cout: int, stride: int, expand: int, tf_pad: bool = True):
        super().__init__()
        hidden = int(round(cin * expand))
        self.expand = None if expand == 1 else _ConvBNReLU6(cin, hidden, 1)
        self.dw = _ConvBNReLU6(hidden, hidden, 3, stride, groups=hidden, tf_pad=tf_pad)
        self.pw = _ConvBN(hidden, cout)
        self.use_res = stride == 1 and cin == cout

    def forward(self, x):
        h = x if self.expand is None else self.expand(x)
        h = self.pw(self.dw(h))
        return x + h if self.use_res else h


class _ConvBnRelu(nn.Module):
    """Plain conv (biased) + eval BN + ReLU used by the FPN blocks."""

    def __init__(self, cin: int, cout: int, k: int, pad: int = 0, dilation: int = 1):
        super().__init__()
        self.weight = _lecun(cout, cin, k, k, fan_in=cin * k * k)
        self.bias = nn.Parameter(torch.zeros(cout))
        _bn_params(self, cout)
        self.pad, self.dilation = pad, dilation

    def forward(self, x):
        return F.relu(_bn(self, conv2d_nhwc(x, self.weight, self.bias, 1, self.pad, self.dilation)))


def _resize_align_corners(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear, align_corners=True, written as the JAX module writes it."""
    _, h, w, _ = x.shape
    dev = x.device
    ys = torch.linspace(0.0, h - 1.0, oh, device=dev)
    xs = torch.linspace(0.0, w - 1.0, ow, device=dev)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = (y0 + 1).clamp_max(h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    fy = (ys - y0)[None, :, None, None]
    fx = (xs - x0)[None, None, :, None]
    a = x[:, y0][:, :, x0]
    b = x[:, y0][:, :, x1]
    c = x[:, y1][:, :, x0]
    d = x[:, y1][:, :, x1]
    return a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx) + d * fy * fx


def _up2(x: torch.Tensor) -> torch.Tensor:
    """F.interpolate scale 2 bilinear align_corners=True."""
    return _resize_align_corners(x, 2 * x.shape[1], 2 * x.shape[2])


class _BlockA(nn.Module):
    """mbv2_mlsd_large.py:9 — 1×1 conv both inputs, optional ×2 up, concat."""

    def __init__(self, in1: int, in2: int, out1: int, out2: int, upscale: bool = True):
        super().__init__()
        self.conv1 = _ConvBnRelu(in2, out2, 1)
        self.conv2 = _ConvBnRelu(in1, out1, 1)
        self.upscale = upscale

    def forward(self, a, b):
        b = self.conv1(b)
        a = self.conv2(a)
        if self.upscale:
            b = _up2(b)
        return torch.cat([a, b], dim=-1)


class _BlockB(nn.Module):
    """mbv2_mlsd_large.py:32 — residual 3×3 then 3×3 projection."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = _ConvBnRelu(cin, cin, 3, pad=1)
        self.conv2 = _ConvBnRelu(cin, cout, 3, pad=1)

    def forward(self, x):
        return self.conv2(self.conv1(x) + x)


class _BlockC(nn.Module):
    """mbv2_mlsd_large.py:52 — dilated 3×3, 3×3, 1×1 head (plain conv)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = _ConvBnRelu(cin, cin, 3, pad=5, dilation=5)
        self.conv2 = _ConvBnRelu(cin, cin, 3, pad=1)
        self.conv3_weight = _lecun(cout, cin, 1, 1, fan_in=cin)
        self.conv3_bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return conv2d_nhwc(self.conv2(self.conv1(x)), self.conv3_weight, self.conv3_bias)


# (expand, cout, n, stride) — truncated MobileNetV2 (mbv2_mlsd_large.py:184)
_MBV2_SETTING = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1)]
_FPN_SELECTED = (1, 3, 6, 10, 13)


class MLSDModel(nn.Module):
    """MobileV2_MLSD_Large. NHWC 4-channel (RGB + ones) ±1 input →
    [B, h/2, w/2, 9] tpMap (center heat + 4 displacement + aux)."""

    def __init__(self):
        super().__init__()
        feats = [_ConvBNReLU6(4, 32, 3, 2)]
        cin = 32
        for expand, cout, n, s in _MBV2_SETTING:
            for i in range(n):
                feats.append(_InvertedResidual(cin, cout, s if i == 0 else 1, expand))
                cin = cout
        self.features = nn.ModuleList(feats)
        self.block15 = _BlockA(64, 96, 64, 64, upscale=False)
        self.block16 = _BlockB(128, 64)
        self.block17 = _BlockA(32, 64, 64, 64)
        self.block18 = _BlockB(128, 64)
        self.block19 = _BlockA(24, 64, 64, 64)
        self.block20 = _BlockB(128, 64)
        self.block21 = _BlockA(16, 64, 64, 64)
        self.block22 = _BlockB(128, 64)
        self.block23 = _BlockC(64, 16)

    def forward(self, x):
        fpn = []
        for i, f in enumerate(self.features):
            x = f(x)
            if i in _FPN_SELECTED:
                fpn.append(x)
        c1, c2, c3, c4, c5 = fpn
        x = self.block16(self.block15(c4, c5))
        x = self.block18(self.block17(c3, x))
        x = self.block20(self.block19(c2, x))
        x = self.block22(self.block21(c1, x))
        return self.block23(x)[..., 7:]


def _published_blocks():
    """(port prefix, published prefix, has_expand) of each trunk feature
    after the stem: ``features.{i}`` → ``backbone.features.{i}.conv``."""
    idx = 1
    for expand, _, n, _ in _MBV2_SETTING:
        for _ in range(n):
            yield f"features.{idx}", f"backbone.features.{idx}.conv", expand != 1
            idx += 1


def convert_mlsd_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """mlsd_large_512_fp32.pth (torch MobileV2_MLSD_Large) state dict → the
    module's paths (JAX leaf names, torch layouts)."""
    out = {}

    def put_conv(t, j, biased=False):
        out[f"{j}.kernel"] = sd[f"{t}.weight"]
        if biased and f"{t}.bias" in sd:
            out[f"{j}.bias"] = sd[f"{t}.bias"]

    def put_bn(t, j):
        for ours, theirs in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"), ("var", "running_var")):
            out[f"{j}.bn_{ours}"] = sd[f"{t}.{theirs}"]

    # features.0 is a bare ConvBNReLU; the rest are InvertedResiduals
    put_conv("backbone.features.0.0", "features.0")
    put_bn("backbone.features.0.1", "features.0")
    for j, t, has_expand in _published_blocks():
        li = 0
        if has_expand:
            put_conv(f"{t}.0.0", f"{j}.expand")
            put_bn(f"{t}.0.1", f"{j}.expand")
            li = 1
        put_conv(f"{t}.{li}.0", f"{j}.dw")
        put_bn(f"{t}.{li}.1", f"{j}.dw")
        put_conv(f"{t}.{li + 1}", f"{j}.pw")
        put_bn(f"{t}.{li + 2}", f"{j}.pw")
    for blk in range(15, 24):
        for c in (1, 2):
            put_conv(f"block{blk}.conv{c}.0", f"block{blk}.conv{c}", biased=True)
            put_bn(f"block{blk}.conv{c}.1", f"block{blk}.conv{c}")
    out["block23.conv3_kernel"] = sd["block23.conv3.weight"]
    out["block23.conv3_bias"] = sd["block23.conv3.bias"]
    return out


def decode_lines(tpmap: np.ndarray, score_thr: float = 0.10, dist_thr: float = 20.0, topk: int = 200,
                 ksize: int = 3) -> np.ndarray:
    """utils.py:19 + utils.py:49 — center heat NMS + displacement decode.
    tpmap: [h, w, 9] (channel 0 center, 1:5 displacement). Returns
    [N, 4] (x0, y0, x1, y1) at 2× the map resolution."""
    from scipy.ndimage import maximum_filter

    center = tpmap[..., 0]
    heat = 1.0 / (1.0 + np.exp(-center))
    hmax = maximum_filter(heat, size=ksize, mode="constant")
    heat = np.where(hmax == heat, heat, 0.0).reshape(-1)
    h, w = center.shape
    order = np.argsort(heat)[::-1][:topk]
    scores = heat[order]
    yy, xx = order // w, order % w
    disp = tpmap[..., 1:5]
    start = disp[..., :2]
    end = disp[..., 2:]
    dist = np.sqrt(((start - end) ** 2).sum(-1))
    segs = []
    for y, x, s in zip(yy, xx, scores):
        if s > score_thr and dist[y, x] > dist_thr:
            dx0, dy0, dx1, dy1 = disp[y, x]
            segs.append([x + dx0, y + dy0, x + dx1, y + dy1])
    if not segs:
        return np.zeros((0, 4), np.float32)
    return 2.0 * np.asarray(segs, np.float32)


@preprocessor_registry.register("mlsd", aliases=("MLSDdetector",))
class MLSDPreprocessor(BasePreprocessor):
    """Wireframe line map (reference src/preprocess/mlsd/__init__.py:23).
    Weights: ``mlsd_large_512_fp32.pth`` in the preprocessor models dir."""

    name = "mlsd"
    params_schema = {"thr_v": 0.1, "thr_d": 0.1, "detect_resolution": 512}

    def __init__(self, model: Optional[MLSDModel] = None):
        self.model = model

    def setup(self) -> None:
        if self.model is None:
            from apex_studio_tpu_torch.preprocess.weights import load_detector

            self.model = load_detector(MLSDModel, "mlsd", "mlsd_large_512_fp32.pth", convert_mlsd_keys,
                                       self.device)

    def tpmap(self, frame: Frame, detect_resolution: int = 512) -> np.ndarray:
        """The [size/2, size/2, 9] map the decode reads."""
        import cv2

        size = int(detect_resolution)
        img = cv2.resize(frame, (size, size), interpolation=cv2.INTER_AREA)
        x = np.concatenate([img.astype(np.float32), np.ones((size, size, 1), np.float32)], axis=-1)
        x = x / 127.5 - 1.0
        dev = next(self.model.parameters()).device
        with torch.no_grad():
            return self.model(torch.from_numpy(x)[None].to(dev))[0].cpu().numpy()

    def process_frame(self, frame: Frame, thr_v: float = 0.1, thr_d: float = 0.1, detect_resolution: int = 512,
                      **_) -> Frame:
        import cv2

        h, w = frame.shape[:2]
        size = int(detect_resolution)
        # the reference passes thr_d straight through as the map-pixel
        # distance threshold (mlsd/__init__.py:72 → utils.py:49 dist_thr)
        lines = decode_lines(self.tpmap(frame, size), score_thr=thr_v, dist_thr=thr_d)
        out = np.zeros((size, size, 3), np.uint8)
        for x0, y0, x1, y1 in lines:
            cv2.line(out, (int(x0), int(y0)), (int(x1), int(y1)), (255, 255, 255), 1)
        return cv2.resize(out, (w, h), interpolation=cv2.INTER_NEAREST)
