"""LeReS relative depth, AdelaiDepth res101 (port of
``apex_studio_tpu/preprocess/leres.py``): a ResNeXt101-32x8d encoder and the
FTB / FFM / AO fusion decoder, NHWC at every function as in the JAX module
and with its attribute names (``loaders/from_jax.py`` carries its
parameters), rendered as the reference does (16-bit normalise → 8-bit →
invert). The ``boost`` path is not in the JAX module either.

Quirk kept from JAX: FTB's ``conv_branch`` opens with an in-place ReLU, so
the skip adds ``relu(conv1(x))``.

Checkpoint: ``res101.pth`` → ``checkpoint["depth_model"]`` with ``module.``
prefixes, through ``convert_leres_keys`` strictly; the BatchNorms are the
inference affine of their running statistics (torch eps 1e-5). The network
runs in f32 on ``device`` (``None`` is the card); the cv2 resizes, the edge
pad to a multiple of 64 and the rendering stay on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_anything import Conv, _lecun, conv2d_nhwc, resize_bilinear_ac
from apex_studio_tpu_torch.preprocess.normalbae import normalize_imagenet


class _BN(nn.Module):
    """Inference BatchNorm2d: running-stats affine (torch eps 1e-5)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.running_mean = nn.Parameter(torch.zeros(c))
        self.running_var = nn.Parameter(torch.ones(c))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + 1e-5)
        return (x - self.running_mean) * (inv * self.weight) + self.bias


class _GroupedConv(nn.Module):
    """3x3 grouped conv, NHWC (the ResNeXt cardinality conv)."""

    def __init__(self, cin: int, cout: int, stride: int, groups: int):
        super().__init__()
        self.weight = _lecun(cout, cin // groups, 3, 3, fan_in=cin // groups * 9)
        self.stride = stride
        self.groups = groups

    def forward(self, x):
        return conv2d_nhwc(x, self.weight, None, self.stride, 1, groups=self.groups)


class _Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int, groups: int, base_width: int, has_down: bool):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv(cin, width, kernel=1, padding=0, use_bias=False)
        self.bn1 = _BN(width)
        self.conv2 = _GroupedConv(width, width, stride, groups)
        self.bn2 = _BN(width)
        self.conv3 = Conv(width, planes * 4, kernel=1, padding=0, use_bias=False)
        self.bn3 = _BN(planes * 4)
        if has_down:
            self.down_conv = Conv(cin, planes * 4, kernel=1, stride=stride, padding=0, use_bias=False)
            self.down_bn = _BN(planes * 4)
        else:
            self.down_conv = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return F.relu(out + identity)


def _max_pool_3x3s2(x):
    """``reduce_window(max)`` 3×3, stride 2, padded by one with −inf."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)


class _ResNeXt101(nn.Module):
    """torchvision resnext101_32x8d returning the 4 stage features
    (Resnext_torch.py:253 _forward_impl)."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(3, 64, kernel=7, stride=2, padding=3, use_bias=False)
        self.bn1 = _BN(64)
        groups, base_width = 32, 8
        cin = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), (3, 4, 23, 3))):
            stride = 1 if li == 0 else 2
            layer = []
            for bi in range(n):
                s = stride if bi == 0 else 1
                has_down = bi == 0 and (s != 1 or cin != planes * 4)
                layer.append(_Bottleneck(cin, planes, s, groups, base_width, has_down))
                cin = planes * 4
            setattr(self, f"layer{li + 1}", nn.ModuleList(layer))

    def forward(self, x) -> List[torch.Tensor]:
        x = _max_pool_3x3s2(F.relu(self.bn1(self.conv1(x))))
        feats = []
        for li in range(4):
            for blk in getattr(self, f"layer{li + 1}"):
                x = blk(x)
            feats.append(x)
        return feats


class _FTB(nn.Module):
    """Feature transform block (network_auxi.py:126), with the inplace-ReLU
    skip quirk: out = relu(a + conv(relu(bn(conv(a))))) where a = relu(conv1(x))."""

    def __init__(self, cin: int, mid: int):
        super().__init__()
        self.conv1 = Conv(cin, mid)
        self.branch_conv1 = Conv(mid, mid)
        self.branch_bn = _BN(mid)
        self.branch_conv2 = Conv(mid, mid)

    def forward(self, x):
        a = F.relu(self.conv1(x))
        b = self.branch_conv2(F.relu(self.branch_bn(self.branch_conv1(a))))
        return F.relu(a + b)


class _FFM(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, upfactor: int):
        super().__init__()
        self.ftb1 = _FTB(cin, mid)
        self.ftb2 = _FTB(mid, cout)
        self.upfactor = upfactor

    def forward(self, low, high):
        x = self.ftb2(self.ftb1(low) + high)
        return resize_bilinear_ac(x, x.shape[1] * self.upfactor, x.shape[2] * self.upfactor)


class _AO(nn.Module):
    def __init__(self, cin: int, cout: int, upfactor: int):
        super().__init__()
        self.conv1 = Conv(cin, cin // 2)
        self.bn = _BN(cin // 2)
        self.conv2 = Conv(cin // 2, cout)
        self.upfactor = upfactor

    def forward(self, x):
        x = self.conv2(F.relu(self.bn(self.conv1(x))))
        return resize_bilinear_ac(x, x.shape[1] * self.upfactor, x.shape[2] * self.upfactor)


class _LeReSDecoder(nn.Module):
    """network_auxi.py:16 Decoder."""

    def __init__(self):
        super().__init__()
        inch = (256, 512, 1024, 2048)
        mid = (256, 256, 256, 512)
        self.conv = _FTB(inch[3], mid[3])
        self.conv1 = Conv(mid[3], mid[2])
        self.ffm2 = _FFM(inch[2], mid[2], mid[2], 2)
        self.ffm1 = _FFM(inch[1], mid[1], mid[1], 2)
        self.ffm0 = _FFM(inch[0], mid[0], mid[0], 2)
        self.outconv = _AO(mid[0], 1, 2)

    def forward(self, feats):
        x_32 = self.conv1(self.conv(feats[3]))
        x_16 = resize_bilinear_ac(x_32, x_32.shape[1] * 2, x_32.shape[2] * 2)
        x_8 = self.ffm2(feats[2], x_16)
        x_4 = self.ffm1(feats[1], x_8)
        x_2 = self.ffm0(feats[0], x_4)
        return self.outconv(x_2)


class LeReSModel(nn.Module):
    """RelDepthModel(backbone='resnext101') (multi_depth_model_woauxi.py:8)."""

    def __init__(self):
        super().__init__()
        self.encoder = _ResNeXt101()
        self.decoder = _LeReSDecoder()

    def forward(self, x):
        """x: NHWC ImageNet-normalized → relative depth (B, H, W, 1)."""
        return self.decoder(self.encoder(x))


def convert_leres_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """res101.pth ``depth_model`` state dict → the module's paths (JAX leaf
    names, torch layouts)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        for pre in ("module.", "depth_model."):
            if k.startswith(pre):
                k = k[len(pre):]
        if k.endswith("num_batches_tracked"):
            continue
        k = k.replace("encoder_modules.", "encoder.")
        k = k.replace("decoder_modules.", "decoder.")
        # bottleneck downsample Sequential(conv, bn)
        k = k.replace(".downsample.0.", ".down_conv.")
        k = k.replace(".downsample.1.", ".down_bn.")
        # FTB conv_branch Sequential(ReLU, Conv, BN, ReLU, Conv)
        k = k.replace(".conv_branch.1.", ".branch_conv1.")
        k = k.replace(".conv_branch.2.", ".branch_bn.")
        k = k.replace(".conv_branch.4.", ".branch_conv2.")
        # AO adapt_conv Sequential(Conv, BN, ReLU, Conv, Upsample)
        k = k.replace(".adapt_conv.0.", ".conv1.")
        k = k.replace(".adapt_conv.1.", ".bn.")
        k = k.replace(".adapt_conv.3.", ".conv2.")
        if k.endswith(".weight") and v.ndim == 4:
            k = k[: -len(".weight")] + ".kernel"
        out[k] = v
    return out


@preprocessor_registry.register("leres", aliases=("LeresDetector",))
class LeReSPreprocessor(BasePreprocessor):
    """LeReS inverse relative depth map (reference leres/__init__.py).
    Weights: ``res101.pth`` in the preprocessor models dir."""

    name = "leres"
    params_schema = {"detect_resolution": 512, "thr_a": 0, "thr_b": 0}

    def __init__(self, model: Optional[LeReSModel] = None):
        self._model = model

    def setup(self) -> None:
        if self._model is None:
            from apex_studio_tpu_torch.preprocess.weights import load_detector

            self._model = load_detector(LeReSModel, "res101", "res101.pth", convert_leres_keys, self.device)

    @torch.no_grad()
    def depth(self, frame: Frame, detect_resolution: int = 512) -> np.ndarray:
        """The relative depth at the detect size, f32 on the host."""
        import cv2

        h0, w0 = frame.shape[:2]
        # resize_image_with_pad semantics (util.py:172): short side to the
        # detect resolution, edge-pad to multiples of 64
        k = float(detect_resolution) / float(min(h0, w0))
        ht, wt = int(round(h0 * k)), int(round(w0 * k))
        interp = cv2.INTER_CUBIC if k > 1 else cv2.INTER_AREA
        img = cv2.resize(np.asarray(frame)[..., :3], (wt, ht), interpolation=interp)
        img = np.pad(img, [[0, (-ht) % 64], [0, (-wt) % 64], [0, 0]], mode="edge")
        x = normalize_imagenet(img, next(self._model.parameters()).device)
        return self._model(x)[0, :ht, :wt, 0].cpu().numpy()

    def process_frame(self, frame: Frame, detect_resolution: int = 512, thr_a: int = 0, thr_b: int = 0,
                      **_) -> Frame:
        return render_depth(self.depth(frame, detect_resolution), frame.shape[:2], thr_a, thr_b)


def render_depth(depth: np.ndarray, size, thr_a: int = 0, thr_b: int = 0) -> Frame:
    """16-bit normalise → 8-bit → invert (leres/__init__.py:100-126), the
    ``thr_a`` / ``thr_b`` to-zero thresholds in percent, cv2-resized to
    ``size`` (h, w): host numpy and OpenCV, as in JAX."""
    import cv2

    dmin, dmax = float(depth.min()), float(depth.max())
    if dmax - dmin > np.finfo(np.float32).eps:
        out16 = (65535.0 * (depth - dmin) / (dmax - dmin)).astype(np.uint16)
    else:
        out16 = np.zeros(depth.shape, np.uint16)
    out8 = cv2.convertScaleAbs(out16, alpha=255.0 / 65535.0)
    if thr_a:
        out8 = cv2.threshold(out8, thr_a / 100 * 255, 255, cv2.THRESH_TOZERO)[1]
    out8 = cv2.bitwise_not(out8)
    if thr_b:
        out8 = cv2.threshold(out8, thr_b / 100 * 255, 255, cv2.THRESH_TOZERO)[1]
    vis = np.repeat(out8[:, :, None], 3, axis=2)
    return cv2.resize(vis, (size[1], size[0]), interpolation=cv2.INTER_CUBIC)
