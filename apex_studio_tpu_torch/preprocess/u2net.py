"""U²-Net salient-object segmentation, the rembg background remover (port of
``apex_studio_tpu/preprocess/u2net.py``): nested residual U-blocks (RSU-7..4
and the dilated RSU-4F) with six side outputs fused by a 1×1 conv; ``u2net``
is the full model, ``u2netp`` (``light``) the small one. NHWC at every
function as in the JAX module and with its attribute names
(``loaders/from_jax.py`` carries its parameters); the published
``u2net.pth`` / ``u2netp.pth`` load through ``convert_u2net_keys`` and
``_finalize_u2net_tree`` strictly.

The network runs in f32 on ``device`` (``None`` is the card) on the 320×320
ImageNet-normalised frame; the min-max normalised map comes back to the host,
where cv2 resizes it back (Lanczos), and the mask post-processing and the
compositing stay in numpy and OpenCV, as in JAX. The output is RGBA (4
channels) unless ``only_mask``.

``_pool`` is a ceil-mode 2×2 max pool; ``_up_to`` is ``jax.image.resize``
bilinear (half-pixel centres), through ``utils/jax_resize.py``.

Departure: the JAX preprocessor runs random weights where it finds no
checkpoint, without a warning, and loads only the names and shapes that
match; here a missing checkpoint raises ``FileNotFoundError`` and the load is
strict (every key used but BatchNorm's ``num_batches_tracked``, every
parameter filled).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_anything import _bn, _bn_params, _lecun, conv2d_nhwc
from apex_studio_tpu_torch.utils.jax_resize import resize as jax_resize


class _ConvBnRelu(nn.Module):
    """conv 3×3 (dilated) + eval-mode BatchNorm + ReLU (torch REBNCONV)."""

    def __init__(self, cin: int, cout: int, dilation: int = 1):
        super().__init__()
        self.weight = _lecun(cout, cin, 3, 3, fan_in=cin * 9)
        self.bias = nn.Parameter(torch.zeros(cout))
        _bn_params(self, cout)
        self.dilation = dilation

    def forward(self, x):
        d = self.dilation
        return F.relu(_bn(self, conv2d_nhwc(x, self.weight, self.bias, 1, d, d)))


def _pool(x: torch.Tensor) -> torch.Tensor:
    """maxpool 2×2 stride 2, torch ceil_mode=True."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True).permute(0, 2, 3, 1)


def _up_to(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Bilinear resize to ``ref``'s spatial dims (``jax.image.resize``)."""
    return jax_resize(x, (x.shape[0], ref.shape[1], ref.shape[2], x.shape[3]), "bilinear")


class _RSU(nn.Module):
    """Residual U-block of depth L with pooling (torch RSU7..RSU4)."""

    def __init__(self, depth: int, cin: int, mid: int, cout: int):
        super().__init__()
        self.depth = depth
        self.convin = _ConvBnRelu(cin, cout)
        self.enc = nn.ModuleList([_ConvBnRelu(cout, mid)] + [_ConvBnRelu(mid, mid) for _ in range(depth - 2)])
        self.bottom = _ConvBnRelu(mid, mid, dilation=2)
        self.dec = nn.ModuleList([_ConvBnRelu(2 * mid, mid) for _ in range(depth - 2)]
                                 + [_ConvBnRelu(2 * mid, cout)])

    def forward(self, x):
        xin = self.convin(x)
        feats = []
        h = xin
        for i, conv in enumerate(self.enc):
            h = conv(h)
            feats.append(h)
            if i < len(self.enc) - 1:
                h = _pool(h)
        h = self.bottom(h)
        for i, conv in enumerate(self.dec):
            skip = feats[-(i + 1)]
            if i > 0:
                h = _up_to(h, skip)
            h = conv(torch.cat([h, skip], dim=-1))
        return _up_to(h, xin) + xin if h.shape[1] != xin.shape[1] else h + xin


class _RSU4F(nn.Module):
    """Dilated residual U-block, no pooling (torch RSU4F)."""

    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.convin = _ConvBnRelu(cin, cout)
        self.enc = nn.ModuleList([_ConvBnRelu(cout, mid, 1), _ConvBnRelu(mid, mid, 2), _ConvBnRelu(mid, mid, 4)])
        self.bottom = _ConvBnRelu(mid, mid, 8)
        self.dec = nn.ModuleList([_ConvBnRelu(2 * mid, mid, 4), _ConvBnRelu(2 * mid, mid, 2),
                                  _ConvBnRelu(2 * mid, cout, 1)])

    def forward(self, x):
        xin = self.convin(x)
        f1 = self.enc[0](xin)
        f2 = self.enc[1](f1)
        f3 = self.enc[2](f2)
        h = self.bottom(f3)
        h = self.dec[0](torch.cat([h, f3], dim=-1))
        h = self.dec[1](torch.cat([h, f2], dim=-1))
        h = self.dec[2](torch.cat([h, f1], dim=-1))
        return h + xin


class _SideConv(nn.Module):
    """3×3 conv to a 1-channel side logit map."""

    def __init__(self, cin: int):
        super().__init__()
        self.weight = _lecun(1, cin, 3, 3, fan_in=cin * 9)
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return conv2d_nhwc(x, self.weight, self.bias, 1, 1)


class U2Net(nn.Module):
    """Full / light U²-Net. ``light=False`` → u2net, True → u2netp."""

    def __init__(self, light: bool = False):
        super().__init__()
        if light:
            st = [(7, 3, 16, 64), (6, 64, 16, 64), (5, 64, 16, 64), (4, 64, 16, 64)]
            f5 = f6 = (64, 16, 64)
            dd = [(128, 16, 64)] * 5
            side_ch = [64] * 6
        else:
            st = [(7, 3, 32, 64), (6, 64, 32, 128), (5, 128, 64, 256), (4, 256, 128, 512)]
            f5 = f6 = (512, 256, 512)
            dd = [(1024, 256, 512), (1024, 128, 256), (512, 64, 128), (256, 32, 64), (128, 16, 64)]
            side_ch = [64, 64, 128, 256, 512, 512]
        self.stage1, self.stage2, self.stage3, self.stage4 = (_RSU(*s) for s in st)
        self.stage5 = _RSU4F(*f5)
        self.stage6 = _RSU4F(*f6)
        self.stage5d = _RSU4F(*dd[0])
        self.stage4d, self.stage3d, self.stage2d, self.stage1d = (
            _RSU(depth, *dims) for depth, dims in zip((4, 5, 6, 7), dd[1:]))
        self.side1, self.side2, self.side3, self.side4, self.side5, self.side6 = (_SideConv(c) for c in side_ch)
        self.outconv_weight = _lecun(1, 6, 1, 1, fan_in=6)
        self.outconv_bias = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        h1 = self.stage1(x)
        h2 = self.stage2(_pool(h1))
        h3 = self.stage3(_pool(h2))
        h4 = self.stage4(_pool(h3))
        h5 = self.stage5(_pool(h4))
        h6 = self.stage6(_pool(h5))
        d5 = self.stage5d(torch.cat([_up_to(h6, h5), h5], dim=-1))
        d4 = self.stage4d(torch.cat([_up_to(d5, h4), h4], dim=-1))
        d3 = self.stage3d(torch.cat([_up_to(d4, h3), h3], dim=-1))
        d2 = self.stage2d(torch.cat([_up_to(d3, h2), h2], dim=-1))
        d1 = self.stage1d(torch.cat([_up_to(d2, h1), h1], dim=-1))
        sides = [self.side1(d1)] + [_up_to(side(d), d1) for side, d in (
            (self.side2, d2), (self.side3, d3), (self.side4, d4), (self.side5, d5), (self.side6, h6))]
        d0 = conv2d_nhwc(torch.cat(sides, dim=-1), self.outconv_weight, self.outconv_bias)
        return torch.sigmoid(d0)


_REBN = {"conv_s1": {"weight": "kernel", "bias": "bias"},
         "bn_s1": {"weight": "bn_scale", "bias": "bn_bias", "running_mean": "bn_mean", "running_var": "bn_var"}}


def convert_u2net_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """u2net.pth torch keys → the JAX module's leaf names, torch layouts kept,
    the decoder and bottom layers under the placeholders that
    ``_finalize_u2net_tree`` resolves: torch RSU layers are named rebnconvin /
    rebnconv1..L (rebnconvL the dilated bottom) / rebnconv{L-1}d..1d, each
    with conv_s1 + bn_s1; sides are side1..6, the fuse is outconv.
    BatchNorm's ``num_batches_tracked`` is dropped; any other key the table
    does not know is kept, so that the strict load names it."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        if parts[0] == "outconv" and len(parts) == 2:
            out["outconv_kernel" if parts[1] == "weight" else f"outconv_{parts[1]}"] = v
            continue
        if parts[0].startswith("side") and len(parts) == 2:
            out[f"{parts[0]}.{'kernel' if parts[1] == 'weight' else parts[1]}"] = v
            continue
        if len(parts) != 4 or not parts[1].startswith("rebnconv") or parts[3] not in _REBN.get(parts[2], {}):
            out[k] = v
            continue
        stage, layer, sub, attr = parts
        if layer == "rebnconvin":
            ours = "convin"
        elif layer.endswith("d"):
            ours = f"dec.__DEPTH{int(layer[len('rebnconv'):-1])}__"
        else:
            ours = f"enc.{int(layer[len('rebnconv'):]) - 1}"
        out[f"{stage}.{ours}.{_REBN[sub][attr]}"] = v
    return out


def _finalize_u2net_tree(tree: Dict[str, torch.Tensor], model: nn.Module) -> Dict[str, torch.Tensor]:
    """Resolve the per-stage depth-dependent names (the bottom conv, the
    decoder order) from ``model``'s own encoder lengths. Nothing is filtered
    out: a key that names no parameter reaches the strict load."""
    enc_len: Dict[str, int] = {}
    for name, _ in model.named_parameters():
        if ".enc." in name:
            stage, rest = name.split(".enc.", 1)
            enc_len[stage] = max(enc_len.get(stage, 0), int(rest.split(".")[0]) + 1)
    fixed = {}
    for k, v in tree.items():
        if "__DEPTH" in k:
            stage = k.split(".dec.")[0]
            idx = int(k.split("__DEPTH")[1].split("__")[0])
            k = k.replace(f"dec.__DEPTH{idx}__", f"dec.{enc_len.get(stage, 3) - idx}")
        elif ".enc." in k:
            stage, rest = k.split(".enc.", 1)
            idx = int(rest.split(".")[0])
            if idx == enc_len.get(stage, 99):  # torch's last = our bottom
                k = k.replace(f"enc.{idx}", "bottom")
        fixed[k] = v
    return fixed


_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def u2net_converter(build):
    """The strict load's converter for the module ``build()`` makes: its
    stage depths read from a copy built on ``meta``."""
    def convert(sd):
        with torch.device("meta"):
            ref = build()
        return _finalize_u2net_tree(convert_u2net_keys(sd), ref)
    return convert


def _post_process(m8: np.ndarray) -> np.ndarray:
    """rembg.post_process: open, gaussian blur, re-binarise."""
    import cv2

    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3))
    m8 = cv2.morphologyEx(m8, cv2.MORPH_OPEN, kernel)
    m8 = cv2.GaussianBlur(m8, (5, 5), sigmaX=2, sigmaY=2, borderType=cv2.BORDER_DEFAULT)
    return np.where(m8 < 127, 0, 255).astype(np.uint8)


@preprocessor_registry.register("rembg", aliases=("background_removal", "u2net"))
class RembgPreprocessor(BasePreprocessor):
    """Background removal through U²-Net (reference src/preprocess/rembg
    RembgDetector, the rembg library's behaviour). Weights: ``u2net.pth`` /
    ``u2netp.pth`` in the preprocessor models dir."""

    name = "rembg"
    params_schema = {"model_name": "u2net", "post_process_mask": False, "bgcolor": None, "only_mask": False}
    weights_id = "u2net"

    def __init__(self, model: Optional[U2Net] = None, model_name: str = "u2net"):
        self.model = model
        self.model_name = model_name
        self._pending = model_name

    def __call__(self, frames, progress_callback=None, device=None, **params):
        self._pending = params.get("model_name", self.model_name)
        return super().__call__(frames, progress_callback=progress_callback, device=device, **params)

    def setup(self) -> None:
        if self.model is None or self._pending != self.model_name:
            from apex_studio_tpu_torch.preprocess.weights import load_detector

            self.model_name = name = self._pending
            build = lambda: U2Net(light=name == "u2netp")  # noqa: E731
            self.model = load_detector(build, name, f"{name}.pth", u2net_converter(build), self.device)

    def saliency(self, frame: Frame) -> np.ndarray:
        """The min-max normalised 320×320 map, before the resize back."""
        import cv2

        x = cv2.resize(frame, (320, 320), interpolation=cv2.INTER_LINEAR).astype(np.float32)
        x = (x / max(x.max(), 1e-6) - _MEAN) / _STD
        dev = next(self.model.parameters()).device
        with torch.no_grad():
            d0 = self.model(torch.from_numpy(x)[None].to(dev))[0, :, :, 0].cpu().numpy()
        mi, ma = d0.min(), d0.max()
        return (d0 - mi) / max(ma - mi, 1e-6)

    def predict_mask(self, frame: Frame) -> np.ndarray:
        """HW float [0, 1] saliency map at the input resolution."""
        import cv2

        h, w = frame.shape[:2]
        return cv2.resize(self.saliency(frame), (w, h), interpolation=cv2.INTER_LANCZOS4).clip(0, 1)

    def process_frame(self, frame: Frame, model_name: str = "u2net", post_process_mask: bool = False,
                      bgcolor: Optional[Sequence[int]] = None, only_mask: bool = False, **_: Any) -> Frame:
        m8 = (self.predict_mask(frame) * 255).astype(np.uint8)
        if post_process_mask:
            m8 = _post_process(m8)
        if only_mask:
            return np.repeat(m8[:, :, None], 3, axis=2)
        rgba = np.dstack([frame[:, :, :3], m8])
        if bgcolor is None:
            return rgba
        a = m8.astype(np.float32)[:, :, None] / 255.0
        rgb = rgba[:, :, :3].astype(np.float32) * a + np.asarray(bgcolor[:3], np.uint8).astype(np.float32) * (1 - a)
        return np.dstack([rgb.astype(np.uint8), np.full_like(m8, 255)])
