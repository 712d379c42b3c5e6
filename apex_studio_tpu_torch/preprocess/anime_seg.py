"""Anime face segmentation and anime character matting (port of
``apex_studio_tpu/preprocess/anime_seg.py``):

- ``AnimeFaceUNet`` (reference network.py:10): a MobileNetV2-encoder U-Net
  with instance-norm nearest-upsample decoder blocks producing 7 classes
  (background, hair, eye, mouth, face, skin, clothes), drawn through the
  fixed ``PALETTE``; its trunk is M-LSD's ``_ConvBNReLU6`` /
  ``_InvertedResidual`` with torch's symmetric padding (``tf_pad=False``);
- ``ISNetDIS`` (isnet.py:499), the anime-segmentation matting net: a stride-2
  stem and U²-Net's RSU pyramid (``u2net.py``); inference takes side output
  1 through a sigmoid and composites the character over white.

NHWC at every function as in the JAX module and with its attribute names
(``loaders/from_jax.py`` carries the parameters). The published
``Annotators/UNet.pth`` loads through ``convert_anime_face_keys`` and the
Lightning checkpoint ``isnetis.ckpt`` (its ``state_dict``, ``net.``
prefixed; ``weights.py`` reads the trainer state beside it inertly) through
``convert_isnet_keys`` and ``_finalize_isnet_tree``, both strictly.

The nets run in f32 on ``device`` (``None`` is the card); the resizes, the
compositing, the argmax and the palette stay on the host, as in JAX.

Departure: the JAX preprocessor runs random weights (with a warning) where
it finds no checkpoint and loads only the names and shapes that match; here a
missing checkpoint raises ``FileNotFoundError`` and the loads are strict.
The matting file's training-only keys are dropped by name: the side outputs 2
to 6 and the ground-truth encoder (``gt_encoder.``), which inference does not
run.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_anything import _lecun, conv2d_nhwc
from apex_studio_tpu_torch.preprocess.mlsd import _ConvBNReLU6, _InvertedResidual
from apex_studio_tpu_torch.preprocess.u2net import _RSU, _RSU4F, _finalize_u2net_tree, _pool, _up_to, convert_u2net_keys

# BGR→RGB-as-stored palette (util.py:17, webui-controlnet ordering)
PALETTE = np.array([
    (255, 255, 0),    # background
    (0, 0, 255),      # hair
    (255, 0, 0),      # eye
    (255, 255, 255),  # mouth
    (0, 255, 0),      # face
    (0, 255, 255),    # skin
    (255, 0, 255),    # clothes
], np.uint8)

# torchvision mobilenet_v2 inverted residual table (expand, cout, n, stride)
_MBV2 = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2)]


class _DecoderBlock(nn.Module):
    """network.py:52 — nearest ×2 upsample, 3×3 conv, non-affine instance
    norm + LeakyReLU(0.1) (dropout is the identity at inference); the last
    block is a softmax over the classes."""

    def __init__(self, cin: int, cout: int, final: bool = False):
        super().__init__()
        self.weight = _lecun(cout, cin, 3, 3, fan_in=cin * 9)
        self.bias = nn.Parameter(torch.zeros(cout))
        self.final = final

    def forward(self, x):
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        y = conv2d_nhwc(x, self.weight, self.bias, 1, 1)
        if self.final:
            return torch.softmax(y, dim=-1)
        mean = y.mean(dim=(1, 2), keepdim=True)
        var = y.var(dim=(1, 2), keepdim=True, unbiased=False)
        y = (y - mean) * torch.rsqrt(var + 1e-5)
        return torch.where(y >= 0, y, 0.1 * y)


class AnimeFaceUNet(nn.Module):
    """network.py:10 — MobileNetV2 features 0..16 encoder + IN decoder."""

    def __init__(self):
        super().__init__()
        feats: List[nn.Module] = [_ConvBNReLU6(3, 32, 3, 2, tf_pad=False)]
        cin = 32
        for expand, cout, n, s in _MBV2:
            for i in range(n):
                feats.append(_InvertedResidual(cin, cout, s if i == 0 else 1, expand, tf_pad=False))
                cin = cout
        self.features = nn.ModuleList(feats)
        self.de_block4 = _DecoderBlock(160, 96)
        self.de_block3 = _DecoderBlock(192, 32)
        self.de_block2 = _DecoderBlock(64, 24)
        self.de_block1 = _DecoderBlock(48, 16)
        self.de_block0 = _DecoderBlock(32, 7, final=True)

    def forward(self, x):
        taps = {}
        h = x
        for i, f in enumerate(self.features):
            h = f(h)
            if i in (1, 3, 6, 13, 16):
                taps[i] = h
        d4 = self.de_block4(taps[16])
        d3 = self.de_block3(torch.cat([d4, taps[13]], dim=-1))
        d2 = self.de_block2(torch.cat([d3, taps[6]], dim=-1))
        d1 = self.de_block1(torch.cat([d2, taps[3]], dim=-1))
        return self.de_block0(torch.cat([d1, taps[1]], dim=-1))


# en_block slices → global feature indices (network.py:22-48)
_SPANS = {0: (0, 2), 1: (2, 4), 2: (4, 7), 3: (7, 14), 4: (14, 17)}
_BN = (("weight", "bn_scale"), ("bias", "bn_bias"), ("running_mean", "bn_mean"), ("running_var", "bn_var"))


def convert_anime_face_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """UNet.pth (``en_blockN`` nested MobileNetV2 blocks, ``de_blockN.1``
    convs) → the JAX module's leaf names, torch layouts kept. Every key is
    used but BatchNorm's ``num_batches_tracked``: one the table does not
    know raises ``KeyError``."""
    out: Dict[str, torch.Tensor] = {}
    used = set()

    def take(key):
        used.add(key)
        return sd[key]

    def conv_bn(conv, bn, j):
        out[f"{j}.kernel"] = take(f"{conv}.weight")
        for theirs, ours in _BN:
            out[f"{j}.{ours}"] = take(f"{bn}.{theirs}")

    for blk, (start, end) in _SPANS.items():
        for gi in range(start, end):
            t, j = f"en_block{blk}.{gi - start}", f"features.{gi}"
            if gi == 0:
                conv_bn(f"{t}.0", f"{t}.1", j)
            elif gi == 1:  # expand 1: dw, then the linear pointwise
                conv_bn(f"{t}.conv.0.0", f"{t}.conv.0.1", f"{j}.dw")
                conv_bn(f"{t}.conv.1", f"{t}.conv.2", f"{j}.pw")
            else:
                conv_bn(f"{t}.conv.0.0", f"{t}.conv.0.1", f"{j}.expand")
                conv_bn(f"{t}.conv.1.0", f"{t}.conv.1.1", f"{j}.dw")
                conv_bn(f"{t}.conv.2", f"{t}.conv.3", f"{j}.pw")
    for blk in range(5):
        out[f"de_block{blk}.kernel"] = take(f"de_block{blk}.1.weight")
        out[f"de_block{blk}.bias"] = take(f"de_block{blk}.1.bias")
    unknown = sorted(k for k in set(sd) - used if not k.endswith("num_batches_tracked"))
    if unknown:
        raise KeyError(f"UNet.pth keys the converter does not know: {unknown[:8]}")
    return out


class ISNetDIS(nn.Module):
    """isnet.py:499 — stride-2 stem + U²-Net-style RSU encoder/decoder; only
    side output 1 is computed at inference."""

    def __init__(self):
        super().__init__()
        self.conv_in_weight = _lecun(64, 3, 3, 3, fan_in=27)
        self.conv_in_bias = nn.Parameter(torch.zeros(64))
        self.stage1 = _RSU(7, 64, 32, 64)
        self.stage2 = _RSU(6, 64, 32, 128)
        self.stage3 = _RSU(5, 128, 64, 256)
        self.stage4 = _RSU(4, 256, 128, 512)
        self.stage5 = _RSU4F(512, 256, 512)
        self.stage6 = _RSU4F(512, 256, 512)
        self.stage5d = _RSU4F(1024, 256, 512)
        self.stage4d = _RSU(4, 1024, 128, 256)
        self.stage3d = _RSU(5, 512, 64, 128)
        self.stage2d = _RSU(6, 256, 32, 64)
        self.stage1d = _RSU(7, 128, 16, 64)
        self.side1_weight = _lecun(1, 64, 3, 3, fan_in=576)
        self.side1_bias = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        """NHWC [0, 1] image → [B, H, W, 1] matte logits (side 1)."""
        hxin = conv2d_nhwc(x, self.conv_in_weight, self.conv_in_bias, 2, 1)
        h1 = self.stage1(hxin)
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
        return _up_to(conv2d_nhwc(d1, self.side1_weight, self.side1_bias, 1, 1), x)


# isnetis.ckpt keys inference does not read: the deep supervision sides and
# the training-time ground-truth encoder
_ISNET_TRAINING_ONLY = re.compile(r"^(side[2-6]\.|gt_encoder\.)")


def convert_isnet_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """isnetis.ckpt's state dict (``net.``-prefixed ISNetDIS) → the JAX
    module's leaf names, the RSU interiors through U²-Net's converter (their
    decoder and bottom names still to resolve, ``_finalize_isnet_tree``).
    The training-only keys are dropped; any other key is kept, so that the
    strict load names it."""
    sd = {k[len("net."):] if k.startswith("net.") else k: v for k, v in sd.items()}
    sd = {k: v for k, v in sd.items() if not _ISNET_TRAINING_ONLY.match(k)}
    out = convert_u2net_keys({k: v for k, v in sd.items() if k.startswith("stage")})
    for k, v in sd.items():
        if k.startswith("stage") or k.endswith("num_batches_tracked"):
            continue
        name = {"conv_in.weight": "conv_in_kernel", "conv_in.bias": "conv_in_bias",
                "side1.weight": "side1_kernel", "side1.bias": "side1_bias"}.get(k, k)
        out[name] = v
    return out


def _finalize_isnet_tree(tree: Dict[str, torch.Tensor], model: nn.Module) -> Dict[str, torch.Tensor]:
    return _finalize_u2net_tree(tree, model)


def _isnet_convert(sd):
    with torch.device("meta"):
        ref = ISNetDIS()
    return _finalize_isnet_tree(convert_isnet_keys(sd), ref)


@preprocessor_registry.register("anime_face_segment", aliases=("AnimeFaceSegmentor",))
class AnimeFaceSegmentPreprocessor(BasePreprocessor):
    """7-class anime face parsing map with optional ISNet character matting
    (reference anime_face_segment/__init__.py:52). Weights:
    ``Annotators/UNet.pth`` (or ``anime_face_segment.*``) and, for
    ``remove_background``, ``isnetis.ckpt`` (or ``isnet_anime.*``) in the
    preprocessor models dir."""

    name = "anime_face_segment"
    params_schema = {"detect_resolution": 512, "remove_background": True}
    weights_id = "anime_face_segment"

    def __init__(self, model: Optional[AnimeFaceUNet] = None, seg_model: Optional[ISNetDIS] = None):
        self.model = model
        self.seg_model = seg_model
        self._need_seg = True

    def __call__(self, frames, progress_callback=None, device=None, **params):
        self._need_seg = bool(params.get("remove_background", True))
        return super().__call__(frames, progress_callback=progress_callback, device=device, **params)

    def setup(self) -> None:
        from apex_studio_tpu_torch.preprocess.weights import load_detector

        if self.model is None:
            self.model = load_detector(AnimeFaceUNet, "anime_face_segment", "Annotators/UNet.pth",
                                       convert_anime_face_keys, self.device)
        if self._need_seg and self.seg_model is None:
            self.seg_model = load_detector(ISNetDIS, "isnet_anime", "isnetis.ckpt", _isnet_convert, self.device)

    def matte(self, img: np.ndarray) -> np.ndarray:
        """The character matte (sigmoid of side 1) of a resized uint8 image."""
        dev = next(self.seg_model.parameters()).device
        with torch.no_grad():
            x = torch.from_numpy(img.astype(np.float32) / 255.0)[None].to(dev)
            return torch.sigmoid(self.seg_model(x))[0].cpu().numpy()

    def class_probs(self, img: np.ndarray) -> np.ndarray:
        """The 7 class probabilities of a resized uint8 image."""
        dev = next(self.model.parameters()).device
        with torch.no_grad():
            return self.model(torch.from_numpy(img.astype(np.float32) / 255.0)[None].to(dev))[0].cpu().numpy()

    def process_frame(self, frame: Frame, detect_resolution: int = 512, remove_background: bool = True,
                      **_) -> Frame:
        import cv2

        h, w = frame.shape[:2]
        size = int(detect_resolution)
        img = cv2.resize(frame, (size, size), interpolation=cv2.INTER_CUBIC)
        if remove_background:
            mask = self.matte(img)
            img = (mask * img + 255.0 * (1 - mask)).astype(np.uint8)
        colored = PALETTE[self.class_probs(img).argmax(-1)]
        return cv2.resize(colored, (w, h), interpolation=cv2.INTER_NEAREST)
