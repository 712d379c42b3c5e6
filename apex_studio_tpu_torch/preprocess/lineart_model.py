"""Learned lineart, the sk_model generator (port of
``apex_studio_tpu/preprocess/lineart_model.py``): a reflection-padded conv
stem, two stride-2 downsamples, instance-norm residual blocks, two
transposed-conv upsamples and a sigmoid head, NHWC at every function as in
the JAX module and with its attribute names (``loaders/from_jax.py``
carries its parameters); the published files load through
``convert_lineart_keys`` strictly.

- ``lineart_realistic`` (aliases ``lineart_model``, ``lineart_coarse``):
  ``sk_model.pth``, or ``sk_model2.pth`` with ``coarse``; the line map is
  inverted to black lines on white.
- ``scribble_anime``: the same topology (3 residual blocks) with
  ``scribble/anime_style/netG_A_latest.pth``, at ``detect_resolution``
  square, not inverted.

The network runs in f32 on ``device`` (``None`` is the card), its transposed
convolutions with cuDNN's deterministic algorithms. Departure: a missing
checkpoint raises ``FileNotFoundError`` and the load is strict, where the
JAX preprocessors run random weights or load by shape.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.device import cudnn_deterministic
from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_anything import _lecun, conv2d_nhwc


def _reflect_pad(x, p):
    return F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect").permute(0, 2, 3, 1)


def instance_norm(x, eps=1e-5):
    """Non-affine instance norm over H, W of NHWC (population variance)."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class _Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1):
        super().__init__()
        self.weight = _lecun(cout, cin, k, k, fan_in=cin * k * k)
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride = stride

    def forward(self, x, padding=0):
        return conv2d_nhwc(x, self.weight, self.bias, self.stride, padding)


class _Deconv(nn.Module):
    """ConvTranspose2d(k=3, stride=2, padding=1, output_padding=1):
    ``weight`` [in, out, 3, 3]; the JAX module keeps it as an unflipped HWIO
    ``w`` (``jax_w_flipped``)."""

    jax_w_flipped = False

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = _lecun(cin, cout, 3, 3, fan_in=9 * cin)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        with cudnn_deterministic():
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias, stride=2, padding=1,
                                   output_padding=1)
        return y.permute(0, 2, 3, 1)


class _ResBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv1 = _Conv(ch, ch, 3)
        self.conv2 = _Conv(ch, ch, 3)

    def forward(self, x):
        h = F.relu(instance_norm(self.conv1(_reflect_pad(x, 1))))
        return x + instance_norm(self.conv2(_reflect_pad(h, 1)))


class LineartGenerator(nn.Module):
    def __init__(self, n_blocks: int = 3):
        super().__init__()
        self.conv_in = _Conv(3, 64, 7)
        self.down1 = _Conv(64, 128, 3, stride=2)
        self.down2 = _Conv(128, 256, 3, stride=2)
        self.res_blocks = nn.ModuleList([_ResBlock(256) for _ in range(n_blocks)])
        self.up1 = _Deconv(256, 128)
        self.up2 = _Deconv(128, 64)
        self.conv_out = _Conv(64, 1, 7)

    def forward(self, x):  # NHWC in [0,1]
        h = F.relu(instance_norm(self.conv_in(_reflect_pad(x, 3))))
        h = F.relu(instance_norm(self.down1(h, padding=1)))
        h = F.relu(instance_norm(self.down2(h, padding=1)))
        for blk in self.res_blocks:
            h = blk(h)
        h = F.relu(instance_norm(self.up1(h)))
        h = F.relu(instance_norm(self.up2(h)))
        return torch.sigmoid(self.conv_out(_reflect_pad(h, 3)))


_RENAMES = {"model0.1": "conv_in", "model1.0": "down1", "model1.3": "down2",
            "model3.0": "up1", "model3.3": "up2", "model4.1": "conv_out"}


def convert_lineart_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """sk_model.pth keys (model0..model4 Sequential indices) → the module's
    paths (JAX leaf names, torch layouts; a transposed conv's weight under
    the port's name)."""
    out = {}
    for k, v in sd.items():
        stem, leaf = k.rsplit(".", 1)
        if stem.startswith("model2."):
            _, idx, _, conv_idx = stem.split(".")
            name = f"res_blocks.{idx}.{'conv1' if conv_idx == '1' else 'conv2'}"
        elif stem in _RENAMES:
            name = _RENAMES[stem]
        else:
            continue
        if leaf == "weight" and v.ndim == 4:
            out[f"{name}.{'weight' if name.startswith('up') else 'kernel'}"] = v
        elif leaf == "bias":
            out[f"{name}.bias"] = v
    return out


def _generator(stem: str, filename: str, device, strip_module: bool = False) -> LineartGenerator:
    from apex_studio_tpu_torch.preprocess.weights import load_detector

    def convert(sd):
        if strip_module:
            sd = {k.replace("module.", ""): v for k, v in sd.items()}
        return convert_lineart_keys(sd)

    return load_detector(LineartGenerator, stem, filename, convert, device)


@torch.no_grad()
def _line(model: LineartGenerator, img: np.ndarray) -> np.ndarray:
    """The sigmoid line map [H, W] of a uint8 HWC image."""
    dev = next(model.parameters()).device
    return model(torch.from_numpy(img.astype(np.float32) / 255.0)[None].to(dev))[0, :, :, 0].cpu().numpy()


@preprocessor_registry.register("lineart_realistic", aliases=("lineart_model", "lineart_coarse"))
class LineartModelPreprocessor(BasePreprocessor):
    """Black-on-white line art. Weights: ``sk_model.pth`` (``coarse``:
    ``sk_model2.pth``) in the preprocessor models dir."""

    name = "lineart_realistic"
    params_schema = {"coarse": False}

    def __init__(self, model: Optional[LineartGenerator] = None,
                 coarse_model: Optional[LineartGenerator] = None):
        self.model = model
        self.coarse_model = coarse_model

    def _ensure(self, coarse: bool) -> LineartGenerator:
        attr = "coarse_model" if coarse else "model"
        if getattr(self, attr) is None:
            setattr(self, attr, _generator("lineart_coarse" if coarse else "lineart_sk",
                                           "sk_model2.pth" if coarse else "sk_model.pth", self.device))
        return getattr(self, attr)

    def process_frame(self, frame: Frame, coarse: bool = False, **_: Any) -> Frame:
        h, w = frame.shape[:2]
        x = np.pad(frame, ((0, (-h) % 4), (0, (-w) % 4), (0, 0)), mode="edge")
        line = _line(self._ensure(bool(coarse)), x)[:h, :w]
        out = 255 - (line * 255.0).clip(0, 255).astype(np.uint8)
        return np.repeat(out[:, :, None], 3, axis=2)


@preprocessor_registry.register("scribble_anime", aliases=("ScribbleAnimeDetector",))
class ScribbleAnimePreprocessor(BasePreprocessor):
    """Anime-style scribble contours (the lineart generator, 3 residual
    blocks, with ``scribble/anime_style/netG_A_latest.pth``); the raw contour
    map, not inverted (scribble_anime/__init__.py:163)."""

    name = "scribble_anime"
    params_schema = {"detect_resolution": 512}

    def __init__(self, model: Optional[LineartGenerator] = None):
        self.model = model

    def setup(self) -> None:
        if self.model is None:
            self.model = _generator("scribble_anime", "scribble/anime_style/netG_A_latest.pth", self.device,
                                    strip_module=True)

    def process_frame(self, frame: Frame, detect_resolution: int = 512, **_: Any) -> Frame:
        import cv2

        h, w = frame.shape[:2]
        size = int(detect_resolution)
        size -= size % 4
        img = cv2.resize(frame, (size, size), interpolation=cv2.INTER_CUBIC)
        contour = (_line(self.model, img) * 255.0).clip(0, 255).astype(np.uint8)
        out = cv2.resize(contour, (w, h), interpolation=cv2.INTER_AREA)
        return np.repeat(out[:, :, None], 3, axis=2)
