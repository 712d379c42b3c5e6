"""Manga line extraction, the ``res_skip`` network (port of
``apex_studio_tpu/preprocess/manga_line.py``): a BN-first residual U-Net over
a raw 0-255 grayscale image, encoder blocks 0-4 (24→384 channels, stride 2
on each block's last unit), nearest-×2 decoder blocks 5-8 with skips from the
mirrored encoder stage, a 16-channel refine block and a 1×1 head; NHWC at
every function as in the JAX module and with its attribute names
(``loaders/from_jax.py`` carries its parameters). The published ``erika.pth``
loads through ``convert_manga_line_keys`` strictly.

The network runs in f32 on ``device`` (``None`` is the card); the output is
inverted by the wrapper. Departure: a missing checkpoint raises
``FileNotFoundError``, where the JAX preprocessor runs random weights.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_anything import _lecun, conv2d_nhwc


class _BnReluConv(nn.Module):
    """model_torch.py:7 — BatchNorm(eps 1e-3) → LeakyReLU(0.2) → conv."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.bn_scale = nn.Parameter(torch.ones(cin))
        self.bn_bias = nn.Parameter(torch.zeros(cin))
        self.bn_mean = nn.Parameter(torch.zeros(cin))
        self.bn_var = nn.Parameter(torch.ones(cin))
        self.weight = _lecun(cout, cin, k, k, fan_in=cin * k * k)
        self.bias = nn.Parameter(torch.zeros(cout))
        self.k, self.stride = k, stride

    def forward(self, x):
        x = (x - self.bn_mean) * torch.rsqrt(self.bn_var + 1e-3)
        x = x * self.bn_scale + self.bn_bias
        x = torch.where(x >= 0, x, 0.2 * x)
        return conv2d_nhwc(x, self.weight, self.bias, self.stride, self.k // 2)


def _up2_nearest(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class _Conv1x1(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.weight = _lecun(cout, cin, 1, 1, fan_in=cin)
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride = stride

    def forward(self, x):
        return conv2d_nhwc(x, self.weight, self.bias, self.stride, 0)


class _BasicBlock(nn.Module):
    """model_torch.py:119 — conv1 → residual conv, 1×1 shortcut when the
    shape changes."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = _BnReluConv(cin, cout, 3, stride)
        self.residual = _BnReluConv(cout, cout, 3)
        self.shortcut = _Conv1x1(cin, cout, stride) if cin != cout or stride != 1 else None

    def forward(self, x):
        y = self.residual(self.conv1(x))
        return (x if self.shortcut is None else self.shortcut(x)) + y


class _UBasicBlock(nn.Module):
    """model_torch.py:136 — upsampling unit: conv path and shortcut both
    nearest-×2 upsampled."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = _BnReluConv(cin, cout, 3)
        self.residual = _BnReluConv(cout, cout, 3)
        self.shortcut = _Conv1x1(cin, cout) if cin != cout else None

    def forward(self, x):
        y = self.residual(_up2_nearest(self.conv1(x)))
        return _up2_nearest(x if self.shortcut is None else self.shortcut(x)) + y


class MangaLineModel(nn.Module):
    """res_skip (model_torch.py:198). NHWC 1-channel 0-255 float input."""

    _ENC = [(1, 24, 2, True), (24, 48, 3, False), (48, 96, 5, False), (96, 192, 7, False),
            (192, 384, 12, False)]
    _DEC = [(384, 192, 7), (192, 96, 5), (96, 48, 3), (48, 24, 2)]

    def __init__(self):
        super().__init__()

        def enc(cin, cout, reps, first):
            return nn.ModuleList([_BasicBlock(cin if i == 0 else cout, cout,
                                              2 if (i == reps - 1 and not first) else 1) for i in range(reps)])

        def dec(cin, cout, reps):
            blocks: List[nn.Module] = [_UBasicBlock(cin, cout)]
            return nn.ModuleList(blocks + [_BasicBlock(cout, cout) for _ in range(reps - 1)])

        for i, spec in enumerate(self._ENC):
            setattr(self, f"block{i}", enc(*spec))
        for i, spec in enumerate(self._DEC):
            setattr(self, f"block{5 + i}", dec(*spec))
        self.block9 = enc(24, 16, 2, True)
        self.conv15 = _BnReluConv(16, 1, 1)

    @staticmethod
    def _run(blocks, x):
        for b in blocks:
            x = b(x)
        return x

    def forward(self, x):
        x0 = self._run(self.block0, x)
        x1 = self._run(self.block1, x0)
        x2 = self._run(self.block2, x1)
        x3 = self._run(self.block3, x2)
        x4 = self._run(self.block4, x3)
        res1 = x3 + self._run(self.block5, x4)
        res2 = x2 + self._run(self.block6, res1)
        res3 = x1 + self._run(self.block7, res2)
        res4 = x0 + self._run(self.block8, res3)
        return self.conv15(self._run(self.block9, res4))


_REPS = {"block0": 2, "block1": 3, "block2": 5, "block3": 7, "block4": 12,
         "block5": 7, "block6": 5, "block7": 3, "block8": 2, "block9": 2}


def convert_manga_line_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """erika.pth (torch res_skip) state dict → the module's paths (JAX leaf
    names, torch layouts). The identity res1-res4 shortcuts carry no params;
    1×1 shortcuts inside blocks map to ``.shortcut``."""
    out = {}

    def put_brc(t, j):
        out[f"{j}.bn_scale"] = sd[f"{t}.0.weight"]
        out[f"{j}.bn_bias"] = sd[f"{t}.0.bias"]
        out[f"{j}.bn_mean"] = sd[f"{t}.0.running_mean"]
        out[f"{j}.bn_var"] = sd[f"{t}.0.running_var"]
        out[f"{j}.kernel"] = sd[f"{t}.2.weight"]
        out[f"{j}.bias"] = sd[f"{t}.2.bias"]

    for blk, n in _REPS.items():
        for i in range(n):
            t, j = f"{blk}.model.{i}", f"{blk}.{i}"
            put_brc(f"{t}.conv1.model", f"{j}.conv1")
            put_brc(f"{t}.residual.model", f"{j}.residual")
            if f"{t}.shortcut.model.0.weight" in sd:
                out[f"{j}.shortcut.kernel"] = sd[f"{t}.shortcut.model.0.weight"]
                out[f"{j}.shortcut.bias"] = sd[f"{t}.shortcut.model.0.bias"]
    put_brc("conv15.model", "conv15")
    return out


@preprocessor_registry.register("manga_line", aliases=("LineartMangaDetector", "lineart_manga"))
class MangaLinePreprocessor(BasePreprocessor):
    """Manga / screentone line extraction (reference manga_line/__init__.py).
    Weights: ``erika.pth`` in the preprocessor models dir."""

    name = "manga_line"
    params_schema = {"detect_resolution": 512}

    def __init__(self, model: Optional[MangaLineModel] = None):
        self.model = model

    def setup(self) -> None:
        if self.model is None:
            from apex_studio_tpu_torch.preprocess.weights import load_detector

            self.model = load_detector(
                MangaLineModel, "manga_line", "erika.pth",
                lambda sd: convert_manga_line_keys({k.replace("module.", ""): v for k, v in sd.items()}),
                self.device)

    @torch.no_grad()
    def process_frame(self, frame: Frame, detect_resolution: int = 512, **_) -> Frame:
        import cv2

        h, w = frame.shape[:2]
        size = 256 * int(np.ceil(detect_resolution / 256.0))
        img = cv2.resize(frame, (size, size), interpolation=cv2.INTER_CUBIC)
        gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY).astype(np.float32)
        dev = next(self.model.parameters()).device
        line = self.model(torch.from_numpy(gray)[None, :, :, None].to(dev))[0, :, :, 0].cpu().numpy()
        out = 255 - np.clip(line, 0, 255).astype(np.uint8)  # __init__.py:82 inversion
        out = cv2.resize(out, (w, h), interpolation=cv2.INTER_CUBIC)
        return np.stack([out] * 3, axis=-1)
