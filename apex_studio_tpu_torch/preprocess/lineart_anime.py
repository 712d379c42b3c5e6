"""Anime lineart, the pix2pix U-Net generator (port of
``apex_studio_tpu/preprocess/lineart_anime.py``): 8 levels of 4×4 stride-2
convs down, non-affine instance norms, LeakyReLU(0.2) descending and ReLU
ascending, 4×4 stride-2 transposed convs up with channel-concat skips, a tanh
head; NHWC at every function as in the JAX module and with its attribute
names (``loaders/from_jax.py`` carries its parameters). The published
``netG.pth`` loads through ``convert_lineart_anime_keys`` strictly.

The JAX ``_Up`` keeps the published ``[in, out, 4, 4]`` kernel as ``w`` and
runs ``lax.conv_transpose(..., transpose_kernel=True)``, which is torch's
``conv_transpose2d`` with that weight (``jax_w_torch_layout``). The wrapper
feeds ±1 RGB at a multiple of 256 square and inverts the output. The network
runs in f32 on ``device`` (``None`` is the card), its transposed
convolutions with cuDNN's deterministic algorithms. Departure: a missing
checkpoint raises ``FileNotFoundError``, where the JAX preprocessor runs
random weights.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.device import cudnn_deterministic
from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_anything import _lecun, conv2d_nhwc
from apex_studio_tpu_torch.preprocess.lineart_model import instance_norm


class _Down(nn.Module):
    """4×4 stride-2 conv (biased — instance-norm branch of the reference)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = _lecun(cout, cin, 4, 4, fan_in=16 * cin)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return conv2d_nhwc(x, self.weight, self.bias, 2, 1)


class _Up(nn.Module):
    """ConvTranspose2d(k4, s2, p1), ``weight`` [in, out, 4, 4]."""

    jax_w_torch_layout = True

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = _lecun(cin, cout, 4, 4, fan_in=16 * cin)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        with cudnn_deterministic():
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias, stride=2, padding=1)
        return y.permute(0, 2, 3, 1)


class LineartAnimeGenerator(nn.Module):
    """UnetGenerator(3, 1, num_downs=8, ngf=64). NHWC ±1 → NHWC 1ch ±1."""

    # (cin, cout) per descent level, outermost first
    _DOWN = [(3, 64), (64, 128), (128, 256), (256, 512), (512, 512), (512, 512), (512, 512), (512, 512)]

    def __init__(self):
        super().__init__()
        self.downs = nn.ModuleList([_Down(a, b) for a, b in self._DOWN])
        # innermost has no skip concat
        self.ups = nn.ModuleList([_Up(b if i == 0 else 2 * b, a if i < 7 else 1)
                                  for i, (a, b) in enumerate(reversed(self._DOWN))])

    def forward(self, x):
        feats: List[torch.Tensor] = []
        h = x
        for i, down in enumerate(self.downs):
            if i > 0:
                h = torch.where(h >= 0, h, 0.2 * h)  # LeakyReLU before conv
            h = down(h)
            if 0 < i < len(self.downs) - 1:
                h = instance_norm(h)
            feats.append(h)
        # ascend: innermost block has no skip; others concat [skip, up(h)]
        h = feats[-1]
        for i, up in enumerate(self.ups):
            h = up(F.relu(h))
            if i < len(self.ups) - 1:
                h = torch.cat([feats[len(self.ups) - 2 - i], instance_norm(h)], dim=-1)
        return torch.tanh(h)


def _prefixes() -> List[str]:
    """The nested UnetSkipConnectionBlock prefix of each depth: L0 =
    "model.", then +"model.1." (the outermost submodule slot), then
    +"model.3." per mid level."""
    out = ["model."]
    for depth in range(1, 8):
        out.append(out[-1] + ("model.1." if depth == 1 else "model.3."))
    return out


def _slots(depth: int):
    """(down, up) Sequential indices within a level: outermost [0, 3], mid
    [1, 5], innermost [1, 3]."""
    return (0, 3) if depth == 0 else (1, 3) if depth == 7 else (1, 5)


def convert_lineart_anime_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """netG.pth nested UnetSkipConnectionBlock keys → the flat down / up
    lists (JAX leaf names, torch layouts; a transposed conv's weight under
    the port's name)."""
    out = {}
    for depth, pref in enumerate(_prefixes()):
        down_i, up_i = _slots(depth)
        for src, dst, leaf in ((f"{pref}model.{down_i}", f"downs.{depth}", "kernel"),
                               (f"{pref}model.{up_i}", f"ups.{7 - depth}", "weight")):
            out[f"{dst}.{leaf}"] = sd[f"{src}.weight"]
            out[f"{dst}.bias"] = sd[f"{src}.bias"]
    return out


@preprocessor_registry.register("lineart_anime", aliases=("LineartAnimeDetector",))
class LineartAnimePreprocessor(BasePreprocessor):
    """Black-on-white anime line art. Weights: ``netG.pth`` in the
    preprocessor models dir."""

    name = "lineart_anime"
    params_schema = {"detect_resolution": 512}

    def __init__(self, model: Optional[LineartAnimeGenerator] = None):
        self.model = model

    def setup(self) -> None:
        if self.model is None:
            from apex_studio_tpu_torch.preprocess.weights import load_detector

            self.model = load_detector(
                LineartAnimeGenerator, "lineart_anime", "netG.pth",
                lambda sd: convert_lineart_anime_keys({k.replace("module.", ""): v for k, v in sd.items()}),
                self.device)

    @torch.no_grad()
    def process_frame(self, frame: Frame, detect_resolution: int = 512, **_) -> Frame:
        import cv2

        h, w = frame.shape[:2]
        size = 256 * int(np.ceil(detect_resolution / 256.0))
        img = cv2.resize(frame, (size, size), interpolation=cv2.INTER_CUBIC)
        dev = next(self.model.parameters()).device
        x = torch.from_numpy(img.astype(np.float32) / 127.5 - 1.0)[None].to(dev)
        line = self.model(x)[0, :, :, 0].cpu().numpy() * 127.5 + 127.5
        out = 255 - cv2.resize(np.clip(line, 0, 255).astype(np.uint8), (w, h), interpolation=cv2.INTER_AREA)
        return np.stack([out] * 3, axis=-1)
