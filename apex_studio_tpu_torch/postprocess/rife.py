"""RIFE, learned video frame interpolation (port of
``apex_studio_tpu/postprocess/rife.py``).

The IFNet v4-family architecture: coarse-to-fine IFBlocks predict
bidirectional flow and a fusion mask at scales 8/4/2/1, each block refining
the flow of the one before on frames warped by it. The JAX module computes in
NHWC; this one in NCHW, in f32, with the same arithmetic:

- ``resize_half_pixel`` is ``jax.image.resize(..., "bilinear")``, whose
  ``antialias`` is on: when it downsamples, the triangle kernel widens by the
  factor, so it is not ``F.interpolate(mode="bilinear")``. It is computed as
  JAX computes it (``utils/jax_resize.py``), one weight matrix per spatial
  axis.
- ``flow_warp`` clamps the sample coordinates to the border and gathers the
  four neighbours, as the JAX function does (not ``grid_sample``).
- ``Deconv2x`` is ``ConvTranspose2d(k=4, s=2, p=1)`` with its weight in
  torch's layout ``[in, out, 4, 4]``; the JAX module stores the same kernel
  spatially flipped in HWIO (loaders/from_jax.py undoes that).
  On the card it runs with ``cudnn.deterministic``: cuDNN computes a
  transposed convolution as a convolution's backward-data pass, whose default
  algorithm sums with atomics, so two identical calls could differ by a uint8
  level (62 of the 2.2e7 values of eight interpolated 720×1280 frames on an
  H100); with it a served interpolation is reproducible.

Checkpoints are Practical-RIFE's ``flownet`` state dicts, read from the
preprocessor models directory as ``rife_v4.{safetensors,pth,pt,bin,pkl}``;
there is no download, an absent file raises ``FileNotFoundError``.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.device import cudnn_deterministic
from apex_studio_tpu_torch.postprocess.base import BasePostprocessor, postprocessor_registry
from apex_studio_tpu_torch.utils.jax_resize import resize as resize_like_jax
from apex_studio_tpu_torch.utils.progress import safe_emit_progress

logger = logging.getLogger("apex.postprocess.rife")

_EXTS = (".safetensors", ".pth", ".pt", ".bin", ".pkl")


@dataclasses.dataclass
class RIFEConfig:
    widths: Tuple[int, ...] = (192, 128, 96, 64)
    scales: Tuple[int, ...] = (8, 4, 2, 1)
    res_blocks: int = 8

    @classmethod
    def tiny(cls) -> "RIFEConfig":
        return cls(widths=(16, 12), scales=(2, 1), res_blocks=2)


class PReLU(nn.Module):
    def __init__(self, channels: int, init: float = 0.2):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), init, dtype=torch.float32))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight[:, None, None] * x)


class ConvPReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding)
        self.act = PReLU(cout)

    def forward(self, x):
        return self.act(self.conv(x))


class ResConv(nn.Module):
    """conv(x)·beta + x through a PReLU, the IFBlock residual unit."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, 1, 1)
        self.beta = nn.Parameter(torch.ones(c, dtype=torch.float32))
        self.act = PReLU(c)

    def forward(self, x):
        return self.act(self.conv(x) * self.beta[:, None, None] + x)


class Deconv2x(nn.Module):
    """``ConvTranspose2d(cin, cout, 4, stride=2, padding=1)``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 4, 4, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=torch.float32))
        nn.init.normal_(self.weight, std=(1.0 / (cin * 16)) ** 0.5)

    def forward(self, x):
        with cudnn_deterministic():
            return F.conv_transpose2d(x, self.weight, self.bias, stride=2, padding=1)


def pixel_shuffle2(x: torch.Tensor) -> torch.Tensor:
    """torch ``PixelShuffle(2)``: channel c·4 + i·2 + j → (2h+i, 2w+j)."""
    return F.pixel_shuffle(x, 2)


def resize_half_pixel(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, h, w, C), "bilinear")`` on NCHW: a spatial
    axis whose size does not change is left as it is."""
    return resize_like_jax(x, (*x.shape[:2], h, w), "bilinear")


def flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp: sample ``img`` [B, C, H, W] at (x + flow_x, y + flow_y)
    (``flow`` [B, 2, H, W]), bilinear, coordinates clamped to the border."""
    b, c, h, w = img.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device), indexing="ij")
    px = (xs[None] + flow[:, 0]).clamp(0.0, w - 1.0)
    py = (ys[None] + flow[:, 1]).clamp(0.0, h - 1.0)
    x0 = torch.floor(px).to(torch.int64)
    y0 = torch.floor(py).to(torch.int64)
    x1 = (x0 + 1).clamp_max(w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    fx = (px - x0)[:, None]
    fy = (py - y0)[:, None]
    flat = img.reshape(b, c, h * w)

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(flat, 2, idx).reshape(b, c, h, w)

    top = gather(y0, x0) * (1 - fx) + gather(y0, x1) * fx
    bot = gather(y1, x0) * (1 - fx) + gather(y1, x1) * fx
    return top * (1 - fy) + bot * fy


class IFBlock(nn.Module):
    def __init__(self, cin: int, c: int, res_blocks: int):
        super().__init__()
        self.conv0 = nn.ModuleList([ConvPReLU(cin, c // 2, 3, 2, 1), ConvPReLU(c // 2, c, 3, 2, 1)])
        self.convblock = nn.ModuleList([ResConv(c) for _ in range(res_blocks)])
        self.lastconv = Deconv2x(c, 4 * 6)

    def forward(self, x, flow, scale: int):
        h, w = x.shape[2], x.shape[3]
        sx = resize_half_pixel(x, h // scale, w // scale)
        if flow is not None:
            sf = resize_half_pixel(flow, h // scale, w // scale) / scale
            sx = torch.cat([sx, sf], dim=1)
        feat = self.conv0[1](self.conv0[0](sx))
        for rc in self.convblock:
            feat = rc(feat)
        tmp = resize_half_pixel(pixel_shuffle2(self.lastconv(feat)), h, w)
        return tmp[:, :4] * scale, tmp[:, 4:5]


class IFNet(nn.Module):
    """img0, img1 [B, 3, H, W] in [0, 1], a timestep in (0, 1) → the frame
    between them, [B, 3, H, W] in [0, 1]. H and W must be multiples of 32."""

    config_class = RIFEConfig

    def __init__(self, cfg: RIFEConfig = RIFEConfig(), *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        # block 0 sees the two frames and t; the others add the mask and 4 flow channels
        self.blocks = nn.ModuleList([IFBlock(7 if i == 0 else 8 + 4, c, cfg.res_blocks)
                                     for i, c in enumerate(cfg.widths)])

    def forward(self, img0: torch.Tensor, img1: torch.Tensor, timestep) -> torch.Tensor:
        b, _, h, w = img0.shape
        t = torch.full((b, 1, h, w), float(np.float32(timestep)), dtype=torch.float32, device=img0.device)
        flow = mask = None
        warped0, warped1 = img0, img1
        for blk, scale in zip(self.blocks, self.cfg.scales):
            if flow is None:
                flow, mask = blk(torch.cat([img0, img1, t], dim=1), None, scale)
            else:
                d_flow, d_mask = blk(torch.cat([warped0, warped1, t, mask], dim=1), flow, scale)
                flow = flow + d_flow
                mask = mask + d_mask
            warped0 = flow_warp(img0, flow[:, :2])
            warped1 = flow_warp(img1, flow[:, 2:4])
        m = torch.sigmoid(mask)
        return (warped0 * m + warped1 * (1 - m)).clamp(0.0, 1.0)


def convert_rife_keys(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Practical-RIFE ``flownet`` keys → the port's parameter paths, with
    conv weights under ``.kernel`` (loaders/state_mapping.py maps it to
    ``.weight``; the layouts are torch's on both sides). Handles the
    ``module.`` DataParallel prefix, PReLU slopes where present, beta
    ``[1, C, 1, 1]``, and drops the training-time ``contextnet``/``unet``
    and teacher block. The ConvTranspose weight keeps its layout."""
    out: Dict[str, Any] = {}
    flat = lambda v: v.reshape(-1)  # noqa: E731
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if not k.startswith("block"):
            continue
        parts = k.split(".")
        bi = parts[0][5:]  # block0 / block1 / …
        if bi == "_tea":
            continue
        path = f"blocks.{bi}"
        if parts[1] == "conv0":
            i, sub, leaf = int(parts[2]), parts[3], parts[4]
            if sub == "0":
                out[f"{path}.conv0.{i}.conv.{'kernel' if leaf == 'weight' else 'bias'}"] = v
            else:  # PReLU slope
                out[f"{path}.conv0.{i}.act.weight"] = flat(v)
        elif parts[1] == "convblock":
            i, rest = int(parts[2]), parts[3:]
            if rest[0].isdigit():  # Sequential(conv, PReLU) variant
                if rest[0] == "0":
                    out[f"{path}.convblock.{i}.conv.{'kernel' if rest[-1] == 'weight' else 'bias'}"] = v
                else:
                    out[f"{path}.convblock.{i}.act.weight"] = flat(v)
            elif rest[0] == "conv":
                sub = rest[1] if len(rest) == 3 else None
                if sub in (None, "0"):
                    out[f"{path}.convblock.{i}.conv.{'kernel' if rest[-1] == 'weight' else 'bias'}"] = v
                else:
                    out[f"{path}.convblock.{i}.act.weight"] = flat(v)
            elif rest[0] == "beta":
                out[f"{path}.convblock.{i}.beta"] = flat(v)
            elif rest[0] in ("relu", "prelu"):
                out[f"{path}.convblock.{i}.act.weight"] = flat(v)
        elif parts[1] == "lastconv":
            if parts[-1] == "weight" and v.ndim == 4:
                out[f"{path}.lastconv.weight"] = v
            elif parts[-1] == "bias":
                out[f"{path}.lastconv.bias"] = v
    return out


def find_local(stem: str, root: Optional[Path] = None) -> Optional[Path]:
    """``<root>/<stem><ext>`` for the first extension present, else None;
    ``root`` defaults to the preprocessor models directory."""
    from apex_studio_tpu_torch.utils.defaults import get_preprocessor_models_path

    root = root or get_preprocessor_models_path()
    for ext in _EXTS:
        p = root / f"{stem}{ext}"
        if p.exists():
            return p
    return None


def load_rife(path: Path, device, cfg: RIFEConfig = RIFEConfig()) -> IFNet:
    """IFNet with the ``flownet`` checkpoint at ``path`` on ``device``. Every
    parameter must come from the file except PReLU slopes: checkpoints of the
    LeakyReLU(0.2) variants have none and keep the initial 0.2."""
    from apex_studio_tpu_torch.loaders.safetensors_io import load_safetensors, load_torch_checkpoint
    from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict

    path = Path(path)
    sd = load_safetensors(path) if path.suffix == ".safetensors" else load_torch_checkpoint(path)
    model = IFNet(cfg).to(device)
    missing, unexpected = apply_state_dict(model, convert_rife_keys(sd), strict=False)
    missing = [k for k in missing if not k.endswith(".act.weight")]
    if missing or unexpected:
        raise KeyError(f"{path}: RIFE checkpoint mismatch: missing {missing[:8]}, unexpected {unexpected[:8]}")
    return model.eval().requires_grad_(False)


@postprocessor_registry.register("rife_v4")
class RIFEPostprocessor(BasePostprocessor):
    """Learned frame interpolation. Params: ``multiplier`` (int ≥ 2): that many
    frames per input pair. Weights: ``rife_v4.*`` in the preprocessor models
    directory, unless a ``model`` is given."""

    name = "rife_v4"

    def __init__(self, model: Optional[IFNet] = None, device=None):
        from apex_studio_tpu_torch.device import resolve_device

        super().__init__(device=device)
        self.device = resolve_device(device) if model is None else next(model.parameters()).device
        self._model = model

    def setup(self) -> None:
        if self._model is not None:
            return
        local = find_local("rife_v4")
        if local is None:
            from apex_studio_tpu_torch.utils.defaults import get_preprocessor_models_path

            raise FileNotFoundError(f"no checkpoint 'rife_v4.*' under {get_preprocessor_models_path()}; "
                                    "place the published flownet checkpoint there")
        if self.device.type == "cuda":
            from apex_studio_tpu_torch.engine.base import configure_float32_matmul

            configure_float32_matmul()
        self._model = load_rife(local, self.device)

    @torch.inference_mode()
    def _pair(self, a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
        h, w = a.shape[:2]
        # pad to a multiple of 32 (the scale-8 block downsamples by 32 in all)
        ph, pw = -h % 32, -w % 32
        i0 = np.pad(a, ((0, ph), (0, pw), (0, 0)), mode="edge")
        i1 = np.pad(b, ((0, ph), (0, pw), (0, 0)), mode="edge")
        dev = self.device
        x0 = torch.from_numpy(i0).to(dev).permute(2, 0, 1)[None].float() / 255.0
        x1 = torch.from_numpy(i1).to(dev).permute(2, 0, 1)[None].float() / 255.0
        out = self._model(x0, x1, t)
        img = out[0, :, :h, :w].permute(1, 2, 0).cpu().numpy() * 255.0
        return np.clip(img + 0.5, 0, 255).astype(np.uint8)

    def __call__(self, frames: Sequence[np.ndarray], progress_callback=None,
                 multiplier: int = 2, **_: Any) -> List[np.ndarray]:
        frames = list(frames)
        if len(frames) < 2 or multiplier < 2:
            return frames
        self.setup()
        out: List[np.ndarray] = []
        n_pairs = len(frames) - 1
        for i in range(n_pairs):
            out.append(frames[i])
            for j in range(1, multiplier):
                out.append(self._pair(frames[i], frames[i + 1], j / multiplier))
            safe_emit_progress(progress_callback, (i + 1) / n_pairs,
                               f"interpolated pair {i + 1}/{n_pairs}")
        out.append(frames[-1])
        return out
