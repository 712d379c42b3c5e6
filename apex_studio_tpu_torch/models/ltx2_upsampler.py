"""LTX-2 latent upsampler, port of ``apex_studio_tpu/models/ltx2_upsampler.py``.

The convolutional latent super-resolver between LTX-2's two stages: stage 1
denoises at the base resolution, the upsampler lifts the latent grid, a
short stage 2 denoises the lifted latents at a few distilled sigmas.

- an initial 3×3(×3) conv, GroupNorm(32), SiLU;
- ``num_blocks_per_stage`` ResBlocks (conv, GN, SiLU, conv, GN, SiLU(h + x));
- one of: ``SpatialRationalResampler`` (per frame, a learned pixel-shuffle up
  by ``num``, then a fixed 5×5 binomial blur with stride ``den``), a plain 2×
  spatial pixel shuffle, a temporal 2× shuffle (the first frame dropped
  after), or a joint 2×2×2 shuffle;
- the mirrored ResBlocks and a final conv back to the latent channels.

``upsample_latents`` denormalises with the video VAE's per-channel
statistics, runs the upsampler and normalises again. NCFHW throughout.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.registry import helper_registry

_RATIONAL = {0.75: (3, 4), 1.5: (3, 2), 2.0: (2, 1), 4.0: (4, 1)}


@dataclass
class LTX2UpsamplerConfig:
    in_channels: int = 128
    mid_channels: int = 512
    num_blocks_per_stage: int = 4
    dims: int = 3
    spatial_upsample: bool = True
    temporal_upsample: bool = False
    spatial_scale: float = 2.0
    rational_resampler: bool = True

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LTX2UpsamplerConfig":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


class _Conv(nn.Module):
    """A zero-padded 3×3 (2-D) or 3×3×3 (3-D) conv over NC(F)HW input."""

    def __init__(self, in_ch: int, out_ch: int, *, dims: int = 3, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *(3,) * dims, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_ch, dtype=dtype))
        self.dims = dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = F.conv3d if self.dims == 3 else F.conv2d
        return conv(x.to(self.weight.dtype), self.weight, self.bias, padding=1)


class _GroupNorm(nn.Module):
    """GroupNorm(32) over the channel axis, in f32 (parameters ``scale`` / ``bias``)."""

    def __init__(self, ch: int, *, groups: int = 32, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(ch, dtype=dtype))
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, x.shape[1]) + (1,) * (x.ndim - 2)
        y = F.group_norm(x.float(), self.groups, eps=1e-5)
        return (y * self.scale.float().reshape(shape) + self.bias.float().reshape(shape)).to(x.dtype)


class ResBlock(nn.Module):
    def __init__(self, ch: int, *, dims: int = 3, dtype=torch.float32):
        super().__init__()
        self.conv1 = _Conv(ch, ch, dims=dims, dtype=dtype)
        self.norm1 = _GroupNorm(ch, dtype=dtype)
        self.conv2 = _Conv(ch, ch, dims=dims, dtype=dtype)
        self.norm2 = _GroupNorm(ch, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.norm1(self.conv1(x)))
        return F.silu(self.norm2(self.conv2(h)) + x)


def _pixel_shuffle_2d(x: torch.Tensor, p: int) -> torch.Tensor:
    """b (c p1 p2) h w → b c (h p1) (w p2)."""
    b, cpp, h, w = x.shape
    c = cpp // (p * p)
    return x.reshape(b, c, p, p, h, w).permute(0, 1, 4, 2, 5, 3).reshape(b, c, h * p, w * p)


def _pixel_shuffle_3d(x: torch.Tensor, p: int) -> torch.Tensor:
    """b (c p p p) f h w → b c (f p) (h p) (w p)."""
    b, cp3, f, h, w = x.shape
    c = cp3 // p ** 3
    return x.reshape(b, c, p, p, p, f, h, w).permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(b, c, f * p, h * p, w * p)


def _pixel_shuffle_temporal(x: torch.Tensor, p: int) -> torch.Tensor:
    """b (c p) f h w → b c (f p) h w."""
    b, cp, f, h, w = x.shape
    return x.reshape(b, cp // p, p, f, h, w).permute(0, 1, 3, 2, 4, 5).reshape(b, cp // p, f * p, h, w)


def _binomial_kernel(k: int) -> np.ndarray:
    row = np.array([math.comb(k - 1, i) for i in range(k)], np.float64)
    k2d = np.outer(row, row)
    return (k2d / k2d.sum()).astype(np.float32)


def _blur_downsample_2d(x: torch.Tensor, stride: int, k: int = 5) -> torch.Tensor:
    """Depthwise binomial anti-alias blur with ``stride``."""
    if stride == 1:
        return x
    c = x.shape[1]
    w = torch.from_numpy(_binomial_kernel(k)).to(x.device)[None, None].expand(c, 1, k, k)
    return F.conv2d(x.float(), w, stride=stride, padding=k // 2, groups=c).to(x.dtype)


class SpatialRationalResampler(nn.Module):
    """Per frame: a learned up by ``num`` (conv → pixel shuffle), then the
    fixed anti-aliased down by ``den``; the time axis is untouched."""

    def __init__(self, mid_channels: int, scale: float, *, dtype=torch.float32):
        super().__init__()
        if float(scale) not in _RATIONAL:
            raise ValueError(f"unsupported scale {scale}")
        self.num, self.den = _RATIONAL[float(scale)]
        self.conv = _Conv(mid_channels, self.num ** 2 * mid_channels, dims=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, f, h, w = x.shape
        x = x.transpose(1, 2).reshape(b * f, c, h, w)
        x = _blur_downsample_2d(_pixel_shuffle_2d(self.conv(x), self.num), self.den)
        return x.reshape(b, f, c, *x.shape[-2:]).transpose(1, 2)


@helper_registry.register("ltx2.upsampler", aliases=("LTXLatentUpsamplerModel", "latent_upsampler"))
class LTXLatentUpsampler(nn.Module):
    """The latent-space super-resolver, NCFHW → NCFHW."""

    config_class = LTX2UpsamplerConfig

    def __init__(self, cfg: Optional[LTX2UpsamplerConfig] = None, *, dtype=torch.float32):
        super().__init__()
        cfg = cfg or LTX2UpsamplerConfig()
        self.cfg = cfg
        self.dtype = dtype
        d, m = cfg.dims, cfg.mid_channels
        self.initial_conv = _Conv(cfg.in_channels, m, dims=d, dtype=dtype)
        self.initial_norm = _GroupNorm(m, dtype=dtype)
        self.res_blocks = nn.ModuleList([ResBlock(m, dims=d, dtype=dtype) for _ in range(cfg.num_blocks_per_stage)])
        if cfg.spatial_upsample and cfg.temporal_upsample:
            self.upsampler_conv = _Conv(m, 8 * m, dims=3, dtype=dtype)
        elif cfg.spatial_upsample:
            if cfg.rational_resampler:
                self.upsampler = SpatialRationalResampler(m, cfg.spatial_scale, dtype=dtype)
            else:
                self.upsampler_conv = _Conv(m, 4 * m, dims=2, dtype=dtype)
        elif cfg.temporal_upsample:
            self.upsampler_conv = _Conv(m, 2 * m, dims=3, dtype=dtype)
        else:
            raise ValueError("spatial_upsample or temporal_upsample required")
        self.post_upsample_res_blocks = nn.ModuleList([ResBlock(m, dims=d, dtype=dtype)
                                                       for _ in range(cfg.num_blocks_per_stage)])
        self.final_conv = _Conv(m, cfg.in_channels, dims=d, dtype=dtype)

    @staticmethod
    def _per_frame(fn, x: torch.Tensor) -> torch.Tensor:
        b, c, f, h, w = x.shape
        y = fn(x.transpose(1, 2).reshape(b * f, c, h, w))
        return y.reshape(b, f, *y.shape[1:]).transpose(1, 2)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.dims == 2:
            x = self._per_frame(lambda z: F.silu(self.initial_norm(self.initial_conv(z))), latent)
            for blk in self.res_blocks:
                x = self._per_frame(blk, x)
        else:
            x = F.silu(self.initial_norm(self.initial_conv(latent)))
            for blk in self.res_blocks:
                x = blk(x)

        if cfg.spatial_upsample and cfg.temporal_upsample:
            x = _pixel_shuffle_3d(self.upsampler_conv(x), 2)
        elif cfg.temporal_upsample:
            # the first upsampled frame stands for a single pixel frame: dropped
            x = _pixel_shuffle_temporal(self.upsampler_conv(x), 2)[:, :, 1:]
        elif cfg.rational_resampler:
            x = self.upsampler(x)
        else:
            x = self._per_frame(lambda z: _pixel_shuffle_2d(self.upsampler_conv(z), 2), x)

        if cfg.dims == 2:
            for blk in self.post_upsample_res_blocks:
                x = self._per_frame(blk, x)
            return self._per_frame(self.final_conv, x)
        for blk in self.post_upsample_res_blocks:
            x = blk(x)
        return self.final_conv(x)


def upsample_latents(latents: torch.Tensor, vae, upsampler) -> torch.Tensor:
    """Denormalise with the video VAE's per-channel statistics, upsample,
    normalise again."""
    m, s = vae.mean_std(latents.device)
    z = latents if m is None else latents * s + m
    z = upsampler(z.float())
    return z if m is None else (z - m) / s
