"""TAEHV tiny video autoencoder (the HunyuanVideo 1.5 "light VAE" that decodes
previews), port of ``TAEVAE`` in ``apex_studio_tpu/models/vaes/tae_vae.py``.

- per-frame 3×3 convs on [B, T, C, H, W];
- MemBlock: convs over concat(x, the previous frame's x), zero at t=0;
- TPool(s) merges s consecutive frames by a 1×1 conv over s·C channels, TGrow(s)
  splits a 1×1 conv's s·C channels into s frames; encode pads the clip at the
  end to a multiple of 4 by repeating the last frame;
- the decoder output drops the first ``frames_to_trim = 2^(#time upscales) − 1``
  frames, so T latent frames give 4(T−1)+1 video frames;
- ``out_range``: "unit" maps the native [0, 1] to [-1, 1], "sym" clamps to
  [-1, 1] (HunyuanVideo 1.5).

Layer indices follow the published ``nn.Sequential`` exactly, so the
``tae_vae`` key converter is regex-only. Not ported: the identity-deepened
decoder-only ``tiny_wan`` variant and FlashVSR's conditioning input.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.registry import vae_registry


@dataclasses.dataclass
class TAEConfig:
    latent_channels: int = 16
    channels: Tuple[int, ...] = (256, 128, 64, 64)
    patch_size: int = 1
    act: str = "relu"  # "relu" | "leaky_relu" (hy15 uses LeakyReLU(0.2))
    decoder_time_upscale: Tuple[bool, ...] = (True, True)
    decoder_space_upscale: Tuple[bool, ...] = (True, True, True)
    deepen: int = 0
    decoder_only: bool = False
    out_range: str = "unit"
    scaling_factor: float = 1.0
    latents_mean: Optional[Tuple[float, ...]] = None
    latents_std: Optional[Tuple[float, ...]] = None

    @classmethod
    def from_dict(cls, cfg: dict) -> "TAEConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "z_dim" in cfg:
            kw["latent_channels"] = cfg["z_dim"]
        for key in ("channels", "decoder_time_upscale", "decoder_space_upscale",
                    "latents_mean", "latents_std"):
            if kw.get(key) is not None:
                kw[key] = tuple(kw[key])
        return cls(**kw)

    @property
    def spatial_scale(self) -> int:
        return self.patch_size * int(np.prod([2 if u else 1 for u in self.decoder_space_upscale]))

    @property
    def temporal_scale(self) -> int:
        return int(np.prod([2 if u else 1 for u in self.decoder_time_upscale]))


def _act(cfg: TAEConfig, x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2) if cfg.act == "leaky_relu" else F.relu(x)


class TConv(nn.Module):
    """Per-frame 2D conv on [B, T, C, H, W]."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1, bias: bool = True, *, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(cout, dtype=torch.float32)) if bias else None
        self.stride = stride
        self.pad = k // 2
        self.dtype = dtype

    def forward(self, x):
        b, t = x.shape[:2]
        y = F.conv2d(x.reshape(b * t, *x.shape[2:]).to(self.dtype), self.weight.to(self.dtype),
                     stride=self.stride, padding=self.pad)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y.reshape(b, t, *y.shape[1:])


class TClamp(nn.Module):
    def forward(self, x):
        return torch.tanh(x / 3.0) * 3.0


class TActLayer(nn.Module):
    def __init__(self, cfg: TAEConfig):
        super().__init__()
        self._cfg = cfg

    def forward(self, x):
        return _act(self._cfg, x)


class TUpsample(nn.Module):
    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        if self.factor == 1:
            return x
        return x.repeat_interleave(self.factor, dim=-2).repeat_interleave(self.factor, dim=-1)


class TMem(nn.Module):
    """MemBlock: a conv stack over concat(x, the previous frame's x)."""

    def __init__(self, cin: int, cout: int, cfg: TAEConfig, *, dtype):
        super().__init__()
        self.conv_0 = TConv(cin * 2, cout, dtype=dtype)
        self.conv_2 = TConv(cout, cout, dtype=dtype)
        self.conv_4 = TConv(cout, cout, dtype=dtype)
        self.skip = TConv(cin, cout, k=1, bias=False, dtype=dtype) if cin != cout else None
        self._cfg = cfg

    def forward(self, x):
        past = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
        h = self.conv_0(torch.cat([x, past], dim=2))
        h = self.conv_2(_act(self._cfg, h))
        h = self.conv_4(_act(self._cfg, h))
        s = self.skip(x) if self.skip is not None else x
        return _act(self._cfg, h + s)


class TPool(nn.Module):
    def __init__(self, n_f: int, stride: int, *, dtype):
        super().__init__()
        self.conv = TConv(n_f * stride, n_f, k=1, bias=False, dtype=dtype)
        self.stride = stride

    def forward(self, x):
        b, t, c, h, w = x.shape
        return self.conv(x.reshape(b, t // self.stride, self.stride * c, h, w))


class TGrow(nn.Module):
    def __init__(self, n_f: int, stride: int, *, dtype):
        super().__init__()
        self.conv = TConv(n_f, n_f * stride, k=1, bias=False, dtype=dtype)
        self.stride = stride

    def forward(self, x):
        y = self.conv(x)
        b, t, cs, h, w = y.shape
        return y.reshape(b, t * self.stride, cs // self.stride, h, w)


def _build_decoder(cfg: TAEConfig, dtype) -> list:
    n_f = cfg.channels
    kw = dict(dtype=dtype)

    def stage(i, cin, time_up: bool, space_up: bool, cout):
        return [TMem(cin, cin, cfg, **kw), TMem(cin, cin, cfg, **kw), TMem(cin, cin, cfg, **kw),
                TUpsample(2 if space_up else 1), TGrow(cin, 2 if time_up else 1, **kw),
                TConv(cin, cout, bias=False, **kw)]

    return [
        TClamp(), TConv(cfg.latent_channels, n_f[0], **kw), TActLayer(cfg),
        *stage(0, n_f[0], False, cfg.decoder_space_upscale[0], n_f[1]),
        *stage(1, n_f[1], cfg.decoder_time_upscale[0], cfg.decoder_space_upscale[1], n_f[2]),
        *stage(2, n_f[2], cfg.decoder_time_upscale[1], cfg.decoder_space_upscale[2], n_f[3]),
        TActLayer(cfg), TConv(n_f[3], 3 * cfg.patch_size ** 2, **kw),
    ]


def _build_encoder(cfg: TAEConfig, dtype) -> list:
    kw = dict(dtype=dtype)
    f = 64

    def stage(pool_stride):
        return [TPool(f, pool_stride, **kw), TConv(f, f, stride=2, bias=False, **kw),
                TMem(f, f, cfg, **kw), TMem(f, f, cfg, **kw), TMem(f, f, cfg, **kw)]

    return [TConv(3 * cfg.patch_size ** 2, f, **kw), TActLayer(cfg),
            *stage(2), *stage(2), *stage(1), TConv(f, cfg.latent_channels, **kw)]


def _pixel_unshuffle(x, p: int):
    """[B,T,C,H,W] → [B,T,C·p·p,H/p,W/p], torch's channel order (c, ph, pw)."""
    b, t = x.shape[:2]
    y = F.pixel_unshuffle(x.reshape(b * t, *x.shape[2:]), p)
    return y.reshape(b, t, *y.shape[1:])


def _pixel_shuffle(x, p: int):
    b, t = x.shape[:2]
    y = F.pixel_shuffle(x.reshape(b * t, *x.shape[2:]), p)
    return y.reshape(b, t, *y.shape[1:])


@vae_registry.register("tae", aliases=("taehv", "TAEHV", "hunyuanvideo15.light"))
class TAEVAE(nn.Module):
    """TAEHV tiny video autoencoder. Public API NCTHW, video in [-1, 1]."""

    config_class = TAEConfig

    def __init__(self, cfg: Optional[TAEConfig] = None, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg = cfg or TAEConfig()
        if cfg.deepen:
            raise NotImplementedError("the identity-deepened tiny_wan decoder is not ported")
        self.decoder = nn.ModuleList(_build_decoder(cfg, dtype))
        self.encoder = None if cfg.decoder_only else nn.ModuleList(_build_encoder(cfg, dtype))

    @property
    def frames_to_trim(self) -> int:
        return 2 ** sum(self.cfg.decoder_time_upscale) - 1

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """[B,3,T,H,W] in [-1,1] → latents [B,C,ceil(T/4),H/8,W/8]."""
        if self.encoder is None:
            raise NotImplementedError("a decoder-only TAE cannot encode")
        x = video.float().permute(0, 2, 1, 3, 4)
        if self.cfg.out_range == "unit":
            x = (x + 1.0) / 2.0
        if self.cfg.patch_size > 1:
            x = _pixel_unshuffle(x, self.cfg.patch_size)
        t = x.shape[1]
        if t % 4:
            x = torch.cat([x, x[:, -1:].expand(-1, 4 - t % 4, -1, -1, -1)], dim=1)
        for layer in self.encoder:
            x = layer(x)
        return x.permute(0, 2, 1, 3, 4) * self.cfg.scaling_factor

    def _denormalize(self, z: torch.Tensor) -> torch.Tensor:
        z = z.float() / self.cfg.scaling_factor
        if self.cfg.latents_mean is not None and self.cfg.latents_std is not None:
            mean = torch.tensor(self.cfg.latents_mean, dtype=torch.float32, device=z.device)
            std = torch.tensor(self.cfg.latents_std, dtype=torch.float32, device=z.device)
            z = z * std[None, :, None, None, None] + mean[None, :, None, None, None]
        return z

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents [B,C,T,h,w] → video [B,3,4T−3,H,W] in [-1,1]."""
        x = self._denormalize(z).permute(0, 2, 1, 3, 4)
        for layer in self.decoder:
            x = layer(x)
        x = x.clamp(0.0, 1.0) * 2.0 - 1.0 if self.cfg.out_range == "unit" else x.clamp(-1.0, 1.0)
        if self.cfg.patch_size > 1:
            x = _pixel_shuffle(x, self.cfg.patch_size)
        return x[:, self.frames_to_trim:].permute(0, 2, 1, 3, 4)
