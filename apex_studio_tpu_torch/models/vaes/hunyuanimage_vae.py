"""HunyuanImage 2.1 image VAE (32× spatial compression), port of
``apex_studio_tpu/models/vaes/hunyuanimage_vae.py``.

Plain GroupNorm / SiLU resnet stacks (the port's AutoencoderKL pieces) in
which every resampler and both heads carry a parameter-free shortcut:
space-to-depth with grouped channel means going down, depth-to-space of the
channel-repeated input going up, so the network learns residuals around a
lossless resampling. Flat ``down_blocks`` / ``up_blocks`` lists interleave
resnets and resamplers as the checkpoint does. NCHW throughout; the
space-to-depth channel order is the JAX module's ``(r1, r2, c)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.registry import vae_registry
from apex_studio_tpu_torch.models.vaes.autoencoder_kl import AttentionBlock2D, Conv2d, GroupNorm, ResnetBlock2D


@dataclasses.dataclass
class HunyuanImageVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 64
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 1024, 2048)
    layers_per_block: int = 2
    spatial_compression_ratio: int = 32
    scaling_factor: float = 0.75289
    shift_factor: Optional[float] = None
    sample_size: int = 1024
    downsample_match_channel: bool = True
    upsample_match_channel: bool = True

    @classmethod
    def from_dict(cls, cfg: dict) -> "HunyuanImageVAEConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "block_out_channels" in kw:
            kw["block_out_channels"] = tuple(kw["block_out_channels"])
        return cls(**kw)

    @property
    def spatial_scale(self) -> int:
        return self.spatial_compression_ratio


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NCHW 2×2 space-to-depth, output channels in (r1, r2, c) order."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    b, c, h, w = x.shape
    x = x.reshape(b, 2, 2, c // 4, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c // 4, h * 2, w * 2)


def _group_mean(x: torch.Tensor, group: int) -> torch.Tensor:
    """Mean over consecutive groups of ``group`` channels."""
    b, c, h, w = x.shape
    return x.reshape(b, c // group, group, h, w).mean(dim=2)


class HYIDownsample(nn.Module):
    """Conv to cout/4 then space-to-depth, plus the grouped-mean shortcut."""

    def __init__(self, cin: int, cout: int, *, dtype):
        super().__init__()
        self.conv = Conv2d(cin, cout // 4, dtype=dtype)
        self.group_size = 4 * cin // cout

    def forward(self, x):
        return space_to_depth(self.conv(x)) + _group_mean(space_to_depth(x), self.group_size)


class HYIUpsample(nn.Module):
    """Conv to cout·4 then depth-to-space, plus the repeat-interleave shortcut."""

    def __init__(self, cin: int, cout: int, *, dtype):
        super().__init__()
        self.conv = Conv2d(cin, cout * 4, dtype=dtype)
        self.repeats = 4 * cout // cin

    def forward(self, x):
        return depth_to_space(self.conv(x)) + depth_to_space(x.repeat_interleave(self.repeats, dim=1))


class HYIMidBlock(nn.Module):
    """resnet, attention, resnet."""

    def __init__(self, channels: int, *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels, min(32, channels), dtype=dtype)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([AttentionBlock2D(channels, min(32, channels), dtype=dtype)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class HYIEncoder(nn.Module):
    def __init__(self, cfg: HunyuanImageVAEConfig, *, dtype):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, ch[0], dtype=dtype)
        blocks, cin = [], ch[0]
        n_down = int(math.log2(cfg.spatial_compression_ratio))
        for i, cout in enumerate(ch):
            for _ in range(cfg.layers_per_block):
                blocks.append(ResnetBlock2D(cin, cout, min(32, cin, cout), dtype=dtype))
                cin = cout
            if i < n_down and i != len(ch) - 1:
                if cfg.downsample_match_channel:
                    cout = ch[i + 1]
                blocks.append(HYIDownsample(cin, cout, dtype=dtype))
                cin = cout
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = HYIMidBlock(ch[-1], dtype=dtype)
        self.norm_out = GroupNorm(ch[-1], min(32, ch[-1]))
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, dtype=dtype)
        self.group_size = ch[-1] // (2 * cfg.latent_channels)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.norm_out(x))) + _group_mean(x, self.group_size)


class HYIDecoder(nn.Module):
    def __init__(self, cfg: HunyuanImageVAEConfig, *, dtype):
        super().__init__()
        ch = tuple(reversed(cfg.block_out_channels))
        z = cfg.latent_channels
        self.conv_in = Conv2d(z, ch[0], dtype=dtype)
        self.repeat = ch[0] // z
        self.mid_block = HYIMidBlock(ch[0], dtype=dtype)
        blocks, cin = [], ch[0]
        n_up = int(math.log2(cfg.spatial_compression_ratio))
        for i, cout in enumerate(ch):
            for _ in range(cfg.layers_per_block + 1):
                blocks.append(ResnetBlock2D(cin, cout, min(32, cin, cout), dtype=dtype))
                cin = cout
            if i < n_up and i != len(ch) - 1:
                if cfg.upsample_match_channel:
                    cout = ch[i + 1]
                blocks.append(HYIUpsample(cin, cout, dtype=dtype))
                cin = cout
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = GroupNorm(ch[-1], min(32, ch[-1]))
        self.conv_out = Conv2d(ch[-1], cfg.out_channels, dtype=dtype)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z) + z.repeat_interleave(self.repeat, dim=1))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.norm_out(x)))


@vae_registry.register("hunyuanimage.vae", aliases=("AutoencoderKLHunyuanImage", "hunyuanimage_vae"))
class AutoencoderKLHunyuanImage(nn.Module):
    config_class = HunyuanImageVAEConfig

    def __init__(self, cfg: HunyuanImageVAEConfig, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder = HYIEncoder(cfg, dtype=dtype)
        self.decoder = HYIDecoder(cfg, dtype=dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] → the posterior mean in the model's latent space."""
        mean = self.encoder(x).chunk(2, dim=1)[0]
        if self.cfg.shift_factor is not None:
            mean = mean - self.cfg.shift_factor
        return mean * (self.cfg.scaling_factor or 1.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = z / (self.cfg.scaling_factor or 1.0)
        if self.cfg.shift_factor is not None:
            z = z + self.cfg.shift_factor
        return self.decoder(z)
