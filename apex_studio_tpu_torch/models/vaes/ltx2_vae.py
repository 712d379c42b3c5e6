"""LTX-2 video VAE, port of ``apex_studio_tpu/models/vaes/ltx2_vae.py``.

The LTX-Video VAE's blocks (``ltx_vae.py``: causal convs, pixel-norm
resnets, space↔depth samplers with group-mean / repeat residuals) in the
LTX-2 topology:

- encoder: 4×4 patchify → ``conv_in`` to the latent width → four down blocks
  (resnets, then a spatial, temporal or spatiotemporal residual downsampler
  that widens the channels) → mid resnets → pixel norm, SiLU, ``conv_out`` to
  latent + 1 channels, the last one repeated as the shared log-variance;
- decoder: ``conv_in`` → mid resnets → three causal up blocks (a residual 2×
  depth-to-space upsampler that divides the channels by its factor, then
  resnets) → pixel norm, SiLU, ``conv_out`` → 4×4 unpatchify: 8× in time and
  32× in space; the per-block lists are read reversed, as the reference
  builds them.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.registry import vae_registry
from apex_studio_tpu_torch.models.vaes.ltx_vae import (
    CausalConv3d,
    ChannelNorm,
    DepthToSpaceUpsample,
    ResnetBlock3D,
    SpaceToDepthDownsample,
    _patchify,
    _unpatchify,
)
from apex_studio_tpu_torch.utils import jax_random

_STRIDES = {"spatial": (1, 2, 2), "temporal": (2, 1, 1), "spatiotemporal": (2, 2, 2)}


@dataclass
class LTX2VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 128
    block_out_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    decoder_block_out_channels: Tuple[int, ...] = (256, 512, 1024)
    layers_per_block: Tuple[int, ...] = (4, 6, 6, 2, 2)
    decoder_layers_per_block: Tuple[int, ...] = (5, 5, 5, 5)
    spatio_temporal_scaling: Tuple[bool, ...] = (True, True, True, True)
    decoder_spatio_temporal_scaling: Tuple[bool, ...] = (True, True, True)
    decoder_inject_noise: Tuple[bool, ...] = (False, False, False, False)
    downsample_type: Tuple[str, ...] = ("spatial", "temporal", "spatiotemporal", "spatiotemporal")
    upsample_residual: Tuple[bool, ...] = (True, True, True)
    upsample_factor: Tuple[int, ...] = (2, 2, 2)
    patch_size: int = 4
    patch_size_t: int = 1
    scaling_factor: float = 1.0
    encoder_causal: bool = True
    decoder_causal: bool = True
    encoder_spatial_padding_mode: str = "zeros"
    decoder_spatial_padding_mode: str = "reflect"
    latents_mean: Optional[List[float]] = None
    latents_std: Optional[List[float]] = None

    @property
    def spatial_compression_ratio(self) -> int:
        return self.patch_size * 2 ** sum(1 for t in self.downsample_type if t in ("spatial", "spatiotemporal"))

    @property
    def temporal_compression_ratio(self) -> int:
        return self.patch_size_t * 2 ** sum(1 for t in self.downsample_type if t in ("temporal", "spatiotemporal"))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LTX2VAEConfig":
        known = {f.name for f in fields(cls)}
        return cls(**{k: (tuple(v) if isinstance(v, list) and k not in ("latents_mean", "latents_std") else v)
                      for k, v in d.items() if k in known})


class LTX2Encoder(nn.Module):
    def __init__(self, cfg: LTX2VAEConfig, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        sp = cfg.encoder_spatial_padding_mode
        ch = cfg.latent_channels  # conv_in outputs the latent width; the first down block widens
        self.conv_in = CausalConv3d(cfg.in_channels * cfg.patch_size ** 2, ch, spatial_padding_mode=sp, dtype=dtype)
        blocks = []
        for i, out in enumerate(cfg.block_out_channels):
            resnets = nn.ModuleList([ResnetBlock3D(ch, ch, norm="pixel_norm", spatial_padding_mode=sp, dtype=dtype)
                                     for _ in range(cfg.layers_per_block[i])])
            down = None
            if cfg.spatio_temporal_scaling[i]:
                down = SpaceToDepthDownsample(ch, out, _STRIDES[cfg.downsample_type[i]], spatial_padding_mode=sp,
                                              dtype=dtype)
                ch = out
            blocks.append(nn.ModuleList([resnets, down or nn.Identity()]))  # (resnets, sampler) as in JAX
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_resnets = nn.ModuleList([ResnetBlock3D(ch, ch, norm="pixel_norm", spatial_padding_mode=sp,
                                                        dtype=dtype) for _ in range(cfg.layers_per_block[-1])])
        self.norm_out = ChannelNorm("pixel_norm", ch)
        self.conv_out = CausalConv3d(ch, cfg.latent_channels + 1, spatial_padding_mode=sp, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        causal = self.cfg.encoder_causal
        x = self.conv_in(_patchify(x, self.cfg.patch_size), causal=causal)
        for block in self.down_blocks:
            for rb in block[0]:
                x = rb(x, causal=causal)
            if not isinstance(block[1], nn.Identity):
                x = block[1](x, causal=causal)
        for rb in self.mid_resnets:
            x = rb(x, causal=causal)
        x = self.conv_out(F.silu(self.norm_out(x)), causal=causal)
        # the shared log-variance: the last channel repeated for every latent channel
        return torch.cat([x, x[:, -1:].expand(-1, x.shape[1] - 2, -1, -1, -1)], dim=1)


class LTX2Decoder(nn.Module):
    def __init__(self, cfg: LTX2VAEConfig, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        sp = cfg.decoder_spatial_padding_mode
        chans = tuple(reversed(cfg.decoder_block_out_channels))  # deepest first
        # the per-block lists are reversed whole: mid takes the last entries,
        # up block i the (len − 2 − i)-th
        layers_rev = tuple(reversed(cfg.decoder_layers_per_block))
        inject_rev = tuple(reversed(cfg.decoder_inject_noise))
        residual = tuple(reversed(cfg.upsample_residual))
        factor = tuple(reversed(cfg.upsample_factor))
        scaling = tuple(reversed(cfg.decoder_spatio_temporal_scaling))
        ch = chans[0]
        self.conv_in = CausalConv3d(cfg.latent_channels, ch, spatial_padding_mode=sp, dtype=dtype)
        self.mid_resnets = nn.ModuleList([
            ResnetBlock3D(ch, ch, norm="pixel_norm", inject_noise=inject_rev[0], spatial_padding_mode=sp,
                          dtype=dtype) for _ in range(layers_rev[0])])
        blocks = []
        for i in range(len(chans)):
            up = None
            if scaling[i]:
                up = DepthToSpaceUpsample(ch, (2, 2, 2), residual=residual[i],
                                          out_channels_reduction_factor=factor[i], spatial_padding_mode=sp,
                                          dtype=dtype)
                ch = chans[i] // factor[i]
            resnets = nn.ModuleList([
                ResnetBlock3D(ch, ch, norm="pixel_norm", inject_noise=inject_rev[min(i + 1, len(inject_rev) - 1)],
                              spatial_padding_mode=sp, dtype=dtype) for _ in range(layers_rev[i + 1])])
            blocks.append(nn.ModuleList([up or nn.Identity(), resnets]))  # (sampler, resnets) as in JAX
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = ChannelNorm("pixel_norm", ch)
        self.conv_out = CausalConv3d(ch, cfg.out_channels * cfg.patch_size ** 2, spatial_padding_mode=sp,
                                     dtype=dtype)

    def forward(self, z: torch.Tensor, noise_key: Optional[np.ndarray] = None) -> torch.Tensor:
        causal = self.cfg.decoder_causal
        x = self.conv_in(z, causal=causal)
        for i, rb in enumerate(self.mid_resnets):
            x = rb(x, causal=causal, noise_key=None if noise_key is None else jax_random.fold_in(noise_key, i))
        for j, block in enumerate(self.up_blocks):
            if not isinstance(block[0], nn.Identity):
                x = block[0](x, causal=causal)
            for i, rb in enumerate(block[1]):
                nk = None if noise_key is None else jax_random.fold_in(noise_key, 100 * (j + 1) + i)
                x = rb(x, causal=causal, noise_key=nk)
        x = self.conv_out(F.silu(self.norm_out(x)), causal=causal)
        return _unpatchify(x, self.cfg.patch_size)


@vae_registry.register("ltx2.base", aliases=("ltx2", "ltx2_vae", "AutoencoderKLLTX2Video"))
class AutoencoderKLLTX2(nn.Module):
    config_class = LTX2VAEConfig

    def __init__(self, cfg: LTX2VAEConfig, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.encoder = LTX2Encoder(cfg, dtype=dtype)
        self.decoder = LTX2Decoder(cfg, dtype=dtype)

    @property
    def spatial_compression_ratio(self) -> int:
        return self.cfg.spatial_compression_ratio

    @property
    def temporal_compression_ratio(self) -> int:
        return self.cfg.temporal_compression_ratio

    def mean_std(self, device) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """The per-channel latent statistics as [1, C, 1, 1, 1], or (None, None)."""
        if self.cfg.latents_mean is None:
            return None, None
        m = torch.tensor(self.cfg.latents_mean, dtype=torch.float32, device=device).reshape(1, -1, 1, 1, 1)
        s = torch.tensor(self.cfg.latents_std, dtype=torch.float32, device=device).reshape(1, -1, 1, 1, 1)
        return m, s

    def encode(self, video: torch.Tensor, sample: bool = False, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, 3, T, H, W] in [−1, 1] → normalised latents [B, C, T', H', W']."""
        mean, logvar = self.encoder(video).chunk(2, dim=1)
        z = mean
        if sample and noise is not None:
            z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
        m, s = self.mean_std(z.device)
        return z if m is None else (z - m) / s

    def decode(self, z: torch.Tensor, noise_key: Optional[np.ndarray] = None) -> torch.Tensor:
        m, s = self.mean_std(z.device)
        if m is not None:
            z = z * s + m
        return self.decoder(z, noise_key=noise_key)
