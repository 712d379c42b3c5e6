"""HunyuanImage 3.0 3D-conv DC-AE VAE (``AutoencoderKLConv3D``), port of
``apex_studio_tpu/models/vaes/hunyuanimage3_vae.py``.

The JAX module runs NDHWC with DHWIO kernels; this one runs NCDHW with OIDHW
kernels (``loaders/from_jax.py`` transposes on carry). What it computes:

- plain (non-causal) 3D convs with symmetric zero padding; resnets of
  GroupNorm(32, eps 1e-6; ``hunyuanvideo_vae.GroupNormCh``) → SiLU → conv,
  twice, with a 1×1×1 shortcut where the width changes
- DC-AE resampling: ``(f r1)(h 2)(w 2)`` pixel shuffles
  (``hunyuanvideo15_vae._space_to_channel`` / ``_channel_to_space``, the
  JAX channel order) with channel-group-mean (down) and repeat (up)
  shortcuts; the encoder adds a group-mean shortcut around its output head,
  the decoder a repeat shortcut around its input conv
- each mid block's single-head attention over all t·h·w tokens, unmasked,
  on the plain route (the JAX module pins it to XLA)
- images: a single frame is expanded to ``ffactor_temporal`` frames before
  the encoder; a T = 1 latent decodes to the last reconstructed frame
- ``scaling_factor`` and ``shift_factor`` default to None: 1 and 0
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.registry import vae_registry
from apex_studio_tpu_torch.models.vaes.hunyuanvideo15_vae import _channel_to_space, _group_mean, _space_to_channel
from apex_studio_tpu_torch.models.vaes.hunyuanvideo_vae import GroupNormCh
from apex_studio_tpu_torch.ops.attention import attention


@dataclasses.dataclass
class HunyuanImage3VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 32
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 1024, 1024)
    layers_per_block: int = 2
    ffactor_spatial: int = 16
    ffactor_temporal: int = 4
    sample_size: int = 256
    sample_tsize: int = 64
    downsample_match_channel: bool = True
    upsample_match_channel: bool = True
    scaling_factor: Optional[float] = None
    shift_factor: Optional[float] = None

    @classmethod
    def from_dict(cls, cfg: dict) -> "HunyuanImage3VAEConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "block_out_channels" in kw:
            kw["block_out_channels"] = tuple(kw["block_out_channels"])
        return cls(**kw)

    @property
    def spatial_scale(self) -> int:
        return self.ffactor_spatial

    @property
    def temporal_scale(self) -> int:
        return self.ffactor_temporal


class Conv3dSame(nn.Module):
    """k×k×k conv, symmetric zero padding; weight OIDHW in f32, computed in ``dtype``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, *, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, kernel, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=torch.float32))
        self.k = kernel
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
        return F.conv3d(x.to(self.dtype), w, b, padding=self.k // 2)


class HI3ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, *, dtype):
        super().__init__()
        self.norm1 = GroupNormCh(32, cin)
        self.conv1 = Conv3dSame(cin, cout, dtype=dtype)
        self.norm2 = GroupNormCh(32, cout)
        self.conv2 = Conv3dSame(cout, cout, dtype=dtype)
        self.nin_shortcut = Conv3dSame(cin, cout, kernel=1, dtype=dtype) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        skip = x if self.nin_shortcut is None else self.nin_shortcut(x)
        return skip + h


class HI3AttnBlock(nn.Module):
    """Single-head attention over all (t·h·w) tokens, 1×1×1 conv projections,
    on the plain route."""

    def __init__(self, dim: int, *, dtype):
        super().__init__()
        self.norm = GroupNormCh(32, dim)
        self.q = Conv3dSame(dim, dim, kernel=1, dtype=dtype)
        self.k = Conv3dSame(dim, dim, kernel=1, dtype=dtype)
        self.v = Conv3dSame(dim, dim, kernel=1, dtype=dtype)
        self.proj_out = Conv3dSame(dim, dim, kernel=1, dtype=dtype)

    def forward(self, x):
        b, c, t, h, w = x.shape
        y = self.norm(x)

        def tokens(conv):
            return conv(y).reshape(b, c, t * h * w).transpose(1, 2)[:, :, None]

        out = attention(tokens(self.q), tokens(self.k), tokens(self.v), backend="xla")[:, :, 0]
        return x + self.proj_out(out.transpose(1, 2).reshape(b, c, t, h, w))


class HI3Downsample(nn.Module):
    """Conv to cout/factor, then pixel-unshuffle, plus the unshuffled
    channel-group-mean shortcut."""

    def __init__(self, cin: int, cout: int, temporal: bool, *, dtype):
        super().__init__()
        factor = 8 if temporal else 4
        self.conv = Conv3dSame(cin, cout // factor, dtype=dtype)
        self.temporal = temporal
        self.group_size = factor * cin // cout

    def forward(self, x):
        r1 = 2 if self.temporal else 1
        h = _space_to_channel(self.conv(x), r1, 2, 2)
        return h + _group_mean(_space_to_channel(x, r1, 2, 2), h.shape[1], self.group_size)


class HI3Upsample(nn.Module):
    """Conv to cout·factor, then pixel-shuffle, plus the shuffled
    channel-repeat shortcut."""

    def __init__(self, cin: int, cout: int, temporal: bool, *, dtype):
        super().__init__()
        factor = 8 if temporal else 4
        self.conv = Conv3dSame(cin, cout * factor, dtype=dtype)
        self.temporal = temporal
        self.repeats = factor * cout // cin

    def forward(self, x):
        r1 = 2 if self.temporal else 1
        h = _channel_to_space(self.conv(x), r1, 2, 2)
        return h + _channel_to_space(x.repeat_interleave(self.repeats, dim=1), r1, 2, 2)


class _Level(nn.Module):
    """One resolution level: its resnets, then its resampler (or none),
    under the JAX module's ``downsamplers`` / ``upsamplers`` name."""

    def __init__(self, resnets, sampler_name: str, sampler: Optional[nn.Module]):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        setattr(self, sampler_name, nn.ModuleList([sampler]) if sampler is not None else None)
        self.sampler_name = sampler_name

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        sampler = getattr(self, self.sampler_name)
        return x if sampler is None else sampler[0](x)


class HI3Encoder(nn.Module):
    def __init__(self, cfg: HunyuanImage3VAEConfig, *, dtype):
        super().__init__()
        ch = cfg.block_out_channels
        z2 = 2 * cfg.latent_channels
        assert ch[-1] % z2 == 0
        self.group_size = ch[-1] // z2
        self.conv_in = Conv3dSame(cfg.in_channels, ch[0], dtype=dtype)
        n_spatial = int(math.log2(cfg.ffactor_spatial))
        t_start = int(math.log2(cfg.ffactor_spatial // cfg.ffactor_temporal))
        levels, cin = [], ch[0]
        for i, cout in enumerate(ch):
            res = [HI3ResnetBlock(cin if j == 0 else cout, cout, dtype=dtype) for j in range(cfg.layers_per_block)]
            down = None
            if i < n_spatial:
                d_out = ch[i + 1] if cfg.downsample_match_channel else cout
                down = HI3Downsample(cout, d_out, temporal=i >= t_start, dtype=dtype)
                cin = d_out
            else:
                cin = cout
            levels.append(_Level(res, "downsamplers", down))
        self.down_blocks = nn.ModuleList(levels)
        self.mid_block_1 = HI3ResnetBlock(cin, cin, dtype=dtype)
        self.mid_attn_1 = HI3AttnBlock(cin, dtype=dtype)
        self.mid_block_2 = HI3ResnetBlock(cin, cin, dtype=dtype)
        self.norm_out = GroupNormCh(32, cin)
        self.conv_out = Conv3dSame(cin, z2, dtype=dtype)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block_2(self.mid_attn_1(self.mid_block_1(x)))
        shortcut = _group_mean(x, x.shape[1] // self.group_size, self.group_size)
        return self.conv_out(F.silu(self.norm_out(x))) + shortcut


class HI3Decoder(nn.Module):
    def __init__(self, cfg: HunyuanImage3VAEConfig, *, dtype):
        super().__init__()
        ch = tuple(reversed(cfg.block_out_channels))
        assert ch[0] % cfg.latent_channels == 0
        self.repeats = ch[0] // cfg.latent_channels
        self.conv_in = Conv3dSame(cfg.latent_channels, ch[0], dtype=dtype)
        self.mid_block_1 = HI3ResnetBlock(ch[0], ch[0], dtype=dtype)
        self.mid_attn_1 = HI3AttnBlock(ch[0], dtype=dtype)
        self.mid_block_2 = HI3ResnetBlock(ch[0], ch[0], dtype=dtype)
        n_spatial = int(math.log2(cfg.ffactor_spatial))
        n_temporal = int(math.log2(cfg.ffactor_temporal))
        levels, cin = [], ch[0]
        for i, cout in enumerate(ch):
            res = [HI3ResnetBlock(cin if j == 0 else cout, cout, dtype=dtype) for j in range(cfg.layers_per_block + 1)]
            up = None
            if i < n_spatial:
                u_out = ch[i + 1] if cfg.upsample_match_channel else cout
                up = HI3Upsample(cout, u_out, temporal=i < n_temporal, dtype=dtype)
                cin = u_out
            else:
                cin = cout
            levels.append(_Level(res, "upsamplers", up))
        self.up_blocks = nn.ModuleList(levels)
        self.norm_out = GroupNormCh(32, cin)
        self.conv_out = Conv3dSame(cin, cfg.out_channels, dtype=dtype)

    def forward(self, z):
        x = self.conv_in(z) + z.repeat_interleave(self.repeats, dim=1)
        x = self.mid_block_2(self.mid_attn_1(self.mid_block_1(x)))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.norm_out(x)))


@vae_registry.register("hunyuanimage3", aliases=("AutoencoderKLConv3D", "hunyuanimage3.base"))
class AutoencoderKLConv3D(nn.Module):
    config_class = HunyuanImage3VAEConfig

    def __init__(self, cfg: HunyuanImage3VAEConfig, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder = HI3Encoder(cfg, dtype=dtype)
        self.decoder = HI3Decoder(cfg, dtype=dtype)

    def _scale(self) -> float:
        return float(self.cfg.scaling_factor or 1.0)

    def _shift(self) -> float:
        return float(self.cfg.shift_factor or 0.0)

    def encode(self, pixels: torch.Tensor, sample: bool = False, noise: Optional[torch.Tensor] = None):
        """[B,3,H,W] or [B,3,T,H,W] → model-space latents; a single frame is
        expanded to ``ffactor_temporal`` frames first, an image returns
        [B,z,H',W']."""
        was_image = pixels.ndim == 4
        if was_image:
            pixels = pixels[:, :, None]
        if pixels.shape[2] == 1:
            pixels = pixels.expand(-1, -1, self.cfg.ffactor_temporal, -1, -1)
        mean, logvar = self.encoder(pixels).chunk(2, dim=1)
        z = mean
        if sample and noise is not None:
            z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
        z = (z - self._shift()) * self._scale()
        return z[:, :, 0] if was_image else z

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Model-space latents → pixels; a T = 1 latent decodes to the last of
        its ``ffactor_temporal`` reconstructed frames."""
        was_image = z.ndim == 4
        if was_image:
            z = z[:, :, None]
        z = z / self._scale() + self._shift()
        out = self.decoder(z)
        if z.shape[2] == 1:
            out = out[:, :, -1:]
        return out[:, :, 0] if was_image else out
