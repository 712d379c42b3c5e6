"""CogVideoX 3D-causal video VAE (``AutoencoderKLCogVideoX``), port of
``apex_studio_tpu/models/vaes/cogvideox_vae.py``: 8× spatial and 4× temporal
compression to 16 latent channels, frame 0 kept apart in time (the causal
1 + 4k frame rule), ``scaling_factor`` 1.15258426.

The JAX module runs NDHWC with DHWIO kernels; this one runs NCDHW with OIDHW
kernels (``loaders/from_jax.py`` transposes on carry). What it computes:

- causal 3D convs whose time axis is front-padded by **repeating the first
  frame** k − 1 times, with symmetric zero padding in space
- encoder resnets GroupNorm(32) → SiLU → conv, twice, plus a 1×1×1 shortcut;
  decoder resnets, mid block and output norm use ``CogSpatialNorm3D``:
  ``GroupNorm(f)·conv_y(zq) + conv_b(zq)``, zq the raw latent nearest-resized
  to f's grid (frame 0 apart when T is odd)
- encoder downsampling: a temporal average over frame pairs (frame 0 exempt
  when T is odd; only where T > 1), then a stride-2 per-frame conv padded
  (0, 1); decoder upsampling: nearest 2× in space, in time only where
  T > 1 (frame 0 exempt when T is odd, every frame doubled when even), then a
  per-frame conv
- no attention and no quant convs

JAX computes every tensor whole, in f32. So does this module up to a size
decided by element counts alone; past it each operation runs in chunks of
frames with the same sums: a conv in chunks of output frames, each reading
only the frames it needs (``CONV_CHUNK_ELEMENTS``), an upsample in chunks of
output frames (the same limit), a group norm or spatial norm with
statistics summed over chunks in float64 and applied chunk by chunk
(``NORM_CHUNK_ELEMENTS``). A 128-channel activation at 49 frames of
480×720 is past torch's 32-bit indexing, and a spatial norm's three
full-size products are not built at once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.registry import vae_registry
from apex_studio_tpu_torch.models.vaes import hunyuanvideo_vae
from apex_studio_tpu_torch.models.vaes.wan_vae import Conv2dSame
from apex_studio_tpu_torch.utils.jax_resize import nearest_index

# elements of a conv's (padded) input or output, or of an upsample's output, in one call
CONV_CHUNK_ELEMENTS = 1 << 30
# elements of a group norm's or spatial norm's input normalised in one piece
NORM_CHUNK_ELEMENTS = 1 << 30


@dataclasses.dataclass
class CogVideoXVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    norm_num_groups: int = 32
    temporal_compression_ratio: int = 4
    scaling_factor: float = 1.15258426
    latents_mean: Optional[Tuple[float, ...]] = None
    latents_std: Optional[Tuple[float, ...]] = None

    @classmethod
    def from_dict(cls, cfg: dict) -> "CogVideoXVAEConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        for key in ("block_out_channels", "latents_mean", "latents_std"):
            if key in kw and kw[key] is not None:
                kw[key] = tuple(kw[key])
        return cls(**kw)

    @property
    def spatial_scale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @property
    def temporal_scale(self) -> int:
        return self.temporal_compression_ratio


def _frame_chunks(t: int, per_frame: int, limit: int):
    """Slices of at most ``limit // per_frame`` frames (at least one) over ``t``."""
    frames = max(1, limit // max(per_frame, 1))
    return [slice(t0, min(t, t0 + frames)) for t0 in range(0, t, frames)]


class GroupNormCh(hunyuanvideo_vae.GroupNormCh):
    """``hunyuanvideo_vae.GroupNormCh`` whole up to ``NORM_CHUNK_ELEMENTS``
    elements of any dtype, in chunks of frames past it."""

    def whole(self, x: torch.Tensor) -> bool:
        return x.numel() <= NORM_CHUNK_ELEMENTS

    def chunks(self, x: torch.Tensor):
        return _frame_chunks(x.shape[2], x[:, :, :1].numel(), NORM_CHUNK_ELEMENTS)


class CogCausalConv3d(nn.Module):
    """Causal 3D conv: time front-padded by repeating the first frame k − 1
    times, symmetric zero padding in space; NCDHW, weight OIDHW in f32. A call
    whose padded input or output passes ``CONV_CHUNK_ELEMENTS`` runs in chunks
    of output frames, each padding only the frames it reads."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, *, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, kernel, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=torch.float32))
        self.k = kernel
        self.dtype = dtype

    def _padded(self, x: torch.Tensor, p0: int, p1: int) -> torch.Tensor:
        """Frames [p0, p1) of the padded input (padded frame p is input frame
        max(p − (k − 1), 0))."""
        k = self.k
        if k == 1:
            return x[:, :, p0:p1].to(self.dtype)
        lo, hi = max(p0 - (k - 1), 0), p1 - (k - 1)
        front = max((k - 1) - p0, 0)
        x = x[:, :, lo:hi].to(self.dtype)
        if front:
            x = torch.cat([x[:, :, :1].expand(-1, -1, front, -1, -1), x], dim=2)
        return F.pad(x, (k // 2, k // 2, k // 2, k // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.k
        w, bias = self.weight.to(self.dtype), self.bias.to(self.dtype)
        b, _, t, h, wd = x.shape
        t_pad = t + k - 1
        per_frame = b * max(x.shape[1], w.shape[0]) * (h + k - 1) * (wd + k - 1)
        if t_pad * per_frame <= CONV_CHUNK_ELEMENTS:
            return F.conv3d(self._padded(x, 0, t_pad), w, bias)
        out = None
        for sl in _frame_chunks(t, per_frame, CONV_CHUNK_ELEMENTS - (k - 1) * per_frame):
            y = F.conv3d(self._padded(x, sl.start, sl.stop + k - 1), w, bias)
            if out is None:
                out = torch.empty((b, y.shape[1], t, *y.shape[3:]), dtype=y.dtype, device=y.device)
            out[:, :, sl] = y
            del y
        return out


class CogConv2d(Conv2dSame):
    """The per-frame 2-D conv, in chunks of frames past ``CONV_CHUNK_ELEMENTS``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        per_frame = b * max(c, self.weight.shape[0]) * (h + self.top + self.bottom) * (w + self.left + self.right)
        if t * per_frame <= CONV_CHUNK_ELEMENTS:
            return super().forward(x)
        return torch.cat([super(CogConv2d, self).forward(x[:, :, sl])
                          for sl in _frame_chunks(t, per_frame, CONV_CHUNK_ELEMENTS)], dim=2)


def _zq_frames(tz: int, t: int) -> torch.Tensor:
    """The latent frame each of ``t`` frames takes in the spatial norm: frame 0
    apart when t is odd and above 1, nearest resizes otherwise."""
    if t > 1 and t % 2 == 1:
        return torch.cat([torch.zeros(1, dtype=torch.long), 1 + torch.from_numpy(nearest_index(tz - 1, t - 1))])
    return torch.from_numpy(nearest_index(tz, t))


class CogSpatialNorm3D(nn.Module):
    """``GroupNorm(f)·conv_y(zq) + conv_b(zq)`` with zq nearest-resized to f's
    grid (the odd-T first/rest split). Past ``NORM_CHUNK_ELEMENTS`` it runs in
    chunks of frames, zq resized chunk by chunk."""

    def __init__(self, f_ch: int, zq_ch: int, groups: int, *, dtype):
        super().__init__()
        self.norm_layer = GroupNormCh(groups, f_ch)
        self.conv_y = CogCausalConv3d(zq_ch, f_ch, kernel=1, dtype=dtype)
        self.conv_b = CogCausalConv3d(zq_ch, f_ch, kernel=1, dtype=dtype)

    def forward(self, f: torch.Tensor, zq: torch.Tensor) -> torch.Tensor:
        t, h, w = f.shape[2:]
        frames = _zq_frames(zq.shape[2], t).to(zq.device)
        rows = torch.from_numpy(nearest_index(zq.shape[3], h)).to(zq.device)
        cols = torch.from_numpy(nearest_index(zq.shape[4], w)).to(zq.device)

        def resized(sl):
            return zq[:, :, frames[sl]][:, :, :, rows][:, :, :, :, cols]

        norm = self.norm_layer
        if norm.whole(f):
            z = resized(slice(None))
            return norm(f) * self.conv_y(z) + self.conv_b(z)
        mean, rstd = norm.stats(f)
        out = torch.empty_like(f)
        for sl in norm.chunks(f):
            z = resized(sl)
            out[:, :, sl] = norm.apply(f[:, :, sl], mean, rstd) * self.conv_y(z) + self.conv_b(z)
        return out


class CogResnetBlock3D(nn.Module):
    """GroupNorm (encoder) or the latent-conditioned spatial norm (decoder,
    ``spatial_norm_dim`` set) → SiLU → causal conv, twice, plus the shortcut."""

    def __init__(self, cin: int, cout: int, groups: int, spatial_norm_dim: Optional[int] = None, *, dtype):
        super().__init__()
        if spatial_norm_dim is None:
            self.norm1 = GroupNormCh(groups, cin)
            self.norm2 = GroupNormCh(groups, cout)
        else:
            self.norm1 = CogSpatialNorm3D(cin, spatial_norm_dim, groups, dtype=dtype)
            self.norm2 = CogSpatialNorm3D(cout, spatial_norm_dim, groups, dtype=dtype)
        self.spatial = spatial_norm_dim is not None
        self.conv1 = CogCausalConv3d(cin, cout, dtype=dtype)
        self.conv2 = CogCausalConv3d(cout, cout, dtype=dtype)
        self.conv_shortcut = CogCausalConv3d(cin, cout, kernel=1, dtype=dtype) if cin != cout else None

    def forward(self, x: torch.Tensor, zq: Optional[torch.Tensor] = None) -> torch.Tensor:
        n1 = self.norm1(x, zq) if self.spatial else self.norm1(x)
        h = self.conv1(F.silu(n1))
        del n1
        n2 = self.norm2(h, zq) if self.spatial else self.norm2(h)
        h = self.conv2(F.silu(n2))
        del n2
        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return skip + h


class CogDownsample3D(nn.Module):
    """Temporal average over frame pairs where T > 1 and ``compress_time``
    (frame 0 exempt when T is odd), then a stride-2 per-frame conv padded (0, 1)."""

    def __init__(self, dim: int, compress_time: bool, *, dtype):
        super().__init__()
        self.conv = CogConv2d(dim, dim, stride=2, pad=((0, 1), (0, 1)), dtype=dtype)
        self.compress_time = compress_time

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compress_time and x.shape[2] > 1:
            if x.shape[2] % 2 == 1:
                rest = x[:, :, 1:]
                x = torch.cat([x[:, :, :1], 0.5 * (rest[:, :, 0::2] + rest[:, :, 1::2])], dim=2)
            else:
                x = 0.5 * (x[:, :, 0::2] + x[:, :, 1::2])
        return self.conv(x)


class CogUpsample3D(nn.Module):
    """Nearest 2× in space (and in time where ``compress_time`` and T > 1:
    frame 0 exempt when T is odd, every frame doubled when even), then a 3×3
    per-frame conv. Past ``CONV_CHUNK_ELEMENTS`` output elements it runs in
    chunks of output frames."""

    def __init__(self, dim: int, compress_time: bool, *, dtype):
        super().__init__()
        self.conv = CogConv2d(dim, dim, dtype=dtype)
        self.compress_time = compress_time

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[2]
        frames = torch.arange(t)
        if self.compress_time and t > 1:
            frames = (torch.cat([frames[:1], frames[1:].repeat_interleave(2)]) if t % 2 == 1
                      else frames.repeat_interleave(2))

        def up(sl):
            y = x if frames.numel() == t and sl == slice(None) else x[:, :, frames[sl].to(x.device)]
            return self.conv(y.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4))

        b, c, _, h, w = x.shape
        per_frame = b * c * 4 * h * w
        if frames.numel() * per_frame <= CONV_CHUNK_ELEMENTS:
            return up(slice(None))
        return torch.cat([up(sl) for sl in _frame_chunks(frames.numel(), per_frame, CONV_CHUNK_ELEMENTS)], dim=2)


class CogDownBlock3D(nn.Module):
    def __init__(self, cin: int, cout: int, num_layers: int, groups: int, downsample: bool, compress_time: bool,
                 *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([CogResnetBlock3D(cin if i == 0 else cout, cout, groups, dtype=dtype)
                                      for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([CogDownsample3D(cout, compress_time, dtype=dtype)])
                             if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        return x if self.downsamplers is None else self.downsamplers[0](x)


class CogUpBlock3D(nn.Module):
    def __init__(self, cin: int, cout: int, num_layers: int, groups: int, upsample: bool, compress_time: bool,
                 spatial_norm_dim: int, *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([CogResnetBlock3D(cin if i == 0 else cout, cout, groups, spatial_norm_dim,
                                                       dtype=dtype) for i in range(num_layers)])
        self.upsamplers = (nn.ModuleList([CogUpsample3D(cout, compress_time, dtype=dtype)])
                           if upsample else None)

    def forward(self, x: torch.Tensor, zq: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x, zq)
        return x if self.upsamplers is None else self.upsamplers[0](x)


class CogMidBlock3D(nn.Module):
    def __init__(self, dim: int, groups: int, spatial_norm_dim: Optional[int] = None, *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([CogResnetBlock3D(dim, dim, groups, spatial_norm_dim, dtype=dtype)
                                      for _ in range(2)])

    def forward(self, x: torch.Tensor, zq: Optional[torch.Tensor] = None) -> torch.Tensor:
        for r in self.resnets:
            x = r(x, zq)
        return x


def _n_temporal(cfg: CogVideoXVAEConfig) -> int:
    return {4: 2, 2: 1, 1: 0}.get(cfg.temporal_compression_ratio, 2)


class CogEncoder3D(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, *, dtype):
        super().__init__()
        chans, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = CogCausalConv3d(cfg.in_channels, chans[0], dtype=dtype)
        n_temporal = _n_temporal(cfg)
        blocks, cur = [], chans[0]
        for i, cout in enumerate(chans):
            blocks.append(CogDownBlock3D(cur, cout, cfg.layers_per_block, g, downsample=i != len(chans) - 1,
                                         compress_time=i < n_temporal, dtype=dtype))
            cur = cout
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = CogMidBlock3D(cur, g, dtype=dtype)
        self.norm_out = GroupNormCh(g, cur)
        self.conv_out = CogCausalConv3d(cur, 2 * cfg.latent_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class CogDecoder3D(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, *, dtype):
        super().__init__()
        chans, g, zc = tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups, cfg.latent_channels
        self.conv_in = CogCausalConv3d(zc, chans[0], dtype=dtype)
        self.mid_block = CogMidBlock3D(chans[0], g, spatial_norm_dim=zc, dtype=dtype)
        n_temporal = _n_temporal(cfg)
        blocks, cur = [], chans[0]
        for i, cout in enumerate(chans):
            blocks.append(CogUpBlock3D(cur, cout, cfg.layers_per_block + 1, g, upsample=i != len(chans) - 1,
                                       compress_time=i < n_temporal, spatial_norm_dim=zc, dtype=dtype))
            cur = cout
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = CogSpatialNorm3D(cur, zc, g, dtype=dtype)
        self.conv_out = CogCausalConv3d(cur, cfg.out_channels, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(z)
        x = self.mid_block(x, z)
        for blk in self.up_blocks:
            x = blk(x, z)
        return self.conv_out(F.silu(self.norm_out(x, z)))


@vae_registry.register("cogvideo.base", aliases=("cogvideox", "AutoencoderKLCogVideoX"))
class AutoencoderKLCogVideoX(nn.Module):
    config_class = CogVideoXVAEConfig

    def __init__(self, cfg: CogVideoXVAEConfig, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder = CogEncoder3D(cfg, dtype=dtype)
        self.decoder = CogDecoder3D(cfg, dtype=dtype)

    def encode(self, video: torch.Tensor, sample: bool = False, noise: Optional[torch.Tensor] = None):
        """[B,3,T,H,W] in [-1, 1] → model-space (scaled) latents."""
        mean, logvar = self.encoder(video).chunk(2, dim=1)
        z = mean
        if sample and noise is not None:
            z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
        return z * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z / self.cfg.scaling_factor)
