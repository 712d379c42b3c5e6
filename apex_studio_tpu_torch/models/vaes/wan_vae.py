"""Wan 3D-causal video VAE, port of ``apex_studio_tpu/models/vaes/wan_vae.py``
(QwenImage's VAE at T = 1, Wan 2.1/2.2's at T > 1).

The JAX module runs NDHWC with DHWIO kernels; this one runs NCDHW with OIDHW
kernels (``loaders/from_jax.py`` transposes on carry), and every
space↔channel shuffle keeps the JAX channel order. The causal semantics are
the JAX module's full-sequence ones:

- a causal conv pads ``2·pt`` frames of **zeros** in front of time and
  ``ph``/``pw`` on both sides of space; at T = 1 only the kernel's last
  time tap meets a real frame, so that case runs as a 2-D conv with that tap
  (the same sums without the zero frames);
- ``downsample3d`` keeps frame 0 and appends the stride-2 valid time windows;
  its spatial conv pads ((0, 1), (0, 1)) and strides 2;
- ``upsample3d`` at T > 1: frame 0 bypasses and is zeroed out of the time
  conv's history, the conv's two channel halves interleave along time; then a
  nearest 2× spatial repeat and the conv, per frame;
- the channel norm is x / max(‖x‖, 1e-12) over channels · √C · γ in f32;
- the mid-block attention is single-head over each frame's h·w tokens on the
  plain route (the JAX module forces XLA there), with raw ``[out, in]``
  projection matrices (``to_qkv_weight``, ``proj_weight``; JAX keeps them
  ``[in, out]`` as ``to_qkv_kernel``, ``proj_kernel``);
- Wan 2.2's ``is_residual`` blocks add avg-pool / duplicate shortcuts and a
  ``patch_size`` pixel patchify before the encoder;
- latents are normalised per channel, ``(raw − mean)/std``, after encode and
  undone before decode;
- a clip of more than ``ENCODE_WHOLE_MAX_PIXELS`` (T·H·W) encodes in time
  chunks, frame 0 alone and then ``ENCODE_CHUNK_LATENT`` latent frames at a
  time, each causal conv carrying its last ``2·pt`` input frames (zeros
  before the first chunk) and each ``downsample3d`` its last frame into the
  next chunk: the same sums as the whole encode (its windows stay on the
  whole clip's stride-2 grid), with the activations of one chunk. The
  departure (the JAX module encodes whole) is in ROADMAP Queue 3.

Parameters are f32; convolutions and projections compute in the ``dtype`` the
module is built with (bf16 for the published manifests, whose ``fp32`` is
declared per weight variant, which neither package's ``_component_dtype``
reads).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.registry import vae_registry
from apex_studio_tpu_torch.models.vaes.hunyuanvideo15_vae import RMSNormCh as WanRMSNormCh

# the largest clip (T·H·W) the encoder runs whole: 81 frames at 480x832, whose
# encode peaked at 61.73 GiB on an 80 GB card; larger clips encode in chunks
ENCODE_WHOLE_MAX_PIXELS = 81 * 480 * 832
ENCODE_CHUNK_LATENT = 2  # latent frames a chunk after the first frame


@dataclasses.dataclass
class WanVAEConfig:
    base_dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temperal_downsample: Tuple[bool, ...] = (False, True, True)
    latents_mean: Optional[Tuple[float, ...]] = None
    latents_std: Optional[Tuple[float, ...]] = None
    patch_size: Optional[int] = None
    is_residual: bool = False

    @classmethod
    def from_dict(cls, cfg: dict) -> "WanVAEConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "dim" in cfg and "base_dim" not in kw:
            kw["base_dim"] = cfg["dim"]
        for key in ("dim_mult", "attn_scales", "temperal_downsample", "latents_mean", "latents_std"):
            if kw.get(key) is not None:
                kw[key] = tuple(kw[key])
        return cls(**kw)

    @property
    def pixel_channels(self) -> int:
        p = self.patch_size or 1
        return 3 * p * p

    @property
    def spatial_scale(self) -> int:
        return 2 ** (len(self.dim_mult) - 1) * (self.patch_size or 1)

    @property
    def temporal_scale(self) -> int:
        return 2 ** sum(self.temperal_downsample)


def _triple(v):
    return (v,) * 3 if isinstance(v, int) else tuple(v)


class CausalConv3d(nn.Module):
    """Conv3d with causal (front, zero) time padding; NCDHW, weight OIDHW."""

    stream = False  # a chunked encode: the previous chunk's frames replace the zero padding

    def __init__(self, cin: int, cout: int, kernel=3, stride=1, padding=1, *, dtype):
        super().__init__()
        kernel, self.stride, self.pad = _triple(kernel), _triple(stride), _triple(padding)
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(cout, dtype=torch.float32))
        self.dtype = dtype
        self._prev = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pt, ph, pw = self.pad
        w = self.weight.to(self.dtype)
        prev = self._prev if self.stream else None
        if self.stream and pt:
            full = (F.pad(x.to(self.dtype), (0, 0, 0, 0, 2 * pt, 0)) if prev is None
                    else torch.cat([prev, x.to(self.dtype)], dim=2))
            self._prev = full[:, :, -2 * pt:]
        if prev is None and x.shape[2] == 1 and self.stride[0] == 1 and w.shape[2] == 2 * pt + 1:
            # one frame after 2·pt zero frames: only the last time tap sees it
            y = F.conv2d(x[:, :, 0].to(self.dtype), w[:, :, -1], stride=self.stride[1:],
                         padding=(ph, pw))[:, :, None]
        elif prev is not None and pt:
            y = F.conv3d(full, w, stride=self.stride, padding=(0, ph, pw))
        else:
            y = F.conv3d(F.pad(x.to(self.dtype), (0, 0, 0, 0, 2 * pt, 0)), w, stride=self.stride,
                         padding=(0, ph, pw))
        return y + self.bias.to(y.dtype)[:, None, None, None]


class Conv2dSame(nn.Module):
    """Per-frame 2-D conv on [B, C, T, H, W] (weight OIHW); ``pad`` is
    ((top, bottom), (left, right))."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 pad=((1, 1), (1, 1)), *, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(cout, dtype=torch.float32))
        self.stride = stride
        (self.top, self.bottom), (self.left, self.right) = pad
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        y = x.transpose(1, 2).reshape(b * t, c, h, w).to(self.dtype)
        y = F.pad(y, (self.left, self.right, self.top, self.bottom))
        y = F.conv2d(y, self.weight.to(self.dtype), self.bias.to(self.dtype), stride=self.stride)
        return y.reshape(b, t, *y.shape[1:]).transpose(1, 2)


class WanResample(nn.Module):
    stream = False  # a chunked encode: downsample3d carries its last frame

    def __init__(self, dim: int, mode: str, *, dtype, upsample_out_dim: Optional[int] = None):
        super().__init__()
        self.mode = mode
        self._prev = None
        time_conv = None
        if mode in ("upsample2d", "upsample3d"):
            out_dim = upsample_out_dim if upsample_out_dim is not None else dim // 2
            self.resample_conv = Conv2dSame(dim, out_dim, dtype=dtype)
            if mode == "upsample3d":
                time_conv = CausalConv3d(dim, dim * 2, kernel=(3, 1, 1), padding=(1, 0, 0), dtype=dtype)
        elif mode in ("downsample2d", "downsample3d"):
            self.resample_conv = Conv2dSame(dim, dim, stride=2, pad=((0, 1), (0, 1)), dtype=dtype)
            if mode == "downsample3d":
                time_conv = CausalConv3d(dim, dim, kernel=(3, 1, 1), stride=(2, 1, 1), padding=0,
                                         dtype=dtype)
        self.time_conv = time_conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        if self.mode.startswith("upsample"):
            if self.mode == "upsample3d" and t > 1:
                hist = x.clone()
                hist[:, :, :1] = 0.0
                y = self.time_conv(hist)[:, :, 1:]  # [B, 2C, T-1, H, W]
                y = y.reshape(b, 2, c, t - 1, h, w).permute(0, 2, 3, 1, 4, 5).reshape(b, c, 2 * (t - 1), h, w)
                x = torch.cat([x[:, :, :1], y.to(x.dtype)], dim=2)
            x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
            return self.resample_conv(x)
        if self.mode.startswith("downsample"):
            x = self.resample_conv(x)
            if self.mode == "downsample3d" and self.stream and self._prev is not None:
                # the stride-2 windows continue from the previous chunk's last frame
                prev, self._prev = self._prev, x[:, :, -1:]
                return self.time_conv(torch.cat([prev, x], dim=2))
            if self.mode == "downsample3d" and self.stream:
                self._prev = x[:, :, -1:]
            if self.mode == "downsample3d" and x.shape[2] > 1:
                x = torch.cat([x[:, :, :1], self.time_conv(x)], dim=2)
        return x


def avg_down_3d(x: torch.Tensor, out_ch: int, ft: int, fs: int) -> torch.Tensor:
    """Parameter-free average-pool shortcut (NCDHW): time front-padded to a
    multiple of ``ft``, (c, ft, fs, fs) channel-major groups averaged."""
    b, c, t, h, w = x.shape
    pad_t = (ft - t % ft) % ft
    if pad_t:
        x = F.pad(x, (0, 0, 0, 0, pad_t, 0))
        t += pad_t
    x = x.reshape(b, c, t // ft, ft, h // fs, fs, w // fs, fs).permute(0, 1, 3, 5, 7, 2, 4, 6)
    group = c * ft * fs * fs // out_ch
    return x.reshape(b, out_ch, group, t // ft, h // fs, w // fs).mean(2)


def dup_up_3d(x: torch.Tensor, out_ch: int, ft: int, fs: int, first_chunk: bool = True) -> torch.Tensor:
    """Parameter-free duplicate-upsample shortcut (NCDHW); ``first_chunk``
    trims the ``ft − 1`` leading frames."""
    b, c, t, h, w = x.shape
    x = x.repeat_interleave(out_ch * ft * fs * fs // c, dim=1)
    x = x.reshape(b, out_ch, ft, fs, fs, t, h, w).permute(0, 1, 5, 2, 6, 3, 7, 4)
    x = x.reshape(b, out_ch, t * ft, h * fs, w * fs)
    if first_chunk and ft > 1:
        x = x[:, :, ft - 1:]
    return x


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B,C,T,H,W] → [B,C·p·p,T,H/p,W/p], (c, h_off, w_off) channel-major."""
    if p == 1:
        return x
    b, c, t, h, w = x.shape
    x = x.reshape(b, c, t, h // p, p, w // p, p).permute(0, 1, 4, 6, 2, 3, 5)
    return x.reshape(b, c * p * p, t, h // p, w // p)


def unpatchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B,C·p·p,T,H,W] → [B,C,T,H·p,W·p]."""
    if p == 1:
        return x
    b, cp, t, h, w = x.shape
    c = cp // (p * p)
    x = x.reshape(b, c, p, p, t, h, w).permute(0, 1, 4, 5, 2, 6, 3)
    return x.reshape(b, c, t, h * p, w * p)


class WanResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, *, dtype):
        super().__init__()
        self.norm1 = WanRMSNormCh(cin)
        self.conv1 = CausalConv3d(cin, cout, dtype=dtype)
        self.norm2 = WanRMSNormCh(cout)
        self.conv2 = CausalConv3d(cout, cout, dtype=dtype)
        self.conv_shortcut = (CausalConv3d(cin, cout, kernel=1, padding=0, dtype=dtype)
                              if cin != cout else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return skip + h


class WanAttentionBlock(nn.Module):
    """Single-head spatial attention within each frame, on the plain route."""

    def __init__(self, dim: int, *, dtype):
        super().__init__()
        self.norm = WanRMSNormCh(dim)
        self.to_qkv_weight = nn.Parameter(torch.empty(3 * dim, dim, dtype=torch.float32))
        self.to_qkv_bias = nn.Parameter(torch.empty(3 * dim, dtype=torch.float32))
        self.proj_weight = nn.Parameter(torch.empty(dim, dim, dtype=torch.float32))
        self.proj_bias = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.dtype = dtype

    def forward(self, x):
        from apex_studio_tpu_torch.ops.attention import attention as attention_op

        b, c, t, h, w = x.shape
        dt = self.dtype
        y = self.norm(x).permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c).to(dt)
        q, k, v = F.linear(y, self.to_qkv_weight.to(dt), self.to_qkv_bias.to(dt)).chunk(3, dim=-1)
        out = attention_op(q[:, :, None], k[:, :, None], v[:, :, None], backend="xla")[:, :, 0]
        out = F.linear(out, self.proj_weight.to(dt), self.proj_bias.to(dt))
        return x + out.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)


class WanMidBlock(nn.Module):
    def __init__(self, dim: int, *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([WanResidualBlock(dim, dim, dtype=dtype) for _ in range(2)])
        self.attentions = nn.ModuleList([WanAttentionBlock(dim, dtype=dtype)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class WanResidualDownBlock(nn.Module):
    """Wan 2.2 encoder stage: resnets + resample around an avg-pool shortcut."""

    def __init__(self, cin: int, cout: int, num_res: int, temporal_down: bool, down_flag: bool, *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([WanResidualBlock(cin if i == 0 else cout, cout, dtype=dtype)
                                      for i in range(num_res)])
        self.downsampler = (WanResample(cout, "downsample3d" if temporal_down else "downsample2d", dtype=dtype)
                            if down_flag else None)
        self._short = (cout, 2 if temporal_down else 1, 2 if down_flag else 1)

    def forward(self, x):
        cout, ft, fs = self._short
        shortcut = avg_down_3d(x, cout, ft, fs)
        for r in self.resnets:
            x = r(x)
        if self.downsampler is not None:
            x = self.downsampler(x)
        return x + shortcut


class WanResidualUpBlock(nn.Module):
    """Wan 2.2 decoder stage: resnets + resample around a duplicate shortcut."""

    def __init__(self, cin: int, cout: int, num_res: int, temporal_up: bool, up_flag: bool, *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([WanResidualBlock(cin if i == 0 else cout, cout, dtype=dtype)
                                      for i in range(num_res + 1)])
        self.upsampler = (WanResample(cout, "upsample3d" if temporal_up else "upsample2d",
                                      upsample_out_dim=cout, dtype=dtype) if up_flag else None)
        self._short = (cout, 2 if temporal_up else 1, up_flag)

    def forward(self, x):
        cout, ft, up_flag = self._short
        x_copy = x
        for r in self.resnets:
            x = r(x)
        if self.upsampler is not None:
            x = self.upsampler(x)
        if up_flag:
            x = x + dup_up_3d(x_copy, cout, ft, 2, first_chunk=True)
        return x


class WanEncoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig, *, dtype):
        super().__init__()
        dims = [cfg.base_dim * u for u in (1, *cfg.dim_mult)]
        self.conv_in = CausalConv3d(cfg.pixel_channels, dims[0], dtype=dtype)
        blocks, scale = [], 1.0
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            last = i == len(cfg.dim_mult) - 1
            if cfg.is_residual:
                blocks.append(WanResidualDownBlock(
                    din, dout, cfg.num_res_blocks,
                    temporal_down=cfg.temperal_downsample[i] if not last else False,
                    down_flag=not last, dtype=dtype))
                continue
            cur = din
            for _ in range(cfg.num_res_blocks):
                blocks.append(WanResidualBlock(cur, dout, dtype=dtype))
                if scale in cfg.attn_scales:
                    blocks.append(WanAttentionBlock(dout, dtype=dtype))
                cur = dout
            if not last:
                mode = "downsample3d" if cfg.temperal_downsample[i] else "downsample2d"
                blocks.append(WanResample(dout, mode, dtype=dtype))
                scale /= 2.0
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = WanMidBlock(dims[-1], dtype=dtype)
        self.norm_out = WanRMSNormCh(dims[-1])
        self.conv_out = CausalConv3d(dims[-1], 2 * cfg.z_dim, dtype=dtype)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class WanUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, num_res: int, upsample_mode: Optional[str], *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([WanResidualBlock(cin if i == 0 else cout, cout, dtype=dtype)
                                      for i in range(num_res + 1)])
        self.upsamplers = (nn.ModuleList([WanResample(cout, upsample_mode, dtype=dtype)])
                           if upsample_mode else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return self.upsamplers[0](x) if self.upsamplers is not None else x


class WanDecoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig, *, dtype):
        super().__init__()
        dims = [cfg.base_dim * u for u in (cfg.dim_mult[-1], *reversed(cfg.dim_mult))]
        temperal_upsample = tuple(reversed(cfg.temperal_downsample))
        self.conv_in = CausalConv3d(cfg.z_dim, dims[0], dtype=dtype)
        self.mid_block = WanMidBlock(dims[0], dtype=dtype)
        ups = []
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            up_flag = i != len(cfg.dim_mult) - 1
            if cfg.is_residual:
                ups.append(WanResidualUpBlock(
                    din, dout, cfg.num_res_blocks,
                    temporal_up=temperal_upsample[i] if up_flag else False,
                    up_flag=up_flag, dtype=dtype))
                continue
            if i > 0:
                din = din // 2  # the previous upsample conv halved the channels
            mode = ("upsample3d" if temperal_upsample[i] else "upsample2d") if up_flag else None
            ups.append(WanUpBlock(din, dout, cfg.num_res_blocks, mode, dtype=dtype))
        self.up_blocks = nn.ModuleList(ups)
        self.norm_out = WanRMSNormCh(dims[-1])
        self.conv_out = CausalConv3d(dims[-1], cfg.pixel_channels, dtype=dtype)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.norm_out(x)))


@vae_registry.register("wan.base", aliases=("wan", "AutoencoderKLWan", "qwenimage", "AutoencoderKLQwenImage"))
class AutoencoderKLWan(nn.Module):
    config_class = WanVAEConfig

    def __init__(self, cfg: WanVAEConfig, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder = WanEncoder3d(cfg, dtype=dtype)
        self.decoder = WanDecoder3d(cfg, dtype=dtype)
        self.quant_conv = CausalConv3d(2 * cfg.z_dim, 2 * cfg.z_dim, kernel=1, padding=0, dtype=dtype)
        self.post_quant_conv = CausalConv3d(cfg.z_dim, cfg.z_dim, kernel=1, padding=0, dtype=dtype)

    def _mean_std(self, device):
        if self.cfg.latents_mean is None:
            return None, None
        mean = torch.tensor(self.cfg.latents_mean, dtype=torch.float32, device=device).reshape(1, -1, 1, 1, 1)
        std = torch.tensor(self.cfg.latents_std, dtype=torch.float32, device=device).reshape(1, -1, 1, 1, 1)
        return mean, std

    def encode_chunked(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder over time chunks (frame 0, then ``ENCODE_CHUNK_LATENT``
        latent frames at a time) with each causal conv's and downsample's
        frames carried: the whole encode's result."""
        mods = [m for m in self.encoder.modules() if isinstance(m, (CausalConv3d, WanResample))]
        step = ENCODE_CHUNK_LATENT * self.cfg.temporal_scale
        bounds = [0, 1] + list(range(1 + step, x.shape[2], step)) + [x.shape[2]]
        for m in mods:
            m.stream, m._prev = True, None
        try:
            out = [self.encoder(x[:, :, a:b]) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
        finally:
            for m in mods:
                m.stream, m._prev = False, None
        return torch.cat(out, dim=2)

    def encode(self, video: torch.Tensor, sample: bool = False, noise=None) -> torch.Tensor:
        """[B,3,T,H,W] in [-1, 1] → model-space latents [B,z,T',H/s,W/s];
        in time chunks above ``ENCODE_WHOLE_MAX_PIXELS``."""
        t, h, w = video.shape[2:]
        chunked = t * h * w > ENCODE_WHOLE_MAX_PIXELS and (t - 1) % self.cfg.temporal_scale == 0
        if self.cfg.patch_size:
            video = patchify(video, self.cfg.patch_size)
        mean, logvar = self.quant_conv(self.encode_chunked(video) if chunked else self.encoder(video)).chunk(2, dim=1)
        z = mean
        if sample and noise is not None:
            z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
        m, s = self._mean_std(z.device)
        return z if m is None else (z - m) / s

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Model-space latents → [B,3,T,H,W] in [-1, 1]."""
        m, s = self._mean_std(z.device)
        if m is not None:
            z = z * s + m
        out = self.decoder(self.post_quant_conv(z))
        return unpatchify(out, self.cfg.patch_size) if self.cfg.patch_size else out
