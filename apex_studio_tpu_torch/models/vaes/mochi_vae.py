"""Mochi-1 video VAE, encoder and decoder, port of
``apex_studio_tpu/models/vaes/mochi_vae.py`` (NCTHW here, NTHWC there).

- every norm is a PER-FRAME GroupNorm(32, eps 1e-5): statistics never mix time
- causal convs pad with replicate on every axis at once (time front k_t − 1,
  space (k − 1)//2 on each side); resnets have no conv shortcut (in == out)
- encoder: Fourier features (3 → 15 channels) → proj_in Linear → block_in →
  3 strided-conv down blocks with causal time attention at each spatial
  location (l2-normalised 32-dim heads, plain torch as in JAX's einsum) →
  block_out (attended) → norm / silu → proj_out Linear to 2·12 moments
- decoder: 1×1×1 conv_in → block_in → 3 up blocks (resnets, then a Linear
  whose channels unshuffle as (c, t, s, s), c slowest) → block_out → silu →
  proj_out Linear; no final norm, no attention
- decode drops the leading temporal_compression − 1 phantom frames once, at
  the end; latents are normalised per channel by latents_mean / std

Memory: at the manifest's 85 frames of 480×848 the last stage holds 128
channels over 90 × 480 × 848 positions, 18.8 GB a tensor in f32. Each conv,
norm and channel Linear runs over frame chunks of at most ``CHUNK_ELEMENTS``
input elements (cuDNN indexes a tensor with 32 bits) into one output tensor,
and a resnet's convs and norms write in place where their shapes allow, so a
resnet holds its input and one more tensor of its size. Every output frame is
the whole op's: a chunk reads all the frames its outputs depend on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear
from apex_studio_tpu_torch.models.registry import vae_registry

CHUNK_ELEMENTS = 1 << 29


@dataclasses.dataclass
class MochiVAEConfig:
    in_channels: int = 15
    latent_channels: int = 12
    out_channels: int = 3
    encoder_block_out_channels: Optional[Tuple[int, ...]] = None
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 768)
    layers_per_block: Tuple[int, ...] = (3, 3, 4, 6, 3)
    temporal_expansions: Tuple[int, ...] = (1, 2, 3)
    spatial_expansions: Tuple[int, ...] = (2, 2, 2)
    add_attention_block: Tuple[bool, ...] = (False, True, True, True, True)
    norm_num_groups: int = 32
    latents_mean: Optional[Tuple[float, ...]] = None
    latents_std: Optional[Tuple[float, ...]] = None

    @classmethod
    def from_dict(cls, cfg: dict) -> "MochiVAEConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        for key in ("block_out_channels", "encoder_block_out_channels", "layers_per_block", "temporal_expansions",
                    "spatial_expansions", "add_attention_block", "latents_mean", "latents_std"):
            if key in kw and kw[key] is not None:
                kw[key] = tuple(kw[key])
        return cls(**kw)

    def __post_init__(self):
        if self.encoder_block_out_channels is None:
            self.encoder_block_out_channels = self.block_out_channels
        # the diffusers layout carries N+1 layer counts (block_in, per down
        # block, block_out); legacy N-length configs pad with their first value
        n = len(self.block_out_channels)
        if len(self.layers_per_block) == n:
            self.layers_per_block = (self.layers_per_block[0], *self.layers_per_block)
        if len(self.add_attention_block) < n + 1:
            self.add_attention_block = (self.add_attention_block
                                        + (self.add_attention_block[-1],) * (n + 1 - len(self.add_attention_block)))

    @property
    def spatial_scale(self) -> int:
        return int(np.prod(self.spatial_expansions))

    @property
    def temporal_scale(self) -> int:
        return int(np.prod(self.temporal_expansions))


def _frames_a_chunk(per_frame: int) -> int:
    return max(1, CHUNK_ELEMENTS // max(per_frame, 1))


class MochiGroupNorm(nn.Module):
    """PER-FRAME GroupNorm; torch's defaults (eps 1e-5). ``out`` may be ``x``."""

    def __init__(self, dim: int, groups: int = 32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32))
        self.groups = min(groups, dim)
        while dim % self.groups:
            self.groups -= 1
        self.eps = 1e-5

    def forward(self, x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c, t, h, w = x.shape
        g = self.groups
        out = torch.empty_like(x) if out is None else out
        wt = self.weight.float().view(1, g, c // g, 1, 1)
        bs = self.bias.float().view(1, g, c // g, 1, 1)
        step = _frames_a_chunk(c * h * w)
        for t0 in range(0, t, step):
            t1 = min(t, t0 + step)
            xs = x[:, :, t0:t1].float().reshape(b, g, c // g, t1 - t0, h * w)
            var, mean = torch.var_mean(xs, dim=(2, 4), unbiased=False, keepdim=True)
            scale = torch.rsqrt(var + self.eps) * wt
            y = torch.addcmul(bs - mean * scale, xs, scale)
            out[:, :, t0:t1] = y.reshape(b, c, t1 - t0, h, w).to(out.dtype)
        return out


class MochiConv3dRep(nn.Module):
    """Replicate padding (time front k_t − 1, space (k − 1)//2 a side), then a
    strided VALID conv. ``out`` may be ``x`` when the conv keeps the shape
    (stride 1, cin == cout): the chunks then run from the last frames to the
    first, each reading its input frames before it writes its output."""

    def __init__(self, cin: int, cout: int, kernel=3, stride=1, *, dtype):
        super().__init__()
        kernel = (kernel,) * 3 if isinstance(kernel, int) else tuple(kernel)
        stride = (stride, 1, 1) if isinstance(stride, int) else tuple(stride)
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=torch.float32))
        self.k = kernel
        self.stride = stride
        self.dtype = dtype

    def forward(self, x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        kt, kh, kw = self.k
        st, sh, sw = self.stride
        ph, pw = (kh - 1) // 2, (kw - 1) // 2
        b, c, t, h, w = x.shape
        t_out, h_out, w_out = (t - 1) // st + 1, (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
        if out is None:
            out = x.new_empty(b, self.weight.shape[0], t_out, h_out, w_out, dtype=self.dtype)
        elif out is x:
            assert self.stride == (1, 1, 1) and tuple(out.shape) == (b, self.weight.shape[0], t_out, h_out, w_out)
        weight, bias = self.weight.to(self.dtype), self.bias.to(self.dtype)
        step = _frames_a_chunk(max(c * (h + 2 * ph) * (w + 2 * pw) * st, out.shape[1] * h_out * w_out))
        for o0 in reversed(range(0, t_out, step)):
            o1 = min(t_out, o0 + step)
            idx = (torch.arange(o0 * st, (o1 - 1) * st + kt, device=x.device) - (kt - 1)).clamp_min(0)
            xi = x.index_select(2, idx).to(self.dtype)
            if ph or pw:
                xi = F.pad(xi, (pw, pw, ph, ph, 0, 0), mode="replicate")
            out[:, :, o0:o1] = F.conv3d(xi, weight, bias, stride=self.stride)
            del xi
        return out


def channel_linear(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    """A Linear over the channels of ``x [B, C, T, H, W]`` (a 1×1×1 conv), by
    frame chunks."""
    b, c, t, h, w = x.shape
    weight = lin.weight.to(lin.dtype)[:, :, None, None, None]
    bias = None if lin.bias is None else lin.bias.to(lin.dtype)
    out = x.new_empty(b, weight.shape[0], t, h, w, dtype=lin.dtype)
    step = _frames_a_chunk(max(c, weight.shape[0]) * h * w)
    for t0 in range(0, t, step):
        out[:, :, t0:t0 + step] = F.conv3d(x[:, :, t0:t0 + step].to(lin.dtype), weight, bias)
    return out


class MochiResnetBlock3D(nn.Module):
    """norm → silu → replicate conv, twice, with a plain residual add."""

    def __init__(self, dim: int, *, dtype):
        super().__init__()
        self.norm1 = MochiGroupNorm(dim)
        self.conv1 = MochiConv3dRep(dim, dim, dtype=dtype)
        self.norm2 = MochiGroupNorm(dim)
        self.conv2 = MochiConv3dRep(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.norm1(x), inplace=True)
        h = self.conv1(h, out=h)
        h = F.silu(self.norm2(h, out=h), inplace=True)
        return self.conv2(h, out=h).add_(x)


class MochiTimeAttn(nn.Module):
    """Causal attention over TIME at each spatial location (encoder only):
    l2-normalised q / k per 32-dim head. T == 1 runs to_v then to_out."""

    def __init__(self, dim: int, *, dtype):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=torch.float32)
        self.to_q = Linear(dim, dim, use_bias=False, **kw)
        self.to_k = Linear(dim, dim, use_bias=False, **kw)
        self.to_v = Linear(dim, dim, use_bias=False, **kw)
        self.to_out = Linear(dim, dim, use_bias=True, **kw)
        self.heads = max(1, dim // 32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The attention output only: the caller adds the pre-norm residual."""
        b, c, t, h, w = x.shape
        y = x.permute(0, 3, 4, 2, 1).reshape(b * h * w, t, c)
        if t == 1:
            out = self.to_out(self.to_v(y))
        else:
            hd = c // self.heads

            def l2(u):
                u = u.float()
                return u / torch.linalg.vector_norm(u, dim=-1, keepdim=True).clamp_min(1e-5)

            q = l2(self.to_q(y).reshape(-1, t, self.heads, hd))
            k = l2(self.to_k(y).reshape(-1, t, self.heads, hd))
            v = self.to_v(y).reshape(-1, t, self.heads, hd)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
            att = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", att, v.float()).reshape(-1, t, c)
            out = self.to_out(out.to(x.dtype))
        return out.reshape(b, h, w, t, c).permute(0, 4, 3, 1, 2)


class MochiMidBlock3D(nn.Module):
    """N resnets, each optionally followed by norm + causal time attention."""

    def __init__(self, dim: int, num_layers: int, attend: bool, *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([MochiResnetBlock3D(dim, dtype=dtype) for _ in range(num_layers)])
        self.norms = nn.ModuleList([MochiGroupNorm(dim) for _ in range(num_layers)]) if attend else None
        self.attentions = (nn.ModuleList([MochiTimeAttn(dim, dtype=dtype) for _ in range(num_layers)])
                           if attend else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, r in enumerate(self.resnets):
            x = r(x)
            if self.attentions is not None:
                x = x + self.attentions[i](self.norms[i](x))
        return x


class MochiDownBlock3D(MochiMidBlock3D):
    """A strided replicate conv (kernel == stride == (te, se, se)), then the
    attended resnets."""

    def __init__(self, cin: int, cout: int, num_layers: int, te: int, se: int, attend: bool, *, dtype):
        super().__init__(cout, num_layers, attend, dtype=dtype)
        self.conv_in = MochiConv3dRep(cin, cout, kernel=(te, se, se), stride=(te, se, se), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(self.conv_in(x))


class MochiUpBlock3D(nn.Module):
    """Resnets, then a Linear whose channels unshuffle as (c, t_exp, s_exp,
    s_exp), c slowest; the frames are cropped once, in ``decode``."""

    def __init__(self, cin: int, cout: int, num_layers: int, t_exp: int, s_exp: int, *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([MochiResnetBlock3D(cin, dtype=dtype) for _ in range(num_layers)])
        self.proj = Linear(cin, cout * t_exp * s_exp * s_exp, use_bias=True, dtype=dtype, param_dtype=torch.float32)
        self.t_exp, self.s_exp, self.cout = t_exp, s_exp, cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        b, cin, t, h, w = x.shape
        te, se, c = self.t_exp, self.s_exp, self.cout
        out = x.new_empty(b, c, t * te, h * se, w * se, dtype=self.proj.dtype)
        step = _frames_a_chunk(c * te * se * se * h * w)
        for t0 in range(0, t, step):
            t1 = min(t, t0 + step)
            y = channel_linear(self.proj, x[:, :, t0:t1]).reshape(b, c, te, se, se, t1 - t0, h, w)
            out[:, :, t0 * te:t1 * te] = y.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(b, c, (t1 - t0) * te, h * se,
                                                                                    w * se)
            del y
        return out


def _fourier_features(x: torch.Tensor, start: int = 6, stop: int = 8) -> torch.Tensor:
    """concat(x, sin(2^f·2π·x), cos(...)) over the channels, each input
    channel's frequencies together."""
    x32 = x.float()
    c, nf = x32.shape[1], stop - start
    freqs = (2.0 ** np.arange(start, stop, dtype=np.float32)) * 2.0 * np.pi
    wts = torch.from_numpy(np.tile(freqs, c).astype(np.float32)).to(x.device)
    hh = x32.repeat_interleave(nf, dim=1) * wts[None, :, None, None, None]
    return torch.cat([x32, torch.sin(hh), torch.cos(hh)], dim=1).to(x.dtype)


class MochiEncoder3D(nn.Module):
    def __init__(self, cfg: MochiVAEConfig, *, dtype):
        super().__init__()
        ch, layers, attend = cfg.encoder_block_out_channels, cfg.layers_per_block, cfg.add_attention_block
        kw = dict(dtype=dtype, param_dtype=torch.float32)
        self.proj_in = Linear(cfg.in_channels, ch[0], use_bias=True, **kw)
        self.block_in = MochiMidBlock3D(ch[0], layers[0], attend[0], dtype=dtype)
        self.down_blocks = nn.ModuleList([
            MochiDownBlock3D(ch[i], ch[i + 1], layers[i + 1], cfg.temporal_expansions[i], cfg.spatial_expansions[i],
                             attend[i + 1], dtype=dtype)
            for i in range(len(ch) - 1)])
        self.block_out = MochiMidBlock3D(ch[-1], layers[-1], attend[-1], dtype=dtype)
        self.norm_out = MochiGroupNorm(ch[-1])
        self.proj_out = Linear(ch[-1], 2 * cfg.latent_channels, use_bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.block_in(channel_linear(self.proj_in, _fourier_features(x)))
        for blk in self.down_blocks:
            x = blk(x)
        x = self.block_out(x)
        return channel_linear(self.proj_out, F.silu(self.norm_out(x)))


class MochiDecoder3D(nn.Module):
    def __init__(self, cfg: MochiVAEConfig, *, dtype):
        super().__init__()
        ch, layers = cfg.block_out_channels, cfg.layers_per_block
        self.conv_in = MochiConv3dRep(cfg.latent_channels, ch[-1], kernel=1, dtype=dtype)
        self.block_in = MochiMidBlock3D(ch[-1], layers[-1], False, dtype=dtype)
        self.up_blocks = nn.ModuleList([
            MochiUpBlock3D(ch[-i - 1], ch[-i - 2], layers[-i - 2], cfg.temporal_expansions[-i - 1],
                           cfg.spatial_expansions[-i - 1], dtype=dtype)
            for i in range(len(ch) - 1)])
        self.block_out = MochiMidBlock3D(ch[0], layers[0], False, dtype=dtype)
        self.proj_out = Linear(ch[0], cfg.out_channels, use_bias=True, dtype=dtype, param_dtype=torch.float32)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.block_in(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        x = self.block_out(x)
        return channel_linear(self.proj_out, F.silu(x, inplace=True))  # no final norm


@vae_registry.register("mochi.base", aliases=("mochi", "AutoencoderKLMochi"))
class AutoencoderKLMochi(nn.Module):
    config_class = MochiVAEConfig

    def __init__(self, cfg: MochiVAEConfig, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.encoder = MochiEncoder3D(cfg, dtype=dtype)
        self.decoder = MochiDecoder3D(cfg, dtype=dtype)

    def _mean_std(self, device):
        if self.cfg.latents_mean is None:
            return None, None
        mean = torch.tensor(self.cfg.latents_mean, dtype=torch.float32, device=device).reshape(1, -1, 1, 1, 1)
        std = torch.tensor(self.cfg.latents_std, dtype=torch.float32, device=device).reshape(1, -1, 1, 1, 1)
        return mean, std

    def encode(self, video: torch.Tensor, sample: bool = False, noise=None) -> torch.Tensor:
        """[B, 3, T, H, W] in [-1, 1] → model-space latents [B, 12, T', h, w]."""
        mean, logvar = self.encoder(video).chunk(2, dim=1)
        z = mean
        if sample and noise is not None:
            z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
        m, s = self._mean_std(z.device)
        if m is not None:
            z = (z - m) / s
        return z

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Model-space latents [B, 12, T', h, w] → [B, 3, T, H, W]; the leading
        temporal_compression − 1 phantom frames dropped."""
        m, s = self._mean_std(z.device)
        if m is not None:
            z = z * s + m
        out = self.decoder(z)
        tcr = self.cfg.temporal_scale
        if out.shape[2] >= tcr:
            out = out[:, :, tcr - 1:]
        return out
