"""HunyuanVideo (the original) 3D-causal video VAE, port of
``apex_studio_tpu/models/vaes/hunyuanvideo_vae.py`` (diffusers
``AutoencoderKLHunyuanVideo``): 8× spatial and 4× temporal compression to 16
latent channels, ``scaling_factor`` 0.476986.

The JAX module runs NDHWC with DHWIO kernels; this one runs NCDHW with OIDHW
kernels (``loaders/from_jax.py`` transposes on carry). What it computes:

- causal convs padded by **replicate**: time in front by ``2·pt`` frames,
  space on both sides (the Wan VAE's causal conv pads zeros);
- resnets GroupNorm(32) → SiLU → conv, twice, plus a 1×1 shortcut where the
  width changes; the group norm computes in f32 and returns the input dtype;
- the encoder downsamples by a strided causal conv, stride (2, 2, 2) at the
  levels that halve time and (1, 2, 2) at the others; the decoder upsamples
  by nearest ×2 with frame 0 exempt from the temporal repeat, then a causal
  conv;
- each mid block is resnet, single-head attention over all t·h·w tokens with
  a frame-causal mask (f32 scores, −1e30 where the key's frame is later than
  the query's), resnet. The JAX module builds the whole ``[S, S]`` score
  matrix (67 GB at 33 frames of 720×1280); this one computes it in query-row
  chunks over the keys of the frames each chunk may see, so no ``[S, S]``
  matrix exists. A masked key's weight is exactly 0 in both. It stays on
  the plain route, as in JAX: head dim 512 and a block mask are not what the
  kernel takes.

Parameters are f32; convolutions and projections compute in the ``dtype``
the module is built with.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear
from apex_studio_tpu_torch.models.registry import vae_registry

# query rows a chunk of the mid attention: 4096 rows against 129,600 keys
# hold 2.1 GB of f32 scores
MID_ATTENTION_ROWS = 4096
# elements of a causal conv's padded input (or output) in one conv call
CONV_CHUNK_ELEMENTS = 1 << 30
# elements of a half-precision group norm's input normalised whole in f32
GROUP_NORM_CHUNK_ELEMENTS = 1 << 28


@dataclasses.dataclass
class HunyuanVideoVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.476986
    spatial_compression_ratio: int = 8
    temporal_compression_ratio: int = 4
    mid_block_add_attention: bool = True

    @classmethod
    def from_dict(cls, cfg: dict) -> "HunyuanVideoVAEConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "block_out_channels" in kw:
            kw["block_out_channels"] = tuple(kw["block_out_channels"])
        return cls(**kw)

    @property
    def spatial_scale(self) -> int:
        return self.spatial_compression_ratio

    @property
    def temporal_scale(self) -> int:
        return self.temporal_compression_ratio


def _triple(v):
    return (v,) * 3 if isinstance(v, int) else tuple(v)


class CausalConv3d(nn.Module):
    """Conv3d, replicate-padded: ``2·pt`` frames in front, ``ph``/``pw`` on
    both sides of space; NCDHW, weight OIDHW. A call whose padded input or
    output would pass ``CONV_CHUNK_ELEMENTS`` runs in chunks of output frames,
    each padding only the frames it reads: a 720×1280 activation of 128
    channels is past torch's 32-bit indexing, and the whole padded copy is
    not built. The sums are the same."""

    def __init__(self, cin: int, cout: int, kernel=3, stride=1, padding=1, *, dtype):
        super().__init__()
        kernel, self.stride, self.pad = _triple(kernel), _triple(stride), _triple(padding)
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(cout, dtype=torch.float32))
        self.dtype = dtype

    def _padded(self, x: torch.Tensor, p0: int, p1: int) -> torch.Tensor:
        """Frames [p0, p1) of the padded input (frame p is input frame
        max(p − 2·pt, 0))."""
        pt, ph, pw = self.pad
        lo, hi = max(p0 - 2 * pt, 0), p1 - 2 * pt
        front = max(2 * pt - p0, 0)
        x = x[:, :, lo:hi].to(self.dtype)
        if front or ph or pw:
            x = F.pad(x, (pw, pw, ph, ph, front, 0), mode="replicate")
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pt, ph, pw = self.pad
        kt, st = self.weight.shape[2], self.stride[0]
        w, bias = self.weight.to(self.dtype), self.bias.to(self.dtype)
        b, _, t, h, wd = x.shape
        t_pad = t + 2 * pt
        t_out = (t_pad - kt) // st + 1
        per_frame = b * max(x.shape[1], w.shape[0]) * (h + 2 * ph) * (wd + 2 * pw)
        frames = max(1, CONV_CHUNK_ELEMENTS // per_frame // max(st, 1) - kt)
        if t_pad * per_frame <= CONV_CHUNK_ELEMENTS or frames >= t_out:
            return F.conv3d(self._padded(x, 0, t_pad), w, bias, stride=self.stride)
        out = None
        for o0 in range(0, t_out, frames):
            o1 = min(t_out, o0 + frames)
            y = F.conv3d(self._padded(x, o0 * st, (o1 - 1) * st + kt), w, bias, stride=self.stride)
            if out is None:
                out = torch.empty((b, y.shape[1], t_out, *y.shape[3:]), dtype=y.dtype, device=y.device)
            out[:, :, o0:o1] = y
            del y
        return out


class GroupNormCh(nn.Module):
    """GroupNorm over channels in f32 (population variance; float64 kept) with
    the f32 affine, cast back to the input's dtype; port of the JAX
    ``cogvideox_vae.GroupNormCh``. A half input of more than
    ``GROUP_NORM_CHUNK_ELEMENTS`` elements is normalised in chunks of frames
    (``whole`` / ``chunks``: two f32 passes for the statistics, summed in
    float64, one for the output), so no f32 copy of a 720p activation is
    built."""

    def __init__(self, num_groups: int, dim: int, *, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32))
        self.groups = min(num_groups, dim)
        while dim % self.groups:
            self.groups -= 1
        self.eps = eps

    def whole(self, x: torch.Tensor) -> bool:
        return x.dtype in (torch.float32, torch.float64) or x.numel() <= GROUP_NORM_CHUNK_ELEMENTS

    def chunks(self, x: torch.Tensor):
        frames = max(1, GROUP_NORM_CHUNK_ELEMENTS // x[:, :, :1].numel())
        return [slice(t0, min(x.shape[2], t0 + frames)) for t0 in range(0, x.shape[2], frames)]

    def stats(self, x: torch.Tensor):
        """(mean, rstd) [B, G, 1, 1] in f32 over every frame of ``x``, summed
        chunk by chunk in float64."""
        b, c = x.shape[:2]
        g = self.groups

        def grouped(sl):
            return x[:, :, sl].float().reshape(b, g, c // g, -1)

        chunks = self.chunks(x)
        n = x.numel() // (b * g)
        mean = sum(grouped(sl).sum(dim=(2, 3), dtype=torch.float64) for sl in chunks) / n
        mean = mean.float()[:, :, None, None]
        var = sum(((grouped(sl) - mean) ** 2).sum(dim=(2, 3), dtype=torch.float64) for sl in chunks) / n
        return mean, torch.rsqrt(var.float() + self.eps)[:, :, None, None]

    def apply(self, x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor) -> torch.Tensor:
        """``x`` (some frames) normalised by ``stats`` of the whole, with the affine."""
        b, c = x.shape[:2]
        y = ((x.float().reshape(b, self.groups, c // self.groups, -1) - mean) * rstd).reshape(x.shape)
        shape = (1, c) + (1,) * (x.ndim - 2)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.whole(x):
            x32 = x if x.dtype == torch.float64 else x.float()
            return F.group_norm(x32, self.groups, self.weight.to(x32.dtype), self.bias.to(x32.dtype),
                                self.eps).to(x.dtype)
        mean, rstd = self.stats(x)
        out = torch.empty_like(x)
        for sl in self.chunks(x):
            out[:, :, sl] = self.apply(x[:, :, sl], mean, rstd)
        return out


class HVResnet(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, *, dtype):
        super().__init__()
        self.norm1 = GroupNormCh(groups, cin)
        self.conv1 = CausalConv3d(cin, cout, dtype=dtype)
        self.norm2 = GroupNormCh(groups, cout)
        self.conv2 = CausalConv3d(cout, cout, dtype=dtype)
        self.conv_shortcut = CausalConv3d(cin, cout, kernel=1, padding=0, dtype=dtype) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x), inplace=True))
        h = self.conv2(F.silu(self.norm2(h), inplace=True))
        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return h.add_(skip)  # both in the conv dtype


def frame_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tokens_per_frame: int,
                           rows: Optional[int] = None) -> torch.Tensor:
    """Single-head attention [B, S, C] with the frame-causal mask, in f32:
    scores ``q·kᵀ/√C`` plus −1e30 where the key's frame is after the query's,
    softmax, P·V. Computed ``rows`` query rows at a time against the keys of
    the frames up to the chunk's last one (the later keys' weights are
    exactly 0), so no [S, S] matrix is built. ``rows`` defaults to
    ``MID_ATTENTION_ROWS`` as it is at the call."""
    rows = rows or MID_ATTENTION_ROWS
    b, s, c = q.shape
    scale = c ** -0.5
    frame = torch.arange(s, device=q.device) // tokens_per_frame
    out = torch.empty(b, s, c, dtype=torch.float32, device=q.device)
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        n_keys = (int(frame[r1 - 1]) + 1) * tokens_per_frame
        scores = torch.einsum("bqc,bkc->bqk", q[:, r0:r1].float(), k[:, :n_keys].float()) * scale
        later = frame[None, :n_keys] > frame[r0:r1, None]
        scores = scores + torch.where(later, -1e30, 0.0)
        p = torch.softmax(scores, dim=-1)
        del scores
        out[:, r0:r1] = torch.einsum("bqk,bkc->bqc", p, v[:, :n_keys].float())
        del p
    return out


class HVMidAttention(nn.Module):
    def __init__(self, dim: int, groups: int, *, dtype):
        super().__init__()
        self.group_norm = GroupNormCh(groups, dim)
        for name in ("to_q", "to_k", "to_v", "to_out"):
            setattr(self, name, Linear(dim, dim, dtype=dtype, param_dtype=torch.float32))
        self.dim = dim

    def forward(self, x):
        b, c, t, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, t * h * w).transpose(1, 2)  # [B, S, C]
        out = frame_causal_attention(self.to_q(y), self.to_k(y), self.to_v(y), h * w)
        out = self.to_out(out.to(x.dtype))
        return x + out.transpose(1, 2).reshape(b, c, t, h, w)


class HVMidBlock(nn.Module):
    def __init__(self, dim: int, groups: int, add_attention: bool, *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([HVResnet(dim, dim, groups, dtype=dtype) for _ in range(2)])
        self.attentions = nn.ModuleList([HVMidAttention(dim, groups, dtype=dtype)]) if add_attention else None

    def forward(self, x):
        x = self.resnets[0](x)
        if self.attentions is not None:
            x = self.attentions[0](x)
        return self.resnets[1](x)


class HVDownsample(nn.Module):
    def __init__(self, dim: int, stride, *, dtype):
        super().__init__()
        self.conv = CausalConv3d(dim, dim, kernel=3, stride=stride, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class HVUpsample(nn.Module):
    """Nearest ×factor, frame 0 exempt from the temporal repeat, then a
    causal conv."""

    def __init__(self, dim: int, factor, *, dtype):
        super().__init__()
        self.conv = CausalConv3d(dim, dim, dtype=dtype)
        self.factor = factor

    def forward(self, x):
        ft, fh, fw = self.factor
        if ft > 1 and x.shape[2] > 1:
            x = torch.cat([x[:, :, :1], x[:, :, 1:].repeat_interleave(ft, dim=2)], dim=2)
        if fh > 1 or fw > 1:
            b, c, t, h, w = x.shape
            x = x[:, :, :, :, None, :, None].expand(b, c, t, h, fh, w, fw).reshape(b, c, t, h * fh, w * fw)
        return self.conv(x)


class HVDownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, num_layers: int, groups: int, stride, *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList(
            [HVResnet(cin if i == 0 else cout, cout, groups, dtype=dtype) for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([HVDownsample(cout, stride, dtype=dtype)])
                             if stride is not None else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class HVUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, num_layers: int, groups: int, factor, *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList(
            [HVResnet(cin if i == 0 else cout, cout, groups, dtype=dtype) for i in range(num_layers)])
        self.upsamplers = (nn.ModuleList([HVUpsample(cout, factor, dtype=dtype)])
                           if factor is not None else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


def _scale_plan(cfg: HunyuanVideoVAEConfig):
    """Per level: (t, h, w) factor of its down/upsampler, or None. Space
    halves at the first log2(spatial) levels, time at the log2(temporal)
    levels before the last."""
    n = len(cfg.block_out_channels)
    n_sp = int(np.log2(cfg.spatial_compression_ratio))
    n_t = int(np.log2(cfg.temporal_compression_ratio))
    plan = []
    for i in range(n):
        sp = i < n_sp
        tm = i >= (n - 1 - n_t) and i != n - 1
        plan.append((2 if tm else 1, 2 if sp else 1, 2 if sp else 1) if sp or tm else None)
    return plan


class HVEncoder(nn.Module):
    def __init__(self, cfg: HunyuanVideoVAEConfig, *, dtype):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = CausalConv3d(cfg.in_channels, ch[0], dtype=dtype)
        self.down_blocks = nn.ModuleList(
            [HVDownBlock(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block, g, stride, dtype=dtype)
             for i, stride in enumerate(_scale_plan(cfg))])
        self.mid_block = HVMidBlock(ch[-1], g, cfg.mid_block_add_attention, dtype=dtype)
        self.conv_norm_out = GroupNormCh(g, ch[-1])
        self.conv_out = CausalConv3d(ch[-1], 2 * cfg.latent_channels, dtype=dtype)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class HVDecoder(nn.Module):
    def __init__(self, cfg: HunyuanVideoVAEConfig, *, dtype):
        super().__init__()
        ch, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = CausalConv3d(cfg.latent_channels, ch[0], dtype=dtype)
        self.mid_block = HVMidBlock(ch[0], g, cfg.mid_block_add_attention, dtype=dtype)
        self.up_blocks = nn.ModuleList(
            [HVUpBlock(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block + 1, g, factor, dtype=dtype)
             for i, factor in enumerate(_scale_plan(cfg))])
        self.conv_norm_out = GroupNormCh(g, ch[-1])
        self.conv_out = CausalConv3d(ch[-1], cfg.out_channels, dtype=dtype)

    def forward(self, z):
        z = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            z = blk(z)
        return self.conv_out(F.silu(self.conv_norm_out(z), inplace=True))


@vae_registry.register("hunyuanvideo", aliases=("AutoencoderKLHunyuanVideo", "hunyuanvideo.vae"))
class AutoencoderKLHunyuanVideo(nn.Module):
    config_class = HunyuanVideoVAEConfig

    def __init__(self, cfg: HunyuanVideoVAEConfig, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder = HVEncoder(cfg, dtype=dtype)
        self.decoder = HVDecoder(cfg, dtype=dtype)
        z2 = 2 * cfg.latent_channels
        self.quant_conv = CausalConv3d(z2, z2, kernel=1, padding=0, dtype=dtype)
        self.post_quant_conv = CausalConv3d(cfg.latent_channels, cfg.latent_channels, kernel=1, padding=0,
                                            dtype=dtype)

    def encode(self, video: torch.Tensor, sample: bool = False, noise: Optional[torch.Tensor] = None):
        """[B,3,T,H,W] in [-1, 1] → scaled latents [B,16,T',H/8,W/8] (f32)."""
        moments = self.quant_conv(self.encoder(video.float())).float()
        mean, logvar = moments.chunk(2, dim=1)
        z = mean
        if sample and noise is not None:
            z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
        return z * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents → video [B,3,T,H,W] in [-1, 1] (f32)."""
        out = self.decoder(self.post_quant_conv(z.float() / self.cfg.scaling_factor))
        return out.float().clamp(-1.0, 1.0)
