"""HunyuanVideo 1.5 causal 3D video VAE, port of
``apex_studio_tpu/models/vaes/hunyuanvideo15_vae.py``.

The JAX module runs NDHWC with DHWIO kernels; this one runs NCDHW with OIDHW
kernels (``loaders/from_jax.py`` transposes on carry), and every space↔channel
shuffle below keeps the JAX channel order (r1, r2, r3, c). What it computes:

- causal 3×3×3 convs padded by **replicate** (time front k−1, space k//2);
- down/upsampling by pixel shuffles with channel-mean / repeat shortcuts; the
  temporal shuffles treat frame 0 on its own, so T latent frames ↔ 4(T−1)+1
  pixel frames and 16× in space;
- a mid-block attention over (t·h·w) tokens with a block-causal time mask,
  through the plain-math route (the JAX module forces XLA there);
- 32-channel latents scaled by one ``scaling_factor``.

Parameters are f32; convolutions and projections compute in the ``dtype``
the module is built with, as in the JAX module. The engine builds it in the
component's precision: bf16 for the published manifest, whose ``fp32`` is
declared per weight variant, which neither package's ``_component_dtype``
reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear
from apex_studio_tpu_torch.models.registry import vae_registry


@dataclasses.dataclass
class HYV15VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 32
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 1024, 1024)
    layers_per_block: int = 2
    spatial_compression_ratio: int = 16
    temporal_compression_ratio: int = 4
    downsample_match_channel: bool = True
    scaling_factor: float = 1.03682

    @classmethod
    def from_dict(cls, cfg: dict) -> "HYV15VAEConfig":
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


class CausalConv3dRep(nn.Module):
    """k×k×k (or 1×1×1) conv, replicate-padded, causal in time."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, *, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, kernel, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(cout, dtype=torch.float32))
        self.k = kernel
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.k
        if k > 1:
            p = k // 2
            x = F.pad(x, (p, p, p, p, k - 1, 0), mode="replicate")
        y = F.conv3d(x.to(self.dtype), self.weight.to(self.dtype))
        return y + self.bias.to(y.dtype)[:, None, None, None]


class RMSNormCh(nn.Module):
    """x / ‖x‖ over channels · √C · γ, in f32."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.scale = float(dim) ** 0.5

    def forward(self, x):
        x32 = x.float()
        norm = torch.linalg.vector_norm(x32, dim=1, keepdim=True)
        return (x32 / norm.clamp_min(1e-12) * self.scale * self.gamma[:, None, None, None]).to(x.dtype)


def _space_to_channel(x, r1, r2, r3):
    """[B,C,T·r1,H·r2,W·r3] → [B, r1·r2·r3·C, T,H,W] (channel order r1,r2,r3,c)."""
    b, c, t, h, w = x.shape
    x = x.reshape(b, c, t // r1, r1, h // r2, r2, w // r3, r3)
    x = x.permute(0, 3, 5, 7, 1, 2, 4, 6)
    return x.reshape(b, r1 * r2 * r3 * c, t // r1, h // r2, w // r3)


def _channel_to_space(x, r1, r2, r3):
    """[B, r1·r2·r3·C, T,H,W] → [B,C,T·r1,H·r2,W·r3]."""
    b, pc, t, h, w = x.shape
    c = pc // (r1 * r2 * r3)
    x = x.reshape(b, r1, r2, r3, c, t, h, w)
    x = x.permute(0, 4, 5, 1, 6, 2, 7, 3)
    return x.reshape(b, c, t * r1, h * r2, w * r3)


def _group_mean(x, groups_out: int, size: int):
    """Mean of consecutive channel groups: [B, groups_out·size, ...] → [B, groups_out, ...]."""
    b, _, *rest = x.shape
    return x.reshape(b, groups_out, size, *rest).mean(2)


class HYV15Downsample(nn.Module):
    def __init__(self, cin: int, cout: int, temporal: bool, *, dtype):
        super().__init__()
        factor = 8 if temporal else 4
        self.conv = CausalConv3dRep(cin, cout // factor, dtype=dtype)
        self.temporal = temporal
        self.group_size = factor * cin // cout

    def forward(self, x):
        h = self.conv(x)
        if self.temporal:
            h_first = _space_to_channel(h[:, :, :1], 1, 2, 2)
            h_first = torch.cat([h_first, h_first], dim=1)
            h_next = _space_to_channel(h[:, :, 1:], 2, 2, 2)
            h = torch.cat([h_first, h_next], dim=2)
            c_out = h.shape[1]
            x_first = _group_mean(_space_to_channel(x[:, :, :1], 1, 2, 2), c_out, self.group_size // 2)
            x_next = _group_mean(_space_to_channel(x[:, :, 1:], 2, 2, 2), c_out, self.group_size)
            shortcut = torch.cat([x_first, x_next], dim=2)
        else:
            h = _space_to_channel(h, 1, 2, 2)
            shortcut = _group_mean(_space_to_channel(x, 1, 2, 2), h.shape[1], self.group_size)
        return h + shortcut


class HYV15Upsample(nn.Module):
    def __init__(self, cin: int, cout: int, temporal: bool, *, dtype):
        super().__init__()
        factor = 8 if temporal else 4
        self.conv = CausalConv3dRep(cin, cout * factor, dtype=dtype)
        self.temporal = temporal
        self.repeats = factor * cout // cin

    def forward(self, x):
        h = self.conv(x)
        if self.temporal:
            h_first = _channel_to_space(h[:, :, :1], 1, 2, 2)
            h_first = h_first[:, : h_first.shape[1] // 2]
            h_next = _channel_to_space(h[:, :, 1:], 2, 2, 2)
            h = torch.cat([h_first, h_next], dim=2)
            x_first = _channel_to_space(x[:, :, :1], 1, 2, 2).repeat_interleave(self.repeats // 2, dim=1)
            x_next = _channel_to_space(x[:, :, 1:], 2, 2, 2).repeat_interleave(self.repeats, dim=1)
            shortcut = torch.cat([x_first, x_next], dim=2)
        else:
            h = _channel_to_space(h, 1, 2, 2)
            shortcut = _channel_to_space(x.repeat_interleave(self.repeats, dim=1), 1, 2, 2)
        return h + shortcut


class HYV15ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, *, dtype):
        super().__init__()
        self.norm1 = RMSNormCh(cin)
        self.conv1 = CausalConv3dRep(cin, cout, dtype=dtype)
        self.norm2 = RMSNormCh(cout)
        self.conv2 = CausalConv3dRep(cout, cout, dtype=dtype)
        self.conv_shortcut = CausalConv3dRep(cin, cout, kernel=1, dtype=dtype) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return skip + h


class HYV15AttnBlock(nn.Module):
    """Full (t·h·w) single-head attention with a block-causal time mask."""

    def __init__(self, dim: int, *, dtype):
        super().__init__()
        self.norm = RMSNormCh(dim)
        self.to_q = Linear(dim, dim, dtype=dtype, param_dtype=torch.float32)
        self.to_k = Linear(dim, dim, dtype=dtype, param_dtype=torch.float32)
        self.to_v = Linear(dim, dim, dtype=dtype, param_dtype=torch.float32)
        self.proj_out = Linear(dim, dim, dtype=dtype, param_dtype=torch.float32)

    def forward(self, x):
        from apex_studio_tpu_torch.ops.attention import attention as attention_op

        b, c, t, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 4, 1).reshape(b, t * h * w, c)
        q, k, v = (proj(y)[:, :, None, :] for proj in (self.to_q, self.to_k, self.to_v))
        frame = torch.arange(t * h * w, device=x.device) // (h * w)
        mask = (frame[:, None] >= frame[None, :])[None, None]
        out = attention_op(q, k, v, mask=mask, backend="xla")[:, :, 0]
        out = self.proj_out(out).reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
        return x + out


class HYV15MidBlock(nn.Module):
    def __init__(self, dim: int, *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([HYV15ResnetBlock(dim, dim, dtype=dtype) for _ in range(2)])
        self.attentions = nn.ModuleList([HYV15AttnBlock(dim, dtype=dtype)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Stage(nn.Module):
    """One down/up block: resnets, then an optional resampler (the JAX
    module's ``nnx.Dict(resnets=..., downsamplers|upsamplers=...)``)."""

    def __init__(self, resnets, sampler_name: str, sampler):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.sampler_name = sampler_name
        setattr(self, sampler_name, nn.ModuleList([sampler]) if sampler is not None else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        sampler = getattr(self, self.sampler_name)
        return sampler[0](x) if sampler is not None else x


class HYV15Encoder(nn.Module):
    def __init__(self, cfg: HYV15VAEConfig, *, dtype):
        super().__init__()
        ch = cfg.block_out_channels
        z2 = cfg.latent_channels * 2
        self.group_size = ch[-1] // z2
        self.conv_in = CausalConv3dRep(cfg.in_channels, ch[0], dtype=dtype)
        n_spatial = int(math.log2(cfg.spatial_compression_ratio))
        t_start = int(math.log2(cfg.spatial_compression_ratio // cfg.temporal_compression_ratio))
        blocks, cin = [], ch[0]
        for i, cout in enumerate(ch):
            res = [HYV15ResnetBlock(cin if j == 0 else cout, cout, dtype=dtype)
                   for j in range(cfg.layers_per_block)]
            down = None
            if i < n_spatial:
                d_out = ch[i + 1] if cfg.downsample_match_channel else cout
                down = HYV15Downsample(cout, d_out, temporal=(i >= t_start), dtype=dtype)
                cin = d_out
            else:
                cin = cout
            blocks.append(_Stage(res, "downsamplers", down))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = HYV15MidBlock(ch[-1], dtype=dtype)
        self.norm_out = RMSNormCh(ch[-1])
        self.conv_out = CausalConv3dRep(ch[-1], z2, dtype=dtype)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        shortcut = _group_mean(x, x.shape[1] // self.group_size, self.group_size)
        return self.conv_out(F.silu(self.norm_out(x))) + shortcut


class HYV15Decoder(nn.Module):
    def __init__(self, cfg: HYV15VAEConfig, *, dtype):
        super().__init__()
        ch = tuple(reversed(cfg.block_out_channels))
        self.repeat = ch[0] // cfg.latent_channels
        self.conv_in = CausalConv3dRep(cfg.latent_channels, ch[0], dtype=dtype)
        self.mid_block = HYV15MidBlock(ch[0], dtype=dtype)
        n_spatial = int(math.log2(cfg.spatial_compression_ratio))
        n_temporal = int(math.log2(cfg.temporal_compression_ratio))
        blocks, cin = [], ch[0]
        for i, cout in enumerate(ch):
            res = [HYV15ResnetBlock(cin if j == 0 else cout, cout, dtype=dtype)
                   for j in range(cfg.layers_per_block + 1)]
            up = None
            if i < n_spatial:
                u_out = ch[i + 1] if cfg.downsample_match_channel else cout
                up = HYV15Upsample(cout, u_out, temporal=(i < n_temporal), dtype=dtype)
                cin = u_out
            else:
                cin = cout
            blocks.append(_Stage(res, "upsamplers", up))
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = RMSNormCh(ch[-1])
        self.conv_out = CausalConv3dRep(ch[-1], cfg.out_channels, dtype=dtype)

    def forward(self, z):
        x = self.conv_in(z) + z.repeat_interleave(self.repeat, dim=1)
        x = self.mid_block(x)
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.norm_out(x)))


@vae_registry.register("hunyuanvideo15", aliases=("AutoencoderKLHunyuanVideo15", "hunyuanvideo15.base"))
class AutoencoderKLHunyuanVideo15(nn.Module):
    config_class = HYV15VAEConfig

    def __init__(self, cfg: HYV15VAEConfig, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder = HYV15Encoder(cfg, dtype=dtype)
        self.decoder = HYV15Decoder(cfg, dtype=dtype)

    def encode(self, video: torch.Tensor, sample: bool = False, noise=None) -> torch.Tensor:
        """[B,3,T,H,W] → scaled latents [B,z,T',H/16,W/16]."""
        mean, logvar = self.encoder(video).chunk(2, dim=1)
        z = mean
        if sample and noise is not None:
            z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
        return z * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B,z,T,h,w] → video [B,3,4(T−1)+1,16h,16w]."""
        return self.decoder(z / self.cfg.scaling_factor)
