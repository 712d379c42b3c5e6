"""AutoencoderKL (SD/SDXL/Flux image VAE), port of
``apex_studio_tpu/models/vaes/autoencoder_kl.py`` (``encode`` and ``decode``;
``decode_tiled`` and the Flux2 packed-BatchNorm variant come later).

The JAX module runs NHWC with HWIO kernels; this one runs NCHW with OIHW
weights (loaders/from_jax.py transposes on carry). GroupNorm statistics are
taken in f32 and attention in the mid block goes through the plain-math
``xla`` backend, as the JAX module asks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear
from apex_studio_tpu_torch.models.registry import vae_registry
from apex_studio_tpu_torch.ops.attention import attention as attention_op


@dataclasses.dataclass
class AutoencoderKLConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: Optional[float] = 0.1159
    use_quant_conv: bool = False
    use_post_quant_conv: bool = False
    mid_block_add_attention: bool = True

    @classmethod
    def from_dict(cls, cfg: dict) -> "AutoencoderKLConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "block_out_channels" in kw:
            kw["block_out_channels"] = tuple(kw["block_out_channels"])
        if cfg.get("packed_batch_norm"):
            raise NotImplementedError("the Flux2 packed-BatchNorm VAE is not ported yet")
        return cls(**kw)

    @property
    def spatial_scale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


def group_norm(x: torch.Tensor, weight, bias, groups: int, eps: float = 1e-6) -> torch.Tensor:
    """NCHW group norm with f32 statistics (population variance)."""
    b, c, h, w = x.shape
    x32 = x.float().reshape(b, groups, c // groups, h, w)
    mean = x32.mean(dim=(2, 3, 4), keepdim=True)
    var = (x32 - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    x32 = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    return (x32 * weight.float()[:, None, None] + bias.float()[:, None, None]).to(x.dtype)


class GroupNorm(nn.Module):
    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32))
        self.groups = groups
        self.eps = eps

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.groups, self.eps)


class Conv2d(nn.Module):
    """Square conv on NCHW; weight OIHW stored in f32, computed in ``dtype``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, *, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=torch.float32))
        self.stride = stride
        self.padding = padding
        self.dtype = dtype

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype),
                        stride=self.stride, padding=self.padding)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, *, dtype):
        super().__init__()
        self.norm1 = GroupNorm(cin, groups)
        self.conv1 = Conv2d(cin, cout, dtype=dtype)
        self.norm2 = GroupNorm(cout, groups)
        self.conv2 = Conv2d(cout, cout, dtype=dtype)
        self.conv_shortcut = Conv2d(cin, cout, kernel=1, padding=0, dtype=dtype) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return skip + h


class AttentionBlock2D(nn.Module):
    """Single-head spatial self-attention used in the VAE mid block."""

    def __init__(self, channels: int, groups: int, *, dtype):
        super().__init__()
        self.group_norm = GroupNorm(channels, groups)
        kw = dict(dtype=dtype, param_dtype=torch.float32)
        self.to_q = Linear(channels, channels, **kw)
        self.to_k = Linear(channels, channels, **kw)
        self.to_v = Linear(channels, channels, **kw)
        self.to_out = Linear(channels, channels, **kw)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)  # [B, HW, C]
        q = self.to_q(y)[:, :, None, :]  # single head
        k = self.to_k(y)[:, :, None, :]
        v = self.to_v(y)[:, :, None, :]
        out = self.to_out(attention_op(q, k, v, backend="xla")[:, :, 0, :])
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class Downsample2D(nn.Module):
    def __init__(self, channels: int, *, dtype):
        super().__init__()
        self.conv = Conv2d(channels, channels, stride=2, padding=0, dtype=dtype)

    def forward(self, x):
        # diffusers pads (0,1,0,1) asymmetrically before the stride-2 conv
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    def __init__(self, channels: int, *, dtype):
        super().__init__()
        self.conv = Conv2d(channels, channels, dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class DownEncoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, groups: int, add_downsample: bool, *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if i == 0 else cout, cout, groups, dtype=dtype) for i in range(layers)])
        self.downsamplers = nn.ModuleList([Downsample2D(cout, dtype=dtype)]) if add_downsample else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers:
            x = self.downsamplers[0](x)
        return x


class UpDecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, groups: int, add_upsample: bool, *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if i == 0 else cout, cout, groups, dtype=dtype) for i in range(layers)])
        self.upsamplers = nn.ModuleList([Upsample2D(cout, dtype=dtype)]) if add_upsample else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers:
            x = self.upsamplers[0](x)
        return x


class MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int, add_attention: bool, *, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels, groups, dtype=dtype)
                                      for _ in range(2)])
        self.attentions = (nn.ModuleList([AttentionBlock2D(channels, groups, dtype=dtype)])
                           if add_attention else None)

    def forward(self, x):
        x = self.resnets[0](x)
        if self.attentions:
            x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig, *, dtype):
        super().__init__()
        ch = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.in_channels, ch[0], dtype=dtype)
        blocks, cin = [], ch[0]
        for i, cout in enumerate(ch):
            blocks.append(DownEncoderBlock(cin, cout, cfg.layers_per_block, g,
                                           add_downsample=i < len(ch) - 1, dtype=dtype))
            cin = cout
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(ch[-1], g, cfg.mid_block_add_attention, dtype=dtype)
        self.conv_norm_out = GroupNorm(ch[-1], g)
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, dtype=dtype)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig, *, dtype):
        super().__init__()
        ch = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.latent_channels, ch[-1], dtype=dtype)
        self.mid_block = MidBlock(ch[-1], g, cfg.mid_block_add_attention, dtype=dtype)
        rev = list(reversed(ch))
        blocks, cin = [], rev[0]
        for i, cout in enumerate(rev):
            blocks.append(UpDecoderBlock(cin, cout, cfg.layers_per_block + 1, g,
                                         add_upsample=i < len(ch) - 1, dtype=dtype))
            cin = cout
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(ch[0], g)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, dtype=dtype)

    def forward(self, z):
        x = self.conv_in(z)
        x = self.mid_block(x)
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


@vae_registry.register("auto", aliases=("AutoencoderKL",))
class AutoencoderKL(nn.Module):
    config_class = AutoencoderKLConfig

    def __init__(self, cfg: AutoencoderKLConfig, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, dtype=dtype)
        self.decoder = Decoder(cfg, dtype=dtype)
        c2 = 2 * cfg.latent_channels
        self.quant_conv = (Conv2d(c2, c2, kernel=1, padding=0, dtype=dtype)
                           if cfg.use_quant_conv else None)
        self.post_quant_conv = (
            Conv2d(cfg.latent_channels, cfg.latent_channels, kernel=1, padding=0, dtype=dtype)
            if cfg.use_post_quant_conv else None)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """[B,3,H,W] → [B, 2·latent, H/8, W/8] (mean ‖ logvar), unscaled."""
        moments = self.encoder(x)
        if self.quant_conv is not None:
            moments = self.quant_conv(moments)
        return moments

    def encode(self, x: torch.Tensor, sample: bool = False,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Posterior mean (or a sample), scaled to model latent space."""
        mean, logvar = self.encode_moments(x).chunk(2, dim=1)
        z = mean
        if sample:
            std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
            z = mean + std * (noise if noise is not None else 0.0)
        if self.cfg.shift_factor is not None:
            z = z - self.cfg.shift_factor
        return z * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Model latents [B, C, h, w] → [B, 3, H, W] in [-1, 1]."""
        z = z / self.cfg.scaling_factor
        if self.cfg.shift_factor is not None:
            z = z + self.cfg.shift_factor
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        return self.decoder(z)
