"""LTX-Video causal VAE, port of ``apex_studio_tpu/models/vaes/ltx_vae.py``.

- 4×4 pixel patchify (space to depth, channel order c, r, q) before
  ``conv_in``
- causal 3D convs REPLICATE the first frame k − 1 times at the front; the
  non-causal decoder repeats the first and the last frame (k − 1)/2 times;
  space pads with zeros (or reflection)
- encoder: ``res_x`` (resnets), ``compress_*_res`` (SpaceToDepthDownsample:
  a conv then space to depth, beside a channel-group mean of the space to
  depth input), plain strided ``compress_*`` convs
- decoder: ``res_x`` with the PixArt timestep tables (a 4·C embedding and
  each resnet's [4, C] table) and spatial noise injection, ``compress_*`` →
  DepthToSpaceUpsample (conv, pixel shuffle, the duplicated first frame
  dropped, the repeated input as a residual); then norm, the [2, C] table
  from the decode timestep, silu, ``conv_out`` and unpatchify
- the injected noise is JAX's random stream (``utils/jax_random``): each
  up block folds its index into the decode key, each resnet its own, and
  the second noise of a resnet folds in 1 more
- latents are (de)normalised per channel (``std_of_means`` / ``mean_of_means``)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import TimestepEmbedder
from apex_studio_tpu_torch.models.registry import vae_registry
from apex_studio_tpu_torch.utils import jax_random


def _patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, C, T, H, W] → [B, C·p·p, T, H/p, W/p] (channel order c, r, q)."""
    if p == 1:
        return x
    b, c, t, h, w = x.shape
    x = x.reshape(b, c, t, h // p, p, w // p, p)
    return x.permute(0, 1, 6, 4, 2, 3, 5).reshape(b, c * p * p, t, h // p, w // p)


def _unpatchify(x: torch.Tensor, p: int) -> torch.Tensor:
    if p == 1:
        return x
    b, cp, t, h, w = x.shape
    x = x.reshape(b, cp // (p * p), p, p, t, h, w)  # b c r q t h w
    return x.permute(0, 1, 4, 5, 3, 6, 2).reshape(b, cp // (p * p), t, h * p, w * p)


def _pixel_shuffle_3d(x: torch.Tensor, s: Tuple[int, int, int]) -> torch.Tensor:
    """[B, C·p1·p2·p3, T, H, W] → [B, C, T·p1, H·p2, W·p3]."""
    b, cp, t, h, w = x.shape
    p1, p2, p3 = s
    c = cp // (p1 * p2 * p3)
    x = x.reshape(b, c, p1, p2, p3, t, h, w)
    return x.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(b, c, t * p1, h * p2, w * p3)


def _space_to_depth(x: torch.Tensor, s: Tuple[int, int, int]) -> torch.Tensor:
    """The inverse of ``_pixel_shuffle_3d``."""
    b, c, t, h, w = x.shape
    p1, p2, p3 = s
    x = x.reshape(b, c, t // p1, p1, h // p2, p2, w // p3, p3)
    return x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, c * p1 * p2 * p3, t // p1, h // p2, w // p3)


class CausalConv3d(nn.Module):
    """A 3D conv whose time axis pads with the first (and, non-causal, the
    last) frame repeated."""

    def __init__(self, in_ch: int, out_ch: int, *, kernel_size: int = 3, stride: Tuple[int, int, int] = (1, 1, 1),
                 spatial_padding_mode: str = "zeros", dtype=torch.float32):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k, k, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_ch, dtype=dtype))
        self.k = k
        self.stride = tuple(stride)
        self.pad_mode = "reflect" if spatial_padding_mode == "reflect" else "constant"

    def forward(self, x: torch.Tensor, causal: bool = True) -> torch.Tensor:
        k = self.k
        if k > 1:
            if causal:
                x = torch.cat([x[:, :, :1].expand(-1, -1, k - 1, -1, -1), x], dim=2)
            else:
                half = (k - 1) // 2
                x = torch.cat([x[:, :, :1].expand(-1, -1, half, -1, -1), x,
                               x[:, :, -1:].expand(-1, -1, half, -1, -1)], dim=2)
            sp = k // 2
            x = F.pad(x, (sp, sp, sp, sp, 0, 0), mode=self.pad_mode)
        return F.conv3d(x.to(self.weight.dtype), self.weight, self.bias, stride=self.stride)


class LinearND(nn.Module):
    """A 1×1×1 conv: a Linear over the channels."""

    def __init__(self, in_ch: int, out_ch: int, *, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_ch, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.einsum("bcthw,oc->bothw", x.to(self.weight.dtype), self.weight)
        return y + self.bias[None, :, None, None, None]


class ChannelNorm(nn.Module):
    """pixel_norm (no parameters), layer_norm over C or group_norm (32 groups)."""

    def __init__(self, kind: str, ch: int, *, eps: float = 1e-6):
        super().__init__()
        self.kind = kind
        self.eps = eps
        if kind in ("layer_norm", "group_norm"):
            self.weight = nn.Parameter(torch.ones(ch, dtype=torch.float32))
            self.bias = nn.Parameter(torch.zeros(ch, dtype=torch.float32))
            self.groups = 32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "pixel_norm":
            return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + 1e-8)
        f32 = x.float()
        if self.kind == "layer_norm":
            var, m = torch.var_mean(f32, dim=1, unbiased=False, keepdim=True)
            out = (f32 - m) * torch.rsqrt(var + self.eps)
        else:
            b, c, t, h, w = x.shape
            grp = f32.reshape(b, self.groups, c // self.groups, t, h, w)
            var, m = torch.var_mean(grp, dim=(2, 3, 4, 5), unbiased=False, keepdim=True)
            out = ((grp - m) * torch.rsqrt(var + self.eps)).reshape(b, c, t, h, w)
        out = out * self.weight[None, :, None, None, None] + self.bias[None, :, None, None, None]
        return out.to(x.dtype)


class ResnetBlock3D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, *, norm: str, timestep_conditioning: bool = False,
                 inject_noise: bool = False, spatial_padding_mode: str = "zeros", dtype=torch.float32):
        super().__init__()
        self.norm1 = ChannelNorm(norm, in_ch)
        self.conv1 = CausalConv3d(in_ch, out_ch, spatial_padding_mode=spatial_padding_mode, dtype=dtype)
        self.norm2 = ChannelNorm(norm, out_ch)
        self.conv2 = CausalConv3d(out_ch, out_ch, spatial_padding_mode=spatial_padding_mode, dtype=dtype)
        self.conv_shortcut = LinearND(in_ch, out_ch, dtype=dtype) if in_ch != out_ch else None
        self.norm3 = ChannelNorm("layer_norm", in_ch) if in_ch != out_ch else None
        self.timestep_conditioning = timestep_conditioning
        if timestep_conditioning:
            self.scale_shift_table = nn.Parameter(torch.empty(4, in_ch, dtype=torch.float32))
        self.inject_noise = inject_noise
        if inject_noise:
            self.per_channel_scale1 = nn.Parameter(torch.zeros(out_ch, 1, 1, dtype=torch.float32))
            self.per_channel_scale2 = nn.Parameter(torch.zeros(out_ch, 1, 1, dtype=torch.float32))

    @staticmethod
    def _noise(h: torch.Tensor, scale: torch.Tensor, key: np.ndarray) -> torch.Tensor:
        spatial = jax_random.normal(key, h.shape[-2:], device=h.device).to(h.dtype)
        return h + (spatial[None] * scale.to(h.dtype))[None, :, None]

    def forward(self, x, causal=True, temb=None, noise_key=None):
        h = self.norm1(x)
        if self.timestep_conditioning and temb is not None:
            # temb [B, 4, C], broadcast over T / H / W
            ada = self.scale_shift_table[None] + temb.float()
            s1h, s1c, s2h, s2c = (ada[:, i][..., None, None, None].to(x.dtype) for i in range(4))
            h = h * (1 + s1c) + s1h
        h = self.conv1(F.silu(h), causal=causal)
        if self.inject_noise and noise_key is not None:
            h = self._noise(h, self.per_channel_scale1, noise_key)
        h = self.norm2(h)
        if self.timestep_conditioning and temb is not None:
            h = h * (1 + s2c) + s2h
        h = self.conv2(F.silu(h), causal=causal)
        if self.inject_noise and noise_key is not None:
            h = self._noise(h, self.per_channel_scale2, jax_random.fold_in(noise_key, 1))
        res = x
        if self.norm3 is not None:
            res = self.norm3(res)
        if self.conv_shortcut is not None:
            res = self.conv_shortcut(res)
        return res + h


class SpaceToDepthDownsample(nn.Module):
    """A conv, then space to depth, beside the channel-group mean of the
    space-to-depth input."""

    def __init__(self, in_ch: int, out_ch: int, stride: Tuple[int, int, int], *, spatial_padding_mode: str = "zeros",
                 dtype=torch.float32):
        super().__init__()
        self.stride = tuple(stride)
        self.group_size = in_ch * int(np.prod(stride)) // out_ch
        self.conv = CausalConv3d(in_ch, out_ch // int(np.prod(stride)), spatial_padding_mode=spatial_padding_mode,
                                 dtype=dtype)

    def forward(self, x, causal=True):
        if self.stride[0] == 2:
            x = torch.cat([x[:, :, :1], x], dim=2)
        skip = _space_to_depth(x, self.stride)
        b, cg, t, h, w = skip.shape
        skip = skip.reshape(b, cg // self.group_size, self.group_size, t, h, w).mean(2)
        return _space_to_depth(self.conv(x, causal=causal), self.stride) + skip


class DepthToSpaceUpsample(nn.Module):
    def __init__(self, in_ch: int, stride: Tuple[int, int, int], *, residual: bool = False,
                 out_channels_reduction_factor: int = 1, spatial_padding_mode: str = "zeros", dtype=torch.float32):
        super().__init__()
        self.stride = tuple(stride)
        self.residual = residual
        self.factor = out_channels_reduction_factor
        self.conv = CausalConv3d(in_ch, int(np.prod(stride)) * in_ch // out_channels_reduction_factor,
                                 spatial_padding_mode=spatial_padding_mode, dtype=dtype)

    def forward(self, x, causal=True):
        if self.residual:
            skip = _pixel_shuffle_3d(x, self.stride).repeat(1, int(np.prod(self.stride)) // self.factor, 1, 1, 1)
            if self.stride[0] == 2:
                skip = skip[:, :, 1:]
        y = _pixel_shuffle_3d(self.conv(x, causal=causal), self.stride)
        if self.stride[0] == 2:
            y = y[:, :, 1:]
        return y + skip if self.residual else y


class UNetMidBlock3D(nn.Module):
    def __init__(self, ch: int, num_layers: int, *, norm: str, timestep_conditioning: bool = False,
                 inject_noise: bool = False, spatial_padding_mode: str = "zeros", dtype=torch.float32):
        super().__init__()
        self.timestep_conditioning = timestep_conditioning
        if timestep_conditioning:
            self.time_embedder = TimestepEmbedder(ch * 4, ch * 4, dtype=torch.float32)
        self.res_blocks = nn.ModuleList([
            ResnetBlock3D(ch, ch, norm=norm, timestep_conditioning=timestep_conditioning, inject_noise=inject_noise,
                          spatial_padding_mode=spatial_padding_mode, dtype=dtype)
            for _ in range(num_layers)])
        self.ch = ch

    def forward(self, x, causal=True, scaled_t=None, noise_key=None):
        temb = None
        if self.timestep_conditioning and scaled_t is not None:
            temb = self.time_embedder(scaled_t.reshape(-1)).reshape(x.shape[0], 4, self.ch)
        for i, rb in enumerate(self.res_blocks):
            nk = None if noise_key is None else jax_random.fold_in(noise_key, i)
            x = rb(x, causal=causal, temb=temb, noise_key=nk)
        return x


@dataclass
class LTXVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 128
    base_channels: int = 128
    decoder_base_channels: Optional[int] = None
    patch_size: int = 4
    norm_layer: str = "pixel_norm"
    encoder_blocks: List[Tuple[str, Dict[str, Any]]] = field(default_factory=lambda: [
        ("res_x", {"num_layers": 4}),
        ("compress_all_res", {"multiplier": 2}),
        ("res_x", {"num_layers": 6}),
        ("compress_all_res", {"multiplier": 2}),
        ("res_x", {"num_layers": 6}),
        ("compress_all_res", {"multiplier": 2}),
        ("res_x", {"num_layers": 2}),
        ("res_x", {"num_layers": 2}),
    ])
    decoder_blocks: List[Tuple[str, Dict[str, Any]]] = field(default_factory=lambda: [
        ("res_x", {"num_layers": 5, "inject_noise": True}),
        ("compress_all", {"residual": True, "multiplier": 2}),
        ("res_x", {"num_layers": 6, "inject_noise": True}),
        ("compress_all", {"residual": True, "multiplier": 2}),
        ("res_x", {"num_layers": 7, "inject_noise": True}),
        ("compress_all", {"residual": True, "multiplier": 2}),
        ("res_x", {"num_layers": 8, "inject_noise": False}),
    ])
    latent_log_var: str = "uniform"
    causal_decoder: bool = False
    timestep_conditioning: bool = True
    spatial_padding_mode: str = "zeros"
    scaling_factor: float = 1.0
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def spatial_scale(self) -> int:
        s = self.patch_size
        for name, _ in self.encoder_blocks:
            if name in ("compress_space", "compress_all", "compress_all_x_y", "compress_all_res",
                        "compress_space_res"):
                s *= 2
        return s

    @property
    def temporal_scale(self) -> int:
        s = 1
        for name, _ in self.encoder_blocks:
            if name in ("compress_time", "compress_all", "compress_all_x_y", "compress_all_res",
                        "compress_time_res"):
                s *= 2
        return s

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LTXVAEConfig":
        def norm_blocks(blocks):
            return [(name, {"num_layers": p} if isinstance(p, int) else dict(p)) for name, p in blocks]

        kw: Dict[str, Any] = {}
        for k in ("in_channels", "out_channels", "latent_channels", "patch_size", "norm_layer", "latent_log_var",
                  "causal_decoder", "timestep_conditioning", "spatial_padding_mode", "scaling_factor"):
            if k in d:
                kw[k] = d[k]
        if "encoder_base_channels" in d or "base_channels" in d:
            kw["base_channels"] = d.get("encoder_base_channels", d.get("base_channels"))
        if "decoder_base_channels" in d:
            kw["decoder_base_channels"] = d["decoder_base_channels"]
        eb = d.get("encoder_blocks") or d.get("blocks")
        db = d.get("decoder_blocks") or d.get("blocks")
        if eb:
            kw["encoder_blocks"] = norm_blocks(eb)
        if db:
            kw["decoder_blocks"] = norm_blocks(db)
        known = set(kw) | {"encoder_base_channels", "blocks", "encoder_blocks", "decoder_blocks"}
        return cls(**kw, extra={k: v for k, v in d.items() if k not in known})


_ENCODER_STRIDES = {"compress_time": (2, 1, 1), "compress_space": (1, 2, 2), "compress_all": (2, 2, 2),
                    "compress_all_res": (2, 2, 2), "compress_space_res": (1, 2, 2), "compress_time_res": (2, 1, 1),
                    "compress_all_x_y": (2, 2, 2)}


class LTXEncoder(nn.Module):
    def __init__(self, cfg: LTXVAEConfig, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        p, sp, ch = cfg.patch_size, cfg.spatial_padding_mode, cfg.base_channels
        self.conv_in = CausalConv3d(cfg.in_channels * p * p, ch, spatial_padding_mode=sp, dtype=dtype)
        blocks = []
        for name, params in cfg.encoder_blocks:
            if name == "res_x":
                blocks.append(UNetMidBlock3D(ch, params["num_layers"], norm=cfg.norm_layer,
                                             spatial_padding_mode=sp, dtype=dtype))
            elif name == "res_x_y":
                out = params.get("multiplier", 2) * ch
                blocks.append(ResnetBlock3D(ch, out, norm=cfg.norm_layer, spatial_padding_mode=sp, dtype=dtype))
                ch = out
            elif name in ("compress_time", "compress_space", "compress_all"):
                blocks.append(CausalConv3d(ch, ch, stride=_ENCODER_STRIDES[name], spatial_padding_mode=sp,
                                           dtype=dtype))
            elif name in ("compress_all_res", "compress_space_res", "compress_time_res", "compress_all_x_y"):
                out = params.get("multiplier", 2) * ch
                if name == "compress_all_x_y":
                    blocks.append(CausalConv3d(ch, out, stride=_ENCODER_STRIDES[name], spatial_padding_mode=sp,
                                               dtype=dtype))
                else:
                    blocks.append(SpaceToDepthDownsample(ch, out, _ENCODER_STRIDES[name], spatial_padding_mode=sp,
                                                         dtype=dtype))
                ch = out
            else:
                raise ValueError(f"unknown encoder block {name}")
        self.down_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = ChannelNorm(cfg.norm_layer, ch)
        out_ch = (cfg.latent_channels * 2 if cfg.latent_log_var == "per_channel"
                  else cfg.latent_channels + (1 if cfg.latent_log_var in ("uniform", "constant") else 0))
        self.conv_out = CausalConv3d(ch, out_ch, spatial_padding_mode=sp, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(_patchify(x, self.cfg.patch_size), causal=True)
        for blk in self.down_blocks:
            x = blk(x, causal=True)
        return self.conv_out(F.silu(self.conv_norm_out(x)), causal=True)


class LTXDecoder(nn.Module):
    def __init__(self, cfg: LTXVAEConfig, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        sp = cfg.spatial_padding_mode
        ch = cfg.decoder_base_channels or cfg.base_channels
        for name, params in reversed(cfg.decoder_blocks):
            if name == "res_x_y":
                ch *= params.get("multiplier", 2)
            if name.startswith("compress"):
                ch *= params.get("multiplier", 1)
        self.conv_in = CausalConv3d(cfg.latent_channels, ch, spatial_padding_mode=sp, dtype=dtype)
        blocks = []
        for name, params in reversed(cfg.decoder_blocks):
            if name == "res_x":
                blocks.append(UNetMidBlock3D(ch, params["num_layers"], norm=cfg.norm_layer,
                                             timestep_conditioning=cfg.timestep_conditioning,
                                             inject_noise=params.get("inject_noise", False),
                                             spatial_padding_mode=sp, dtype=dtype))
            elif name == "res_x_y":
                out = ch // params.get("multiplier", 2)
                blocks.append(ResnetBlock3D(ch, out, norm=cfg.norm_layer,
                                            inject_noise=params.get("inject_noise", False),
                                            spatial_padding_mode=sp, dtype=dtype))
                ch = out
            elif name in ("compress_time", "compress_space", "compress_all"):
                mult = params.get("multiplier", 1)
                out = ch // mult if name == "compress_all" else ch
                blocks.append(DepthToSpaceUpsample(
                    ch, _ENCODER_STRIDES[name], residual=params.get("residual", False),
                    out_channels_reduction_factor=mult if name == "compress_all" else 1,
                    spatial_padding_mode=sp, dtype=dtype))
                ch = out
            else:
                raise ValueError(f"unknown decoder block {name}")
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = ChannelNorm(cfg.norm_layer, ch)
        self.conv_out = CausalConv3d(ch, cfg.out_channels * cfg.patch_size**2, spatial_padding_mode=sp, dtype=dtype)
        self.timestep_conditioning = cfg.timestep_conditioning
        if cfg.timestep_conditioning:
            self.timestep_scale_multiplier = nn.Parameter(torch.tensor(1000.0, dtype=torch.float32))
            self.last_time_embedder = TimestepEmbedder(ch * 2, ch * 2, dtype=torch.float32)
            self.last_scale_shift_table = nn.Parameter(torch.empty(2, ch, dtype=torch.float32))

    def forward(self, z: torch.Tensor, timestep: Optional[torch.Tensor] = None,
                noise_key: Optional[np.ndarray] = None) -> torch.Tensor:
        causal = self.cfg.causal_decoder
        x = self.conv_in(z, causal=causal)
        scaled_t = None
        if self.timestep_conditioning:
            t = timestep if timestep is not None else torch.zeros(z.shape[0], device=z.device)
            scaled_t = t.float() * self.timestep_scale_multiplier
        for i, blk in enumerate(self.up_blocks):
            if isinstance(blk, UNetMidBlock3D):
                nk = None if noise_key is None else jax_random.fold_in(noise_key, i)
                x = blk(x, causal=causal, scaled_t=scaled_t, noise_key=nk)
            else:
                x = blk(x, causal=causal)
        x = self.conv_norm_out(x)
        if self.timestep_conditioning:
            emb = self.last_time_embedder(scaled_t.reshape(-1))  # [B, 2C]
            vals = self.last_scale_shift_table[None] + emb.reshape(x.shape[0], 2, -1).float()
            shift = vals[:, 0][..., None, None, None].to(x.dtype)
            scale = vals[:, 1][..., None, None, None].to(x.dtype)
            x = x * (1 + scale) + shift
        return _unpatchify(self.conv_out(F.silu(x), causal=causal), self.cfg.patch_size)


@vae_registry.register("ltx_vae.base", aliases=("ltx_vae", "CausalVideoAutoencoder", "AutoencoderKLLTXVideo"))
class AutoencoderKLLTX(nn.Module):
    """The LTX causal video autoencoder with per-channel latent statistics."""

    config_class = LTXVAEConfig

    def __init__(self, cfg: LTXVAEConfig, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.encoder = LTXEncoder(cfg, dtype=dtype)
        self.decoder = LTXDecoder(cfg, dtype=dtype)
        self.std_of_means = nn.Parameter(torch.ones(cfg.latent_channels, dtype=torch.float32))
        self.mean_of_means = nn.Parameter(torch.zeros(cfg.latent_channels, dtype=torch.float32))

    def normalize_latents(self, z: torch.Tensor) -> torch.Tensor:
        mean = self.mean_of_means[None, :, None, None, None]
        std = self.std_of_means[None, :, None, None, None]
        return (z - mean) * self.cfg.scaling_factor / std

    def denormalize_latents(self, z: torch.Tensor) -> torch.Tensor:
        mean = self.mean_of_means[None, :, None, None, None]
        std = self.std_of_means[None, :, None, None, None]
        return z * std / self.cfg.scaling_factor + mean

    def encode(self, x: torch.Tensor, sample_mode: str = "mode") -> torch.Tensor:
        """[B, 3, T, H, W] in [−1, 1] → normalised latents [B, C, T', H', W']."""
        return self.normalize_latents(self.encoder(x)[:, :self.cfg.latent_channels])

    def decode(self, z: torch.Tensor, timestep: Optional[torch.Tensor] = None,
               noise_key: Optional[np.ndarray] = None) -> torch.Tensor:
        """``noise_key``: the decode's JAX key (``utils/jax_random.key``); None
        injects no noise."""
        return self.decoder(self.denormalize_latents(z), timestep=timestep, noise_key=noise_key)
