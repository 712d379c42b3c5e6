"""LTX-2 audio VAE, port of ``apex_studio_tpu/models/vaes/ltx2_audio_vae.py``.

A 2-D KL autoencoder over stereo mel spectrograms ``[B, 2, T, mel]`` with
time-causal convolutions (all time padding on the past side), pixel-norm
resnets and 2× time / mel resampling per level (``ch_mult`` (1, 2, 4): 4×).
Its latent patchified over the mel bins, ``[B, T', z·mel']`` (8 · 16 = 128
at the published widths), is the DiT's audio stream. The port computes in
NCHW where the JAX module runs NHWC; the decode crops or zero-pads to the
causal target of 4·T' − 3 frames × ``mel_bins``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.registry import vae_registry


@dataclasses.dataclass
class LTX2AudioVAEConfig:
    base_channels: int = 128
    output_channels: int = 2
    in_channels: int = 2
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    latent_channels: int = 8
    mel_bins: int = 64
    sample_rate: int = 16000
    mel_hop_length: int = 160
    double_z: bool = True
    latents_mean: Optional[Tuple[float, ...]] = None
    latents_std: Optional[Tuple[float, ...]] = None

    @property
    def temporal_compression_ratio(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)

    @classmethod
    def from_dict(cls, d: dict) -> "LTX2AudioVAEConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items() if k in known})


def _pixel_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(1, keepdim=True) + eps)


class CausalConv2d(nn.Module):
    """A k×k conv over [B, C, T, M] with the time padding all on the past side."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, *, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=dtype))
        self.k = kernel
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pw = self.k - 1
        x = F.pad(x, (pw // 2, pw - pw // 2, pw, 0))
        return F.conv2d(x.to(self.weight.dtype), self.weight, self.bias, stride=self.stride)


class _AudioResnet(nn.Module):
    def __init__(self, cin: int, cout: int, *, dtype):
        super().__init__()
        self.conv1 = CausalConv2d(cin, cout, dtype=dtype)
        self.conv2 = CausalConv2d(cout, cout, dtype=dtype)
        self.nin_shortcut = CausalConv2d(cin, cout, kernel=1, dtype=dtype) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(_pixel_norm(x)))
        h = self.conv2(F.silu(_pixel_norm(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class _AudioDown(nn.Module):
    """A stride-2 3×3 conv after a past-heavy pad: 2 time rows before, 1 mel bin after."""

    def __init__(self, ch: int, *, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(ch, ch, 3, 3, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(ch, dtype=dtype))

    def forward(self, x):
        return F.conv2d(F.pad(x, (0, 1, 2, 0)).to(self.weight.dtype), self.weight, self.bias, stride=2)


class _AudioUp(nn.Module):
    """2× nearest upsample in time and mel, a causal conv, the first time row dropped."""

    def __init__(self, ch: int, *, dtype):
        super().__init__()
        self.conv = CausalConv2d(ch, ch, dtype=dtype)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self.conv(x)[:, :, 1:]


class LTX2AudioEncoder(nn.Module):
    def __init__(self, cfg: LTX2AudioVAEConfig, *, dtype=torch.float32):
        super().__init__()
        ch = cfg.base_channels
        self.conv_in = CausalConv2d(cfg.in_channels, ch, dtype=dtype)
        stages = []
        block_in = ch
        for level, mult in enumerate(cfg.ch_mult):
            block_out = cfg.base_channels * mult
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(_AudioResnet(block_in, block_out, dtype=dtype))
                block_in = block_out
            down = _AudioDown(block_in, dtype=dtype) if level != len(cfg.ch_mult) - 1 else nn.Identity()
            stages.append(nn.ModuleList([nn.ModuleList(blocks), down]))
        self.down = nn.ModuleList(stages)
        self.mid_1 = _AudioResnet(block_in, block_in, dtype=dtype)
        self.mid_2 = _AudioResnet(block_in, block_in, dtype=dtype)
        self.conv_out = CausalConv2d(block_in, cfg.latent_channels * (2 if cfg.double_z else 1), dtype=dtype)

    def forward(self, x):
        x = self.conv_in(x)
        for blocks, down in self.down:
            for b in blocks:
                x = b(x)
            x = down(x)
        x = self.mid_2(self.mid_1(x))
        return self.conv_out(F.silu(_pixel_norm(x)))


class LTX2AudioDecoder(nn.Module):
    def __init__(self, cfg: LTX2AudioVAEConfig, *, dtype=torch.float32):
        super().__init__()
        block_in = cfg.base_channels * cfg.ch_mult[-1]
        self.conv_in = CausalConv2d(cfg.latent_channels, block_in, dtype=dtype)
        self.mid_1 = _AudioResnet(block_in, block_in, dtype=dtype)
        self.mid_2 = _AudioResnet(block_in, block_in, dtype=dtype)
        # up[level] with level 0 the shallowest, run deepest first (the checkpoint's indexing)
        stages = [None] * len(cfg.ch_mult)
        for level in reversed(range(len(cfg.ch_mult))):
            block_out = cfg.base_channels * cfg.ch_mult[level]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(_AudioResnet(block_in, block_out, dtype=dtype))
                block_in = block_out
            up = _AudioUp(block_in, dtype=dtype) if level != 0 else nn.Identity()
            stages[level] = nn.ModuleList([nn.ModuleList(blocks), up])
        self.up = nn.ModuleList(stages)
        self.conv_out = CausalConv2d(block_in, cfg.output_channels, dtype=dtype)

    def forward(self, z):
        x = self.mid_2(self.mid_1(self.conv_in(z)))
        for level in reversed(range(len(self.up))):
            blocks, up = self.up[level]
            for b in blocks:
                x = b(x)
            x = up(x)
        return self.conv_out(F.silu(_pixel_norm(x)))


@vae_registry.register("ltx2audio", aliases=("AutoencoderKLLTX2Audio", "ltx2_audio"))
class AutoencoderKLLTX2Audio(nn.Module):
    config_class = LTX2AudioVAEConfig

    def __init__(self, cfg: LTX2AudioVAEConfig, *, dtype=torch.float32):
        super().__init__()
        # f32 whatever the component's dtype, as the JAX module's parameters are
        self.cfg = cfg
        self.dtype = torch.float32
        self.encoder = LTX2AudioEncoder(cfg)
        self.decoder = LTX2AudioDecoder(cfg)

    @property
    def temporal_compression_ratio(self) -> int:
        return self.cfg.temporal_compression_ratio

    def _mean_std(self, device):
        if self.cfg.latents_mean is None:
            return None, None
        m = torch.tensor(self.cfg.latents_mean, dtype=torch.float32, device=device).reshape(1, -1, 1, 1)
        s = torch.tensor(self.cfg.latents_std, dtype=torch.float32, device=device).reshape(1, -1, 1, 1)
        return m, s

    def encode(self, mel: torch.Tensor, sample: bool = False, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel [B, C, T, M] → latents [B, z, T/4, M/4]."""
        mean, logvar = self.encoder(mel).chunk(2, dim=1)
        z = mean
        if sample and noise is not None:
            z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
        m, s = self._mean_std(z.device)
        return z if m is None else (z - m) / s

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latents [B, z, T', M'] → mel [B, C, 4T' − 3, mel_bins], cropped or
        zero-padded to that causal target whatever ``ch_mult`` upsamples."""
        m, s = self._mean_std(z.device)
        if m is not None:
            z = z * s + m
        x = self.decoder(z)
        target_t, target_f = max(z.shape[2] * 4 - 3, 1), self.cfg.mel_bins
        x = x[:, : self.cfg.output_channels, :target_t, :target_f]
        pad_t, pad_f = target_t - x.shape[2], target_f - x.shape[3]
        if pad_t > 0 or pad_f > 0:
            x = F.pad(x, (0, max(pad_f, 0), 0, max(pad_t, 0)))
        return x

    @staticmethod
    def patchify(latents: torch.Tensor) -> torch.Tensor:
        """[B, z, T', M'] → [B, T', z·M'], the DiT's audio tokens."""
        b, c, t, m = latents.shape
        return latents.transpose(1, 2).reshape(b, t, c * m)

    @staticmethod
    def unpatchify(tokens: torch.Tensor, channels: int, mel_bins: int) -> torch.Tensor:
        b, t, _ = tokens.shape
        return tokens.reshape(b, t, channels, mel_bins).transpose(1, 2)
