"""LTX-2 vocoder, port of ``apex_studio_tpu/models/ltx2_vocoder.py``.

A HiFi-GAN class mel → waveform net: a Conv1d stem, five ConvTranspose1d
upsamplers (6·5·2·2·2 = 240× to 24 kHz), each followed by three dilated
residual blocks whose outputs are averaged, then a leaky ReLU (slope 0.01)
and a tanh-bounded stereo projection. The transposed convs keep torch's
``ConvTranspose1d`` weight ``[in, out, k]`` under the JAX name ``w`` (the
JAX module stores the kernel flipped as ``[k, in, out]`` and runs it as a
zero-inserted dilated conv; ``loaders/from_jax.py`` unflips it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.registry import helper_registry


@dataclasses.dataclass
class LTX2VocoderConfig:
    in_channels: int = 128
    hidden_channels: int = 1024
    out_channels: int = 2
    upsample_kernel_sizes: Tuple[int, ...] = (16, 15, 8, 4, 4)
    upsample_factors: Tuple[int, ...] = (6, 5, 2, 2, 2)
    resnet_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resnet_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    leaky_relu_negative_slope: float = 0.1
    output_sampling_rate: int = 24000

    @classmethod
    def from_dict(cls, d: dict) -> "LTX2VocoderConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: (tuple(tuple(e) if isinstance(e, list) else e for e in v) if isinstance(v, list) else v)
                      for k, v in d.items() if k in known})


class Conv1d(nn.Module):
    """A 'same'-padded dilated conv over [B, C, L]."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1, *, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=dtype))
        self.dilation = dilation
        self.k = k

    def forward(self, x):
        pad = (self.k - 1) * self.dilation // 2
        return F.conv1d(x, self.weight, self.bias, padding=pad, dilation=self.dilation)


class ConvTranspose1d(nn.Module):
    """torch ``ConvTranspose1d(k, stride, padding=(k − stride) // 2)``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, *, dtype=torch.float32):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cin, cout, k, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=dtype))
        self.stride = stride
        self.k = k

    def forward(self, x):
        return F.conv_transpose1d(x, self.w, self.bias, stride=self.stride, padding=(self.k - self.stride) // 2)


class _VocoderResBlock(nn.Module):
    def __init__(self, ch: int, k: int, dilations: Tuple[int, ...], slope: float, *, dtype):
        super().__init__()
        self.convs1 = nn.ModuleList([Conv1d(ch, ch, k, d, dtype=dtype) for d in dilations])
        self.convs2 = nn.ModuleList([Conv1d(ch, ch, k, 1, dtype=dtype) for _ in dilations])
        self.slope = slope

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, self.slope)), self.slope))
        return x


@helper_registry.register("ltx2.vocoder", aliases=("LTX2Vocoder",))
class LTX2Vocoder(nn.Module):
    config_class = LTX2VocoderConfig

    def __init__(self, cfg: Optional[LTX2VocoderConfig] = None, *, dtype=torch.float32):
        super().__init__()
        cfg = cfg or LTX2VocoderConfig()
        self.cfg = cfg
        dtype = self.dtype = torch.float32  # whatever the component's dtype, as in the JAX module
        self.conv_in = Conv1d(cfg.in_channels, cfg.hidden_channels, 7, dtype=dtype)
        ups, resnets = [], []
        ch = cfg.hidden_channels
        for k, s in zip(cfg.upsample_kernel_sizes, cfg.upsample_factors):
            ups.append(ConvTranspose1d(ch, ch // 2, k, s, dtype=dtype))
            ch //= 2
            for rk, rd in zip(cfg.resnet_kernel_sizes, cfg.resnet_dilations):
                resnets.append(_VocoderResBlock(ch, rk, tuple(rd), cfg.leaky_relu_negative_slope, dtype=dtype))
        self.upsamplers = nn.ModuleList(ups)
        self.resnets = nn.ModuleList(resnets)
        self.conv_out = Conv1d(ch, cfg.out_channels, 7, dtype=dtype)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, C, T, M] → waveform [B, out_channels, T·∏factors]."""
        cfg = self.cfg
        b, c, t, m = mel.shape
        x = self.conv_in(mel.transpose(1, 2).reshape(b, t, c * m).transpose(1, 2).to(self.dtype))
        n_res = len(cfg.resnet_kernel_sizes)
        for i, up in enumerate(self.upsamplers):
            x = up(F.leaky_relu(x, cfg.leaky_relu_negative_slope))
            x = sum(self.resnets[i * n_res + j](x) for j in range(n_res)) / float(n_res)
        return torch.tanh(self.conv_out(F.leaky_relu(x, 0.01)))
