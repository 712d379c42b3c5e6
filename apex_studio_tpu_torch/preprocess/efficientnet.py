"""EfficientNet-B5 feature backbone of the surface-normal preprocessors (port
of ``apex_studio_tpu/preprocess/efficientnet.py``): timm's
``tf_efficientnet_b5_ap``, traced as the reference's NormalBAE and DSINE
encoders trace it, NHWC at every function as in the JAX module and with its
attribute names (``loaders/from_jax.py`` carries its parameters).

- The ``tf_`` variants pad as TensorFlow's "SAME" does, which is flax's
  ``padding="SAME"``: the total ``(⌈n/s⌉ - 1)·s + k - n`` split with the
  smaller half first, so a stride-2 conv on an even size pads one row and
  column at the bottom and right only (``SameConv``).
- BatchNorm runs as the inference affine of its running statistics, eps
  1e-3 (``BNInf``).
- Stage widths and depths follow the compound scaling of B5 (width 1.6,
  depth 2.2); squeeze-excitation reduces to a quarter of each block's input
  channels.

``convert_timm_efficientnet`` maps timm's state dict onto the module.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.preprocess.depth_anything import _lecun, conv2d_nhwc

# (expand_ratio, kernel, stride, base_channels, base_repeats) — EfficientNet-B0
_B0_STAGES = [
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
]


def _round_filters(ch: float, mult: float, divisor: int = 8) -> int:
    ch *= mult
    new = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if new < 0.9 * ch:
        new += divisor
    return int(new)


def _round_repeats(r: int, mult: float) -> int:
    return int(np.ceil(mult * r))


@dataclasses.dataclass(frozen=True)
class EffNetConfig:
    width_mult: float = 1.6   # B5
    depth_mult: float = 2.2   # B5
    stem_ch: int = 48
    head_ch: int = 2048
    bn_eps: float = 1e-3
    se_ratio: float = 0.25

    @property
    def stages(self) -> List[Tuple[int, int, int, int, int]]:
        """(expand, kernel, stride, out_ch, repeats) per stage after scaling."""
        return [(exp, k, s, _round_filters(c, self.width_mult), _round_repeats(r, self.depth_mult))
                for exp, k, s, c, r in _B0_STAGES]

    @classmethod
    def b5(cls) -> "EffNetConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "EffNetConfig":
        """Small config for tests (same topology, 7 stages x 1 block)."""
        return cls(width_mult=0.125, depth_mult=0.05, stem_ch=8, head_ch=32)


def same_padding(n: int, k: int, stride: int) -> Tuple[int, int]:
    """TensorFlow's / flax's "SAME" padding of one axis of size ``n``."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class SameConv(nn.Module):
    """``nnx.Conv(padding="SAME")``: NHWC, ``weight`` OIHW (grouped
    ``[O, I / groups, k, k]``), optional bias."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
                 use_bias: bool = False):
        super().__init__()
        self.weight = _lecun(cout, cin // groups, k, k, fan_in=cin // groups * k * k)
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None
        self.k, self.stride, self.groups = k, stride, groups

    def forward(self, x):
        pads = tuple(same_padding(n, self.k, self.stride) for n in x.shape[1:3])
        return conv2d_nhwc(x, self.weight, self.bias, self.stride, pads, groups=self.groups)


class BNInf(nn.Module):
    """Inference-mode BatchNorm: fixed running statistics from the checkpoint."""

    def __init__(self, ch: int, eps: float):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.mean = nn.Parameter(torch.zeros(ch))
        self.var = nn.Parameter(torch.ones(ch))
        self.eps = eps

    def forward(self, x):
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        return x * inv + (self.bias - self.mean * inv)


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, rd_ch: int):
        super().__init__()
        self.conv_reduce = SameConv(ch, rd_ch, 1, use_bias=True)
        self.conv_expand = SameConv(rd_ch, ch, 1, use_bias=True)

    def forward(self, x):
        s = x.mean(dim=(1, 2), keepdim=True)
        s = F.silu(self.conv_reduce(s))
        return x * torch.sigmoid(self.conv_expand(s))


class DSConvBlock(nn.Module):
    """Stage-0 depthwise-separable block (timm DepthwiseSeparableConv):
    conv_dw → bn1 → silu → SE → conv_pw → bn2 (+residual)."""

    def __init__(self, in_ch, out_ch, k, stride, cfg: EffNetConfig):
        super().__init__()
        self.conv_dw = SameConv(in_ch, in_ch, k, stride, groups=in_ch)
        self.bn1 = BNInf(in_ch, cfg.bn_eps)
        self.se = SqueezeExcite(in_ch, max(1, int(in_ch * cfg.se_ratio)))
        self.conv_pw = SameConv(in_ch, out_ch, 1)
        self.bn2 = BNInf(out_ch, cfg.bn_eps)
        self.has_skip = stride == 1 and in_ch == out_ch

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_dw(x)))
        y = self.se(y)
        y = self.bn2(self.conv_pw(y))
        return x + y if self.has_skip else y


class MBConvBlock(nn.Module):
    """InvertedResidual: conv_pw (expand) → bn1 → silu → conv_dw → bn2 → silu
    → SE → conv_pwl (project) → bn3 (+residual)."""

    def __init__(self, in_ch, out_ch, exp, k, stride, cfg: EffNetConfig):
        super().__init__()
        mid = in_ch * exp
        self.conv_pw = SameConv(in_ch, mid, 1)
        self.bn1 = BNInf(mid, cfg.bn_eps)
        self.conv_dw = SameConv(mid, mid, k, stride, groups=mid)
        self.bn2 = BNInf(mid, cfg.bn_eps)
        self.se = SqueezeExcite(mid, max(1, int(in_ch * cfg.se_ratio)))
        self.conv_pwl = SameConv(mid, out_ch, 1)
        self.bn3 = BNInf(out_ch, cfg.bn_eps)
        self.has_skip = stride == 1 and in_ch == out_ch

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_pw(x)))
        y = F.silu(self.bn2(self.conv_dw(y)))
        y = self.se(y)
        y = self.bn3(self.conv_pwl(y))
        return x + y if self.has_skip else y


class EfficientNetFeatures(nn.Module):
    """Backbone producing the timm module-trace feature list (NHWC): index 0
    = input, 1 = conv_stem, 2 = bn1(+act), 3..9 = stage outputs, 10 =
    conv_head, 11 = bn2(+act) — the NormalBAE decoder taps 3, 4, 5, 7 and
    10, DSINE's 5, 7 and 10."""

    def __init__(self, cfg: Optional[EffNetConfig] = None):
        super().__init__()
        cfg = cfg or EffNetConfig.b5()
        self.cfg = cfg
        self.conv_stem = SameConv(3, cfg.stem_ch, 3, 2)
        self.bn1 = BNInf(cfg.stem_ch, cfg.bn_eps)
        stages = []
        in_ch = cfg.stem_ch
        for exp, k, s, out_ch, reps in cfg.stages:
            blocks = []
            for bi in range(reps):
                stride = s if bi == 0 else 1
                blocks.append(DSConvBlock(in_ch, out_ch, k, stride, cfg) if exp == 1
                              else MBConvBlock(in_ch, out_ch, exp, k, stride, cfg))
                in_ch = out_ch
            stages.append(nn.ModuleList(blocks))
        self.blocks = nn.ModuleList(stages)
        self.conv_head = SameConv(in_ch, cfg.head_ch, 1)
        self.bn2 = BNInf(cfg.head_ch, cfg.bn_eps)

    def forward(self, x) -> List[torch.Tensor]:
        feats = [x]
        x = self.conv_stem(x)
        feats.append(x)
        x = F.silu(self.bn1(x))
        feats.append(x)
        for stage in self.blocks:
            for block in stage:
                x = block(x)
            feats.append(x)
        x = self.conv_head(x)
        feats.append(x)
        x = F.silu(self.bn2(x))
        feats.append(x)
        return feats

    def feature_channels(self) -> Dict[int, int]:
        chs = {0: 3, 1: self.cfg.stem_ch, 2: self.cfg.stem_ch}
        for i, (_, _, _, c, _) in enumerate(self.cfg.stages):
            chs[3 + i] = c
        chs[10] = self.cfg.head_ch
        chs[11] = self.cfg.head_ch
        return chs


def _bn(out: Dict[str, torch.Tensor], dst: str, sd: Dict[str, torch.Tensor], src: str) -> None:
    out[f"{dst}.scale"] = sd[f"{src}.weight"]
    out[f"{dst}.bias"] = sd[f"{src}.bias"]
    out[f"{dst}.mean"] = sd[f"{src}.running_mean"]
    out[f"{dst}.var"] = sd[f"{src}.running_var"]


def convert_timm_efficientnet(sd: Dict[str, torch.Tensor], prefix: str = "") -> Dict[str, torch.Tensor]:
    """timm tf_efficientnet state dict (optionally under ``prefix``) → the
    module's paths (JAX leaf names, torch layouts)."""
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    out: Dict[str, torch.Tensor] = {"conv_stem.kernel": sd["conv_stem.weight"]}
    _bn(out, "bn1", sd, "bn1")
    si = 0
    while f"blocks.{si}.0.bn1.weight" in sd:
        bi = 0
        while f"blocks.{si}.{bi}.bn1.weight" in sd:
            b = f"blocks.{si}.{bi}"
            if f"{b}.conv_pwl.weight" in sd:  # MBConv
                out[f"{b}.conv_pw.kernel"] = sd[f"{b}.conv_pw.weight"]
                _bn(out, f"{b}.bn1", sd, f"{b}.bn1")
                out[f"{b}.conv_dw.kernel"] = sd[f"{b}.conv_dw.weight"]
                _bn(out, f"{b}.bn2", sd, f"{b}.bn2")
                out[f"{b}.conv_pwl.kernel"] = sd[f"{b}.conv_pwl.weight"]
                _bn(out, f"{b}.bn3", sd, f"{b}.bn3")
            else:  # depthwise-separable (stage 0)
                out[f"{b}.conv_dw.kernel"] = sd[f"{b}.conv_dw.weight"]
                _bn(out, f"{b}.bn1", sd, f"{b}.bn1")
                out[f"{b}.conv_pw.kernel"] = sd[f"{b}.conv_pw.weight"]
                _bn(out, f"{b}.bn2", sd, f"{b}.bn2")
            for conv in ("conv_reduce", "conv_expand"):
                out[f"{b}.se.{conv}.kernel"] = sd[f"{b}.se.{conv}.weight"]
                out[f"{b}.se.{conv}.bias"] = sd[f"{b}.se.{conv}.bias"]
            bi += 1
        si += 1
    out["conv_head.kernel"] = sd["conv_head.weight"]
    _bn(out, "bn2", sd, "bn2")
    return out
