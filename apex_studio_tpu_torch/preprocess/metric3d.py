"""Metric3D v2 monocular metric depth and surface normals (port of
``apex_studio_tpu/preprocess/metric3d.py``): a DINOv2-with-registers ViT
(``mono/model/backbones/ViT_DINO_reg.py``) feeding the RAFT-style DPT decoder
``RAFTDepthNormalDPT5`` (``RAFTDepthNormalDPTDecoder5.py``): the DPT token
readout, multi-scale fusion, the log-bin depth expectation and the normal
head, then a 3-level ConvGRU refinement with convex upsampling. The ViT is
Depth Anything's port (``Conv``, ``_VitBlock``, its plain attention; giant2
swaps the MLP for ``_SwiGLUFFN`` and reads pre-norm taps every depth/4
blocks), NHWC at every function and with the JAX module's attribute names
(``loaders/from_jax.py`` carries the parameters). The published
``metric_depth_vit_{small,large,giant2}_800k.pth`` (``model_state_dict``,
``depth_model.`` prefixed, chunked ``blocks.<chunk>.<i>``) load through
``convert_metric3d_keys`` strictly.

The network runs in f32 on ``device`` (``None`` is the card). As in JAX: the
position grid is resized by ``jax.image.resize``'s bicubic (Keys a = −0.5,
no antialias; 37×37 → 44×76 on the 616×1064 crop, ``utils/jax_resize.py``:
``F.interpolate``'s bicubic is another function), ``_avg_pool`` counts the
padding, ``_nearest_scale`` takes ⌊dst·in/out⌋. The canonical-space resize
with mean-colour padding, the crop back and the renderings stay on the host:
the normal map as the inverted 127·n + 128 (reference ``__init__.py:163``),
the depth through matplotlib's ``Greys`` colormap, which the port carries as
its 256-entry table (``GREYS_LUT``, built as matplotlib builds it and held
against it in the tests): the card's machine has no matplotlib.

Departures: the JAX preprocessor loads with ``strict=False``; here the load
is strict over the ``encoder.`` and ``decoder.`` keys (the converter drops
the others, as JAX's does, and DINOv2's ``mask_token``), and a missing file
raises ``FileNotFoundError``. With ``multi_output`` (giant2) the port has no
final norm: the JAX module builds one and never runs it, and the published
file has none to fill it with.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import LayerNorm, Linear
from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_anything import (BlockUpsample, Conv, DAv2Config, _VitBlock,
                                                             resize_bilinear_ac)
from apex_studio_tpu_torch.utils.jax_resize import resize as jax_resize

_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
_STD = np.array([58.395, 57.12, 57.375], np.float32)


@dataclass
class Metric3DConfig:
    # backbone (DINOv2-reg)
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    patch_size: int = 14
    num_register_tokens: int = 4
    pos_grid: int = 37  # 518 / 14
    mlp_ratio: float = 4.0
    # decoder (RAFTDepthNormalDPT5)
    feature_channels: Sequence[int] = (96, 192, 384, 768)
    decoder_channels: Sequence[int] = (48, 96, 192, 384, 384)
    hidden_dim: int = 48
    n_gru_layers: int = 3
    n_downsample: int = 2
    iters: int = 4
    slow_fast_gru: bool = True
    num_anchors: int = 256
    min_depth: float = 0.1
    max_depth: float = 200.0
    regress_scale: float = 100.0
    crop_size: Tuple[int, int] = (616, 1064)
    # giant2 extras: SwiGLU FFN + pre-norm multi-scale feature taps
    ffn: str = "mlp"
    multi_output: bool = False

    @classmethod
    def small(cls) -> "Metric3DConfig":
        return cls()  # vit.raft5.small.py defaults

    @classmethod
    def large(cls) -> "Metric3DConfig":
        return cls(embed_dim=1024, depth=24, num_heads=16, feature_channels=(256, 512, 1024, 1024),
                   decoder_channels=(128, 256, 512, 1024, 1024), hidden_dim=128, iters=8)

    @classmethod
    def giant2(cls) -> "Metric3DConfig":
        return cls(embed_dim=1536, depth=40, num_heads=24, feature_channels=(384, 768, 1536, 1536),
                   decoder_channels=(192, 384, 768, 1536, 1536), hidden_dim=192, iters=8, ffn="swiglu",
                   multi_output=True)

    @classmethod
    def tiny(cls) -> "Metric3DConfig":
        """Test-scale config."""
        return cls(embed_dim=32, depth=2, num_heads=2, pos_grid=4, feature_channels=(8, 16, 32, 32),
                   decoder_channels=(8, 8, 16, 32, 32), hidden_dim=8, iters=2, num_anchors=16, crop_size=(56, 112))

    def _dav2(self) -> DAv2Config:
        return DAv2Config(encoder="metric3d", embed_dim=self.embed_dim, depth=self.depth, num_heads=self.num_heads,
                          mlp_ratio=self.mlp_ratio, patch_size=self.patch_size, pos_grid=self.pos_grid)


# -- backbone --------------------------------------------------------------------------


class _SwiGLUFFN(nn.Module):
    """SwiGLUFFNFused (ViT_DINO_reg.py:335/390, giant2's ffn_layer='swiglu'):
    hidden = round8(in · mlp_ratio · 2/3), fused gate + value projection."""

    def __init__(self, d: int, mlp_ratio: float):
        super().__init__()
        hidden = (int(d * mlp_ratio * 2 / 3) + 7) // 8 * 8
        self.w12 = Linear(d, 2 * hidden, dtype=torch.float32)
        self.w3 = Linear(hidden, d, dtype=torch.float32)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class _M3DViT(nn.Module):
    """DINOv2 with register tokens (ViT_DINO_reg.py forward_features).
    ``multi_output=False`` (small / large): every pyramid slot reads the
    same final-norm hidden states; True (giant2): pre-norm taps every
    depth/4 blocks, no final norm."""

    def __init__(self, cfg: Metric3DConfig):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.patch_embed = Conv(3, d, kernel=cfg.patch_size, stride=cfg.patch_size, padding=0)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pos_grid * cfg.pos_grid, d))
        self.blocks = nn.ModuleList([_VitBlock(cfg._dav2()) for _ in range(cfg.depth)])
        if cfg.ffn == "swiglu":
            for blk in self.blocks:
                blk.mlp = _SwiGLUFFN(d, cfg.mlp_ratio)
        self.norm = None if cfg.multi_output else LayerNorm(d)

    def _interp_pos(self, gh: int, gw: int) -> torch.Tensor:
        pe, g = self.pos_embed, self.cfg.pos_grid
        if (gh, gw) == (g, g):
            return pe
        grid = pe[:, 1:].reshape(1, g, g, -1)
        grid = jax_resize(grid, (1, gh, gw, grid.shape[-1]), "bicubic", antialias=False)
        return torch.cat([pe[:, :1], grid.reshape(1, gh * gw, -1)], dim=1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: NHWC float (H, W multiples of patch_size) → 4 × [B, 1+R+N, D]."""
        b, H, W, _ = x.shape
        p = self.cfg.patch_size
        gh, gw = H // p, W // p
        tok = self.patch_embed(x).reshape(b, gh * gw, -1)
        tok = torch.cat([self.cls_token.expand(b, 1, tok.shape[-1]), tok], dim=1) + self._interp_pos(gh, gw)
        reg = self.register_tokens.expand(b, *self.register_tokens.shape[1:])
        tok = torch.cat([tok[:, :1], reg, tok[:, 1:]], dim=1)
        if self.cfg.multi_output:
            every = len(self.blocks) // 4
            feats = []
            for i, blk in enumerate(self.blocks):
                tok = blk(tok)
                if (i + 1) % every == 0:
                    feats.append(tok)  # pre-norm taps (the multi_output branch)
            return feats[:4]
        for blk in self.blocks:
            tok = blk(tok)
        tok = self.norm(tok)
        return [tok, tok, tok, tok]


# -- decoder building blocks (NHWC) ----------------------------------------------------


def _nearest_scale(x: torch.Tensor, sf: float) -> torch.Tensor:
    """torch F.interpolate(mode='nearest', scale_factor=sf) as JAX writes it:
    out = ⌊in·sf⌋, source index ⌊dst·in/out⌋."""
    _, h, w, _ = x.shape
    oh, ow = int(h * sf), int(w * sf)
    iy = torch.arange(oh, device=x.device) * h // oh
    ix = torch.arange(ow, device=x.device) * w // ow
    return x[:, iy][:, :, ix]


class _Readout(nn.Module):
    """DPT readout with the cls + register projection (Readout, decoder5.py:868)."""

    def __init__(self, d: int, n_learn: int):
        super().__init__()
        self.project_patch = Linear(d, d, dtype=torch.float32)
        self.project_learn = Linear(n_learn * d, d, use_bias=False, dtype=torch.float32)

    def forward(self, patch, learn):
        return F.gelu(self.project_patch(patch) + self.project_learn(learn))


class _Token2Feature(nn.Module):
    """Readout + scale-specific resampling (Token2Feature, decoder5.py:901)."""

    def __init__(self, d: int, cout: int, scale, n_learn: int):
        super().__init__()
        self.readoper = _Readout(d, n_learn)
        self.scale = scale
        if isinstance(scale, int) and scale > 1:
            self.sample = BlockUpsample(d, cout, scale)
        elif isinstance(scale, float) and scale > 1:
            self.sample = Conv(d, cout, kernel=1, padding=0)
        else:
            self.sample = None

    def forward(self, patch, learn):
        x = self.readoper(patch, learn)  # (B, gh, gw, d)
        if isinstance(self.scale, float) and self.scale > 1:
            x = _nearest_scale(x, self.scale)
        return x if self.sample is None else self.sample(x)


class _EncoderFeature(nn.Module):
    def __init__(self, cfg: Metric3DConfig):
        super().__init__()
        d, ch, n_learn = cfg.embed_dim, cfg.feature_channels, 1 + cfg.num_register_tokens
        self.read_3 = _Token2Feature(d, ch[3], 1, n_learn)
        self.read_2 = _Token2Feature(d, ch[2], 1, n_learn)
        self.read_1 = _Token2Feature(d, ch[1], 2, n_learn)
        self.read_0 = _Token2Feature(d, ch[0], 7 / 2, n_learn)

    def forward(self, pairs):
        """4 × (patch, learn), earliest tap first; read_3 takes the deepest
        (EncoderFeature.forward, decoder5.py:1012)."""
        return self.read_3(*pairs[3]), self.read_2(*pairs[2]), self.read_1(*pairs[1]), self.read_0(*pairs[0])


class _ConvBlock(nn.Module):
    """Pre-activation residual conv pair (ConvBlock, decoder5.py:793). The
    reference's in-place ReLU rewrites ``x``, so the residual adds
    ``relu(x)``; published checkpoints are trained under that, and JAX and
    the port reproduce it."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = Conv(c, c)
        self.conv2 = Conv(c, c)

    def forward(self, x):
        a = F.relu(x)
        return a + self.conv2(F.relu(self.conv1(a)))


class _FuseBlock(nn.Module):
    """DPT fusion (FuseBlock, decoder5.py:824): branch add → trunk →
    align-corners bilinear upsample → 1×1 out conv."""

    def __init__(self, cin: int, cout: int, fuse: bool = True, upsample: bool = True, scale_factor: float = 2.0):
        super().__init__()
        self.way_trunk = _ConvBlock(cin)
        self.way_branch = _ConvBlock(cin) if fuse else None
        self.out_conv = Conv(cin, cout, kernel=1, padding=0)
        self.upsample, self.scale_factor = upsample, scale_factor

    def forward(self, x1, x2=None):
        if x2 is not None:
            x1 = x1 + self.way_branch(x2)
        out = self.way_trunk(x1)
        if self.upsample:
            out = resize_bilinear_ac(out, int(out.shape[1] * self.scale_factor), int(out.shape[2] * self.scale_factor))
        return self.out_conv(out)


class _DecoderFeature(nn.Module):
    def __init__(self, cfg: Metric3DConfig):
        super().__init__()
        ch = cfg.decoder_channels
        self.upconv_3 = _FuseBlock(ch[4], ch[3], fuse=False, upsample=False)
        self.upconv_2 = _FuseBlock(ch[3], ch[2])
        self.upconv_1 = _FuseBlock(ch[2], ch[1] + 2, scale_factor=7 / 4)

    def forward(self, x, x2, x1):
        return self.upconv_1(self.upconv_2(self.upconv_3(x), x2), x1)  # 1/14 → 1/7 → 1/4


class _ResidualBlockLN(nn.Module):
    """ResidualBlock with norm_fn='layer' (decoder5.py:635): LN over channels."""

    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv1 = Conv(cin, c)
        self.conv2 = Conv(c, c)
        self.norm1 = LayerNorm(c, eps=1e-5)
        self.norm2 = LayerNorm(c, eps=1e-5)
        if cin != c:
            self.down_conv = Conv(cin, c, kernel=1, padding=0)
            self.norm3 = LayerNorm(c, eps=1e-5)
        else:
            self.down_conv = None

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.down_conv is not None:
            x = self.norm3(self.down_conv(x))
        return F.relu(x + y)


class _ContextBranch(nn.Module):
    """Sequential(ResidualBlock, Conv): one hidden / context tap."""

    def __init__(self, cin: int, c: int):
        super().__init__()
        self.res = _ResidualBlockLN(cin, c)
        self.out = Conv(c, c)

    def forward(self, x):
        return self.out(self.res(x))


class _ContextFeatureEncoder(nn.Module):
    def __init__(self, cfg: Metric3DConfig):
        super().__init__()
        ch, hd = cfg.feature_channels, cfg.hidden_dim
        self.outputs04 = nn.ModuleList([_ContextBranch(ch[0], hd) for _ in range(2)])
        self.outputs08 = nn.ModuleList([_ContextBranch(ch[1], hd) for _ in range(2)])
        self.outputs16 = nn.ModuleList([_ContextBranch(ch[2], hd) for _ in range(2)])

    def forward(self, x04, x08, x16):
        return ([f(x04) for f in self.outputs04], [f(x08) for f in self.outputs08],
                [f(x16) for f in self.outputs16])


class _ConvGRU(nn.Module):
    def __init__(self, hidden: int, cin: int):
        super().__init__()
        self.convz = Conv(hidden + cin, hidden)
        self.convr = Conv(hidden + cin, hidden)
        self.convq = Conv(hidden + cin, hidden)

    def forward(self, h, cz, cr, cq, *x_list):
        x = torch.cat(x_list, dim=-1)
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=-1)) + cq)
        return (1 - z) * h + z * q


class _FlowHead(nn.Module):
    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.conv1d = Conv(cin, hidden // 2)
        self.conv2d = Conv(hidden // 2, 2)
        self.conv1n = Conv(cin, hidden // 2)
        self.conv2n = Conv(hidden // 2, 4)

    def forward(self, x):
        depth = self.conv2d(F.relu(self.conv1d(x)))
        normal = self.conv2n(F.relu(self.conv1n(x)))
        return torch.cat([depth, normal], dim=-1)


def _avg_pool(x, k: int, s: int, p: int):
    """torch avg_pool2d with count_include_pad=True, on NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, s, p, count_include_pad=True).permute(0, 2, 3, 1)


def _pool2x(x):
    return _avg_pool(x, 3, 2, 1)


def _interp_to(x, dest):
    return resize_bilinear_ac(x, dest.shape[1], dest.shape[2])


class _UpdateBlock(nn.Module):
    """BasicMultiUpdateBlock (decoder5.py:531): the 3-level GRU cascade, the
    flow head and the convex-upsampling mask."""

    def __init__(self, cfg: Metric3DConfig):
        super().__init__()
        hd, n = cfg.hidden_dim, cfg.n_gru_layers
        enc = 6  # no correlation volume
        self.n_gru_layers = n
        self.gru08 = _ConvGRU(hd, enc + hd * (n > 1))
        self.gru16 = _ConvGRU(hd, hd * (n == 3) + hd)
        self.gru32 = _ConvGRU(hd, hd)
        self.flow_head = _FlowHead(hd, 2 * hd)
        factor = 2 ** cfg.n_downsample
        self.mask_conv1 = Conv(hd, hd)
        self.mask_conv2 = Conv(hd, factor * factor * 9, kernel=1, padding=0)

    def forward(self, net, inp, flow=None, iter08=True, iter16=True, iter32=True, update=True):
        if iter32:
            net[2] = self.gru32(net[2], *inp[2], _pool2x(net[1]))
        if iter16:
            if self.n_gru_layers > 2:
                net[1] = self.gru16(net[1], *inp[1], _interp_to(_pool2x(net[0]), net[1]), _interp_to(net[2], net[1]))
            else:
                net[1] = self.gru16(net[1], *inp[1], _interp_to(_pool2x(net[0]), net[1]))
        if iter08:
            if self.n_gru_layers > 1:
                net[0] = self.gru08(net[0], *inp[0], flow, _interp_to(net[1], net[0]))
            else:
                net[0] = self.gru08(net[0], *inp[0], flow)
        if not update:
            return net, None, None
        delta = self.flow_head(net[0])
        mask = 0.25 * self.mask_conv2(F.relu(self.mask_conv1(net[0])))
        return net, mask, delta


def _unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """NHWC → (B, H, W, 9, C), the neighbours in F.unfold's order (ky, kx)."""
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    h, w = x.shape[1], x.shape[2]
    return torch.stack([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], dim=3)


def _convex_upsample(flow: torch.Tensor, mask: torch.Tensor, factor: int):
    """RAFT convex upsampling (decoder5.py upsample_flow), NHWC."""
    b, h, w, d = flow.shape
    m = torch.softmax(mask.reshape(b, h, w, 9, factor, factor), dim=3)
    up = torch.einsum("bhwkuv,bhwkd->bhuwvd", m, _unfold3x3(flow))
    return up.reshape(b, h * factor, w * factor, d)


class RAFTDepthNormalDecoder(nn.Module):
    """RAFTDepthNormalDPT5 (decoder5.py:1071), the inference path."""

    def __init__(self, cfg: Metric3DConfig):
        super().__init__()
        self.cfg = cfg
        used = cfg.decoder_channels[1]
        self.token2feature = _EncoderFeature(cfg)
        self.decoder_mono = _DecoderFeature(cfg)
        self.depth_reg_conv1 = Conv(used, cfg.num_anchors)
        self.depth_reg_conv2 = Conv(cfg.num_anchors, cfg.num_anchors, kernel=1, padding=0)
        self.normal_conv1 = Conv(used, 128)
        self.normal_conv2 = Conv(128, 128, kernel=1, padding=0)
        self.normal_conv3 = Conv(128, 128, kernel=1, padding=0)
        self.normal_conv4 = Conv(128, 3, kernel=1, padding=0)
        self.context_feature_encoder = _ContextFeatureEncoder(cfg)
        self.context_zqr_convs = nn.ModuleList([Conv(cfg.hidden_dim, cfg.hidden_dim * 3)
                                                for _ in range(cfg.n_gru_layers)])
        self.update_block = _UpdateBlock(cfg)

    def _clamp(self, x):
        c = self.cfg
        y = F.relu(x - c.min_depth) + c.min_depth
        return c.max_depth - F.relu(c.max_depth - y)

    @staticmethod
    def _norm_normalize(x):
        n = torch.sqrt(torch.sum(x[..., :3] ** 2, dim=-1, keepdim=True)) + 1e-10
        kappa = F.elu(x[..., 3:4]) + 1.0 + 0.01
        return torch.cat([x[..., :3] / n, kappa], dim=-1)

    def forward(self, pairs):
        cfg = self.cfg
        x, x2, x1, x0 = self.token2feature(pairs)
        ref = self.decoder_mono(x, x2, x1)  # (B, h4, w4, used + 2)
        feat, depth_conf, normal_conf = ref[..., :-2], ref[..., -2:-1], ref[..., -1:]

        prob = torch.softmax(self.depth_reg_conv2(F.relu(self.depth_reg_conv1(feat))), dim=-1)
        bins = torch.exp(torch.linspace(math.log(cfg.min_depth), math.log(cfg.max_depth), cfg.num_anchors,
                                        device=feat.device))
        d = torch.sum(prob * bins, dim=-1, keepdim=True)  # the log-bin expectation
        depth_pred = (self._clamp(d) - cfg.max_depth) / cfg.regress_scale

        n = self.normal_conv2(F.relu(self.normal_conv1(feat)))
        n = self.normal_conv4(F.relu(self.normal_conv3(F.relu(n))))
        normal_pred = self._norm_normalize(torch.cat([n, normal_conf], dim=-1))
        flow = torch.cat([depth_pred, depth_conf, normal_pred], dim=-1)

        # decoder_mono's in-place ReLUs (decoder5.py:1344) rectify the shared
        # encoder features x1 and x2 before the context encoder reads them
        cnet = self.context_feature_encoder(x0, F.relu(x1), F.relu(x2))
        net = [torch.tanh(c[0]) for c in cnet]
        inp = [tuple(conv(F.relu(c[1])).chunk(3, dim=-1)) for c, conv in zip(cnet, self.context_zqr_convs)]

        factor = 2 ** cfg.n_downsample
        up_flow = None
        for _ in range(cfg.iters):
            if cfg.n_gru_layers == 3 and cfg.slow_fast_gru:
                net, _, _ = self.update_block(net, inp, iter32=True, iter16=False, iter08=False, update=False)
            if cfg.n_gru_layers >= 2 and cfg.slow_fast_gru:
                net, _, _ = self.update_block(net, inp, iter32=cfg.n_gru_layers == 3, iter16=True, iter08=False,
                                              update=False)
            net, mask, delta = self.update_block(net, inp, flow=flow, iter32=cfg.n_gru_layers == 3,
                                                 iter16=cfg.n_gru_layers >= 2)
            flow = flow + delta
            up_flow = _convex_upsample(flow, mask, factor)

        depth = self._clamp(up_flow[..., :1] * cfg.regress_scale + cfg.max_depth)
        return depth, up_flow[..., 1:2], self._norm_normalize(up_flow[..., 2:6])


class Metric3DModel(nn.Module):
    """Encoder + decoder (DensePredModel, dense_pipeline.py:6)."""

    def __init__(self, cfg: Optional[Metric3DConfig] = None):
        super().__init__()
        cfg = cfg or Metric3DConfig.small()
        self.cfg = cfg
        self.encoder = _M3DViT(cfg)
        self.decoder = RAFTDepthNormalDecoder(cfg)

    def forward(self, x: torch.Tensor):
        """x: NHWC normalised image, H and W multiples of the patch size →
        (depth [B, H, W, 1], confidence [B, H, W, 1], normal + kappa [B, H, W, 4])."""
        cfg = self.cfg
        b, H, W, _ = x.shape
        gh, gw = H // cfg.patch_size, W // cfg.patch_size
        n_learn = 1 + cfg.num_register_tokens
        pairs = [(tok[:, n_learn:].reshape(b, gh, gw, cfg.embed_dim),
                  tok[:, :n_learn].reshape(b, 1, 1, n_learn * cfg.embed_dim)) for tok in self.encoder(x)]
        return self.decoder(pairs)


# -- checkpoint conversion -------------------------------------------------------------

_SEQ_RENAMES = [
    ("decoder.depth_regressor.0.", "decoder.depth_reg_conv1."),
    ("decoder.depth_regressor.2.", "decoder.depth_reg_conv2."),
    ("decoder.normal_predictor.0.", "decoder.normal_conv1."),
    ("decoder.normal_predictor.2.", "decoder.normal_conv2."),
    ("decoder.normal_predictor.4.", "decoder.normal_conv3."),
    ("decoder.normal_predictor.6.", "decoder.normal_conv4."),
    ("decoder.update_block.mask.0.", "decoder.update_block.mask_conv1."),
    ("decoder.update_block.mask.2.", "decoder.update_block.mask_conv2."),
]


def convert_metric3d_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """JUGGHM/Metric3D ``model_state_dict`` → the JAX module's leaf names,
    torch layouts kept (read_1's transposed conv as ``[in, out, 2, 2]``
    under ``.sample.weight``). Keys outside ``encoder.`` / ``decoder.`` and
    DINOv2's ``mask_token`` are dropped, as in JAX."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        for pre in ("module.", "model.", "depth_model."):
            if k.startswith(pre):
                k = k[len(pre):]
        if k.startswith("encoder."):
            r = k[len("encoder."):]
            if r.startswith("mask_token"):
                continue
            r = re.sub(r"^blocks\.\d+\.(\d+)\.", r"blocks.\1.", r)  # chunked blocks
            r = r.replace("patch_embed.proj.weight", "patch_embed.kernel")
            r = r.replace("patch_embed.proj.bias", "patch_embed.bias")
            for lin in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2", "mlp.w12", "mlp.w3"):
                r = r.replace(f"{lin}.weight", f"{lin}.kernel")
            out[f"encoder.{r}"] = v
            continue
        if not k.startswith("decoder."):
            continue
        for a, b in _SEQ_RENAMES:
            if k.startswith(a):
                k = b + k[len(a):]
        k = k.replace("readoper.project_patch.weight", "readoper.project_patch.kernel")
        k = k.replace("readoper.project_learn.weight", "readoper.project_learn.kernel")
        k = k.replace(".sample.0.", ".sample.")  # read_0's Sequential(conv1x1)
        k = re.sub(r"(outputs(?:04|08|16)\.\d+)\.0\.", r"\1.res.", k)
        k = re.sub(r"(outputs(?:04|08|16)\.\d+)\.1\.", r"\1.out.", k)
        k = k.replace(".res.downsample.0.", ".res.down_conv.")
        k = k.replace(".res.downsample.1.", ".res.norm3.")
        if k.endswith(".weight") and v.ndim == 4 and "read_1.sample" not in k:
            k = k[: -len(".weight")] + ".kernel"
        out[k] = v
    return out


# -- rendering -------------------------------------------------------------------------

# matplotlib's "Greys" (_cm._Greys_data: ColorBrewer's 9 greys, white to black)
_GREYS = (1.0, 0.9411764705882353, 0.8509803921568627, 0.7411764705882353, 0.5882352941176471,
          0.45098039215686275, 0.3215686274509804, 0.1450980392156863, 0.0)


def _greys_lut(n: int = 256) -> np.ndarray:
    """``LinearSegmentedColormap.from_list("Greys", ...)``'s ``n``-entry
    table (``colors._create_lookup_table``, gamma 1): one grey a row."""
    x = np.linspace(0, 1, len(_GREYS)) * (n - 1)
    y = np.asarray(_GREYS)
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    return np.clip(np.concatenate([[y[0]], distance * (y[ind] - y[ind - 1]) + y[ind - 1], [y[-1]]]), 0.0, 1.0)


GREYS_LUT = _greys_lut()


def _gray_to_colormap(img: np.ndarray) -> np.ndarray:
    """metric3d __init__.py:113 gray_to_colormap with the ``Greys`` map, as
    matplotlib computes it: ``Normalize(0, 1.1)`` divides the f32 map by the
    f64 1.1 in place, the colormap takes ⌊x·256⌋ (256 as 255) from its table
    and the rendering truncates 255·grey."""
    img = np.maximum(img, 0.0)
    mask_invalid = img < 1e-10
    img = img / (img.max() + 1e-8)
    x = np.array(img, copy=True)
    x /= np.float64(1.1)  # Normalize's vmax - vmin, an f64 scalar: the quotient is rounded to f32
    x *= GREYS_LUT.shape[0]
    x[x == GREYS_LUT.shape[0]] = GREYS_LUT.shape[0] - 1
    grey = (GREYS_LUT.take(x.astype(int), mode="clip") * 255).astype(np.uint8)
    colored = np.repeat(grey[:, :, None], 3, axis=2)
    colored[mask_invalid] = 0
    return colored


@preprocessor_registry.register("metric3d", aliases=("Metric3DDetector", "metric3d_normal"))
class Metric3DPreprocessor(BasePreprocessor):
    """Metric depth (and normals) through Metric3D v2 (reference
    src/preprocess/metric3d/__init__.py). ``output_type``: depth | normal.
    Weights: ``metric_depth_vit_<variant>_800k.pth`` in the preprocessor
    models dir."""

    name = "metric3d"
    hf_repo = "JUGGHM/Metric3D"
    params_schema = {"detect_resolution": 512, "fx": 1000.0, "fy": 1000.0, "output_type": "depth"}

    def __init__(self, model: Optional[Metric3DModel] = None, variant: str = "small"):
        self._model = model
        self._variant = variant

    def setup(self) -> None:
        if self._model is not None:
            return
        from apex_studio_tpu_torch.preprocess.weights import load_detector

        cfg = {"large": Metric3DConfig.large, "giant2": Metric3DConfig.giant2,
               "small": Metric3DConfig.small}[self._variant]()
        stem = f"metric_depth_vit_{self._variant}_800k"
        self._model = load_detector(lambda: Metric3DModel(cfg), stem, f"{stem}.pth", convert_metric3d_keys,
                                    self.device)

    def canonical_input(self, frame: Frame):
        """The frame resized to fit the crop and padded with the mean colour
        (do_test.py transform_test_data_scalecano; fx = fy = 1000 keeps the
        canonical ratio at 1), normalised: (NHWC f32, (top, bottom, left,
        right) padding)."""
        import cv2

        h0, w0 = frame.shape[:2]
        crop_h, crop_w = self._model.cfg.crop_size
        scale = min(crop_h / h0, crop_w / w0)
        rh, rw = int(scale * h0), int(scale * w0)
        img = cv2.resize(np.asarray(frame)[..., :3], (rw, rh), interpolation=cv2.INTER_LINEAR)
        pt, pl = (crop_h - rh) // 2, (crop_w - rw) // 2
        pb, pr = crop_h - rh - pt, crop_w - rw - pl
        img = cv2.copyMakeBorder(img, pt, pb, pl, pr, cv2.BORDER_CONSTANT, value=_MEAN.tolist())
        return ((img.astype(np.float32) - _MEAN) / _STD)[None], (pt, pb, pl, pr)

    def predict(self, frame: Frame):
        """(depth [h, w], normal [h, w, 3]) f32 on the crop's unpadded part."""
        x, (pt, pb, pl, pr) = self.canonical_input(frame)
        crop_h, crop_w = self._model.cfg.crop_size
        dev = next(self._model.parameters()).device
        with torch.no_grad():
            depth, _conf, normal = self._model(torch.from_numpy(x).to(dev))
        depth = depth[0, pt:crop_h - pb, pl:crop_w - pr, 0].cpu().numpy()
        return depth, normal[0, pt:crop_h - pb, pl:crop_w - pr, :3].cpu().numpy()

    def process_frame(self, frame: Frame, detect_resolution: int = 512, fx: float = 1000.0, fy: float = 1000.0,
                      output_type: str = "depth", **_) -> Frame:
        import cv2

        h0, w0 = frame.shape[:2]
        depth, nrm = self.predict(frame)
        if output_type == "normal":
            nrm = nrm / (np.linalg.norm(nrm, axis=-1, keepdims=True) + 1e-8)
            out = 255 - (nrm * 127 + 128).astype(np.uint8)  # the reference inverts for ControlNet
        else:
            out = _gray_to_colormap(depth)
        return cv2.resize(out, (w0, h0), interpolation=cv2.INTER_LINEAR)
