"""GMFlow / UniMatch optical flow (port of ``apex_studio_tpu/preprocess/unimatch.py``):
a 6-level residual CNN encoder with non-affine instance norm (backbone.py:59),
a 6-block single-head feature transformer with swin split-window attention
and DETR sine positions (transformer.py:232, attention.py:48, position.py:9),
global / local correlation softmax matching (matching.py:7/47),
self-attention flow propagation (attention.py:184) and RAFT-style convex
upsampling (utils.py:165); the published ``gmflow-scale1``,
``gmflow-scale2`` and ``gmflow-scale2-regrefine6`` configurations
(``GMFLOW_CONFIGS``, reference __init__.py:115-158), the last with the
RAFT ``BasicUpdateBlock`` that refines the final flow 6 times.

NHWC at every function as in the JAX module and with its attribute names
(``loaders/from_jax.py`` carries the parameters); the published
``gmflow-*-mixdata.pth`` load through ``convert_gmflow_keys`` strictly. The
network runs in f32 on ``device`` (``None`` is the card); the resizes and the
Middlebury colour wheel (``flow_to_image``) stay on the host.

The attention is the plain version, as in JAX, which computes it with its
own einsum (``_attend``): single-head at C = 128 with a per-query shift mask.
No Pallas kernel is on this path. Kept as JAX has them: the roll and −100
shift mask of the shifted windows, ``SelfAttnPropagation``'s ``k_proj`` of
the projected query (the reference's quirk), ``_bilinear_sample``'s zero
padding on absolute pixel coordinates, the −1e9 on invalid local taps, and
the refinement loop whose GRU state restarts from ``refine_proj`` each time.

Departure: the JAX preprocessor runs random weights (with a warning) where
it finds no checkpoint and loads only the names that match; here a missing
checkpoint raises ``FileNotFoundError`` and the load is strict.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import LayerNorm, Linear
from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_anything import _lecun, conv2d_nhwc
from apex_studio_tpu_torch.preprocess.mlsd import _resize_align_corners

_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


# -- primitives ------------------------------------------------------------------------


def _instance_norm(x, eps=1e-5):
    """Non-affine InstanceNorm2d (the backbone's norms carry no parameters)."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class _Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, pad=0, dilation=1, bias=True):
        super().__init__()
        kh, kw = k if isinstance(k, tuple) else (k, k)
        self.weight = _lecun(cout, cin, kh, kw, fan_in=cin * kh * kw)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        ph, pw = pad if isinstance(pad, tuple) else (pad, pad)
        self.stride, self.pad, self.dilation = stride, ((ph, ph), (pw, pw)), dilation

    def forward(self, x):
        return conv2d_nhwc(x, self.weight, self.bias, self.stride, self.pad, self.dilation)


def _linear(cin, cout, bias=False):
    return Linear(cin, cout, use_bias=bias, dtype=torch.float32)


# -- backbone --------------------------------------------------------------------------


class _ResidualBlock(nn.Module):
    """backbone.py:6 — two 3×3 convs (no bias) + instance norms + skip."""

    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = _Conv(cin, cout, 3, stride, 1, bias=False)
        self.conv2 = _Conv(cout, cout, 3, 1, 1, bias=False)
        self.downsample = _Conv(cin, cout, 1, stride, 0) if stride != 1 or cin != cout else None

    def forward(self, x):
        y = F.relu(_instance_norm(self.conv1(x)))
        y = F.relu(_instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = _instance_norm(self.downsample(x))
        return F.relu(x + y)


class CNNEncoder(nn.Module):
    """backbone.py:59 — 1/2, 1/4, then 1/8 (scale1) or 1/4 + the trident
    convolution's two scales (scale2)."""

    def __init__(self, output_dim=128, num_output_scales=1):
        super().__init__()
        self.num_branch = num_output_scales
        dims = [64, 96, 128]
        self.conv1 = _Conv(3, dims[0], 7, 2, 3, bias=False)
        self.layer1 = nn.ModuleList([_ResidualBlock(dims[0], dims[0]), _ResidualBlock(dims[0], dims[0])])
        self.layer2 = nn.ModuleList([_ResidualBlock(dims[0], dims[1], 2), _ResidualBlock(dims[1], dims[1])])
        stride = 2 if num_output_scales == 1 else 1
        self.layer3 = nn.ModuleList([_ResidualBlock(dims[1], dims[2], stride), _ResidualBlock(dims[2], dims[2])])
        self.conv2 = _Conv(dims[2], output_dim, 1)
        # the trident conv: one shared 3×3 kernel applied at strides 1 and 2
        self.trident_weight = (_lecun(output_dim, output_dim, 3, 3, fan_in=output_dim * 9)
                               if num_output_scales > 1 else None)

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(_instance_norm(self.conv1(x)))
        for blk in (*self.layer1, *self.layer2, *self.layer3):
            x = blk(x)
        x = self.conv2(x)
        if self.trident_weight is None:
            return [x]
        return [conv2d_nhwc(x, self.trident_weight, None, s, 1) for s in (1, 2)]


# -- positions / swin helpers ----------------------------------------------------------


def sine_position(h: int, w: int, dim: int) -> np.ndarray:
    """DETR PositionEmbeddingSine (position.py:9) → [h, w, dim] numpy."""
    half = dim // 2
    y = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :] * np.ones((h, 1), np.float32)
    scale = 2 * math.pi
    y = y / (y[-1:, :] + 1e-6) * scale
    x = x / (x[:, -1:] + 1e-6) * scale
    dim_t = np.arange(half, dtype=np.float32)
    dim_t = 10000.0 ** (2 * (dim_t // 2) / half)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])], -1).reshape(h, w, -1)
    py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])], -1).reshape(h, w, -1)
    return np.concatenate([py, px], axis=-1)


def _split_windows(x, k):
    """[B, H, W, C] → [B·k·k, H/k, W/k, C] (utils.py:37)."""
    b, h, w, c = x.shape
    x = x.reshape(b, k, h // k, k, w // k, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b * k * k, h // k, w // k, c)


def _merge_windows(x, k, h, w):
    b, c = x.shape[0] // (k * k), x.shape[-1]
    x = x.reshape(b, k, k, h // k, w // k, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def swin_shift_mask(h: int, w: int, k: int) -> np.ndarray:
    """utils.py:101 — [k·k, hw/k², hw/k²] additive mask for shifted windows."""
    wh, ww = h // k, w // k
    sh, sw = wh // 2, ww // 2
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for ws in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = img.reshape(1, k, wh, k, ww, 1).transpose(0, 1, 3, 2, 4, 5).reshape(k * k, wh * ww)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _attend(q, k, v, mask=None):
    scores = torch.einsum("blc,bmc->blm", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores + mask
    return torch.einsum("blm,bmc->blc", torch.softmax(scores, dim=-1), v)


def _swin_attention(q, k, v, h, w, num_splits, with_shift, attn_mask):
    """attention.py:48 single_head_split_window_attention. q/k/v [B, L, C]."""
    b, _, c = q.shape
    if num_splits <= 1:
        return _attend(q, k, v)
    qs, ks, vs = (t.reshape(b, h, w, c) for t in (q, k, v))
    sh, sw = (h // num_splits) // 2, (w // num_splits) // 2
    if with_shift:
        qs, ks, vs = (torch.roll(t, (-sh, -sw), dims=(1, 2)) for t in (qs, ks, vs))
    qw, kw, vw = (_split_windows(t, num_splits).reshape(b * num_splits ** 2, -1, c) for t in (qs, ks, vs))
    mask = attn_mask.repeat(b, 1, 1) if with_shift and attn_mask is not None else None
    out = _attend(qw, kw, vw, mask)
    out = _merge_windows(out.reshape(b * num_splits ** 2, h // num_splits, w // num_splits, c), num_splits, h, w)
    if with_shift:
        out = torch.roll(out, (sh, sw), dims=(1, 2))
    return out.reshape(b, -1, c)


# -- transformer -----------------------------------------------------------------------


class TransformerLayer(nn.Module):
    def __init__(self, d=128, no_ffn=False, expansion=4):
        super().__init__()
        self.q_proj, self.k_proj, self.v_proj, self.merge = (_linear(d, d) for _ in range(4))
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.no_ffn = no_ffn
        if not no_ffn:
            self.mlp0 = _linear(2 * d, 2 * d * expansion)
            self.mlp2 = _linear(2 * d * expansion, d)
            self.norm2 = LayerNorm(d, eps=1e-5)

    def forward(self, source, target, h, w, num_splits, with_shift, attn_mask):
        msg = _swin_attention(self.q_proj(source), self.k_proj(target), self.v_proj(target), h, w, num_splits,
                              with_shift, attn_mask)
        msg = self.norm1(self.merge(msg))
        if not self.no_ffn:
            msg = self.norm2(self.mlp2(F.gelu(self.mlp0(torch.cat([source, msg], dim=-1)))))
        return source + msg


class TransformerBlock(nn.Module):
    def __init__(self, d=128, expansion=4):
        super().__init__()
        self.self_attn = TransformerLayer(d, no_ffn=True, expansion=expansion)
        self.cross_attn_ffn = TransformerLayer(d, expansion=expansion)

    def forward(self, source, target, h, w, num_splits, with_shift, attn_mask):
        source = self.self_attn(source, source, h, w, num_splits, with_shift, attn_mask)
        return self.cross_attn_ffn(source, target, h, w, num_splits, with_shift, attn_mask)


# -- matching / propagation ------------------------------------------------------------


def _coords_grid(h, w, like: torch.Tensor) -> torch.Tensor:
    """[H, W, 2] (x, y) pixel coordinates in ``like``'s dtype and device."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=like.dtype, device=like.device),
                            torch.arange(w, dtype=like.dtype, device=like.device), indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def _offsets(radius: int) -> np.ndarray:
    """The (2R+1)² window's (x, y) offsets, row-major in y."""
    r = np.arange(-radius, radius + 1, dtype=np.float32)
    return np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)[..., ::-1].reshape(-1, 2)


def global_correlation_flow(f0, f1):
    """matching.py:7 — softmax over all-pairs correlation → expected
    correspondence. f0/f1 [B, H, W, C] → flow [B, H, W, 2]."""
    b, h, w, c = f0.shape
    corr = torch.einsum("bic,bjc->bij", f0.reshape(b, -1, c), f1.reshape(b, -1, c)) / math.sqrt(c)
    grid = _coords_grid(h, w, f0).reshape(-1, 2)
    corres = torch.einsum("bij,jk->bik", torch.softmax(corr, dim=-1), grid).reshape(b, h, w, 2)
    return corres - grid.reshape(1, h, w, 2)


def _bilinear_sample(img, coords):
    """img [B, H, W, C], coords [B, H', W', 2] absolute (x, y), zero pad."""
    b, h, w, c = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = img.reshape(b, h * w, c)

    def gather(ix, iy):
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx = iy.clamp(0, h - 1).long() * w + ix.clamp(0, w - 1).long()
        vals = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(b, idx[0].numel(), c))
        return vals.reshape(b, *ix.shape[1:], c) * valid[..., None]

    return (gather(x0, y0) * ((1 - fx) * (1 - fy))[..., None] + gather(x0 + 1, y0) * (fx * (1 - fy))[..., None]
            + gather(x0, y0 + 1) * ((1 - fx) * fy)[..., None] + gather(x0 + 1, y0 + 1) * (fx * fy)[..., None])


def flow_warp(feature, flow):
    """geometry.py:74 — sample feature at coords + flow."""
    _, h, w, _ = feature.shape
    return _bilinear_sample(feature, _coords_grid(h, w, feature)[None] + flow)


def local_correlation_flow(f0, f1, radius):
    """matching.py:47 — correlation over a (2R+1)² window."""
    b, h, w, c = f0.shape
    grid = _coords_grid(h, w, f0)[None]
    corrs, coords_all = [], []
    for off in _offsets(radius):
        coords = (grid + torch.from_numpy(off.copy()).to(f0.device)).expand(b, h, w, 2)
        corr = (f0 * _bilinear_sample(f1, coords)).sum(-1) / math.sqrt(c)
        valid = (coords[..., 0] >= 0) & (coords[..., 0] < w) & (coords[..., 1] >= 0) & (coords[..., 1] < h)
        corrs.append(torch.where(valid, corr, torch.full_like(corr, -1e9)))
        coords_all.append(coords)
    prob = torch.softmax(torch.stack(corrs, dim=-1), dim=-1)
    corres = (prob[..., None] * torch.stack(coords_all, dim=-2)).sum(-2)
    return corres - grid


class SelfAttnPropagation(nn.Module):
    """attention.py:184 — flow smoothing: q and k from the feature, v the flow."""

    def __init__(self, dim):
        super().__init__()
        self.q_proj = _linear(dim, dim, bias=True)
        self.k_proj = _linear(dim, dim, bias=True)

    def forward(self, feature, flow, local_radius: int = 0):
        b, h, w, c = feature.shape
        if local_radius > 0:
            return self._local(feature, flow, local_radius)
        q = self.q_proj(feature.reshape(b, -1, c))
        k = self.k_proj(q)  # the reference's quirk: k projects the projected q
        return _attend(q, k, flow.reshape(b, -1, flow.shape[-1])).reshape(b, h, w, -1)

    def _local(self, feature, flow, radius):
        b, h, w, c = feature.shape
        ksz = 2 * radius + 1
        q = self.q_proj(feature.reshape(b, -1, c)).reshape(b, h, w, c)
        kf = self.k_proj(feature.reshape(b, -1, c)).reshape(b, h, w, c)
        kp = F.pad(kf, (0, 0, radius, radius, radius, radius))
        vp = F.pad(flow, (0, 0, radius, radius, radius, radius))
        scores, vals = [], []
        for dy in range(ksz):
            for dx in range(ksz):
                scores.append((q * kp[:, dy:dy + h, dx:dx + w]).sum(-1) / math.sqrt(c))
                vals.append(vp[:, dy:dy + h, dx:dx + w])
        prob = torch.softmax(torch.stack(scores, dim=-1), dim=-1)
        return (prob[..., None] * torch.stack(vals, dim=-2)).sum(-2)


def upsample_flow_with_mask(flow, mask, factor):
    """utils.py:165 — RAFT convex upsampling. flow [B, H, W, 2],
    mask [B, H, W, 9·factor²]."""
    b, h, w, _ = flow.shape
    mask = torch.softmax(mask.reshape(b, h, w, 9, factor, factor), dim=3)
    fl = F.pad(flow * factor, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([fl[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], dim=3)
    up = torch.einsum("bhwkuv,bhwkc->bhwuvc", mask, neigh)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, h * factor, w * factor, 2)


def local_correlation_with_flow(f0, f1, flow, radius: int = 4):
    """matching.py:117 — raw local correlation sampled at coords + flow with
    zero padding (the refinement's cost volume) → [B, H, W, (2R+1)²]."""
    b, h, w, c = f0.shape
    base = _coords_grid(h, w, f0)[None] + flow
    corrs = []
    for off in _offsets(radius):
        coords = (base + torch.from_numpy(off.copy()).to(f0.device)).expand(b, h, w, 2)
        valid = (coords[..., 0] >= 0) & (coords[..., 0] < w) & (coords[..., 1] >= 0) & (coords[..., 1] < h)
        corr = (f0 * _bilinear_sample(f1, coords)).sum(-1) / math.sqrt(c)
        corrs.append(torch.where(valid, corr, torch.zeros_like(corr)))
    return torch.stack(corrs, dim=-1)


class _FlowHead(nn.Module):
    """reg_refine.py:6."""

    def __init__(self, input_dim=128, hidden_dim=256, out_dim=2):
        super().__init__()
        self.conv1 = _Conv(input_dim, hidden_dim, 3, 1, 1)
        self.conv2 = _Conv(hidden_dim, out_dim, 3, 1, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class _SepConvGRU(nn.Module):
    """reg_refine.py:25 — separable (1×5) + (5×1) conv GRU."""

    def __init__(self, hidden_dim=128, input_dim=256, k=5):
        super().__init__()
        cin, p = hidden_dim + input_dim, (k - 1) // 2
        self.convz1, self.convr1, self.convq1 = (_Conv(cin, hidden_dim, (1, k), 1, (0, p)) for _ in range(3))
        self.convz2, self.convr2, self.convq2 = (_Conv(cin, hidden_dim, (k, 1), 1, (p, 0)) for _ in range(3))

    def forward(self, h, x):
        for convz, convr, convq in ((self.convz1, self.convr1, self.convq1), (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], dim=-1)
            z = torch.sigmoid(convz(hx))
            r = torch.sigmoid(convr(hx))
            q = torch.tanh(convq(torch.cat([r * h, x], dim=-1)))
            h = (1 - z) * h + z * q
        return h


class _BasicMotionEncoder(nn.Module):
    """reg_refine.py:73."""

    def __init__(self, corr_channels=81, flow_channels=2):
        super().__init__()
        self.convc1 = _Conv(corr_channels, 256, 1)
        self.convc2 = _Conv(256, 192, 3, 1, 1)
        self.convf1 = _Conv(flow_channels, 128, 7, 1, 3)
        self.convf2 = _Conv(128, 64, 3, 1, 1)
        self.conv = _Conv(64 + 192, 128 - flow_channels, 3, 1, 1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([cor, flo], dim=-1))), flow], dim=-1)


class BasicUpdateBlock(nn.Module):
    """reg_refine.py:98 — RAFT-style GRU update with a convex-upsample mask."""

    def __init__(self, corr_channels=81, hidden_dim=128, context_dim=128, downsample_factor=4, flow_dim=2):
        super().__init__()
        self.encoder = _BasicMotionEncoder(corr_channels, flow_dim)
        self.gru = _SepConvGRU(hidden_dim, context_dim + hidden_dim)
        self.flow_head = _FlowHead(hidden_dim, 256, flow_dim)
        self.mask_conv1 = _Conv(hidden_dim, 256, 3, 1, 1)
        self.mask_conv2 = _Conv(256, downsample_factor ** 2 * 9, 1)

    def forward(self, net, inp, corr, flow):
        inp = torch.cat([inp, self.encoder(flow, corr)], dim=-1)
        net = self.gru(net, inp)
        return net, self.mask_conv2(F.relu(self.mask_conv1(net))), self.flow_head(net)


# -- model -----------------------------------------------------------------------------


@dataclass
class GMFlowConfig:
    num_scales: int = 1
    feature_channels: int = 128
    upsample_factor: int = 8
    num_transformer_layers: int = 6
    ffn_dim_expansion: int = 4
    attn_splits_list: Tuple[int, ...] = (2,)
    corr_radius_list: Tuple[int, ...] = (-1,)
    prop_radius_list: Tuple[int, ...] = (-1,)
    reg_refine: bool = False       # unimatch.py:30 (scale2-regrefine6 tier)
    num_reg_refine: int = 1


class GMFlow(nn.Module):
    """UniMatch's flow path (unimatch.py:21)."""

    def __init__(self, cfg: Optional[GMFlowConfig] = None):
        super().__init__()
        cfg = cfg or GMFlowConfig()
        self.cfg = cfg
        d = cfg.feature_channels
        self.backbone = CNNEncoder(d, cfg.num_scales)
        self.layers = nn.ModuleList([TransformerBlock(d, cfg.ffn_dim_expansion)
                                     for _ in range(cfg.num_transformer_layers)])
        self.feature_flow_attn = SelfAttnPropagation(d)
        if not cfg.reg_refine:
            self.upsampler_conv1 = _Conv(2 + d, 256, 3, 1, 1)
            self.upsampler_conv2 = _Conv(256, cfg.upsample_factor ** 2 * 9, 1)
        else:
            self.refine_proj = _Conv(d, 256, 1)
            self.refine = BasicUpdateBlock(corr_channels=(2 * 4 + 1) ** 2, downsample_factor=cfg.upsample_factor)

    def _transform(self, f0, f1, h, w, num_splits):
        attn_mask = torch.from_numpy(swin_shift_mask(h, w, num_splits)).to(f0.device) if num_splits > 1 else None
        c = f0.shape[-1]
        cat0 = torch.cat([f0, f1], 0).reshape(-1, h * w, c)
        cat1 = torch.cat([f1, f0], 0).reshape(-1, h * w, c)
        for i, layer in enumerate(self.layers):
            cat0 = layer(cat0, cat1, h, w, num_splits, num_splits > 1 and i % 2 == 1, attn_mask)
            half = cat0.shape[0] // 2
            cat1 = torch.cat([cat0[half:], cat0[:half]], 0)
        half = cat0.shape[0] // 2
        return cat0[:half].reshape(-1, h, w, c), cat0[half:].reshape(-1, h, w, c)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """img0/img1 [B, H, W, 3] in 0..255 → flow [B, H, W, 2]."""
        cfg = self.cfg
        dev = img0.device
        mean, std = (torch.from_numpy(a).to(dev) for a in (_MEAN, _STD))
        feats = self.backbone((torch.cat([img0, img1], 0) / 255.0 - mean) / std)[::-1]  # low → high res
        flow = None
        for scale_idx in range(cfg.num_scales):
            f = feats[scale_idx]
            b2 = f.shape[0] // 2
            f0, f1 = f[:b2], f[b2:]
            f0_ori, f1_ori = f0, f1  # the features before the warp and positions (unimatch.py:180)
            h, w = f0.shape[1:3]
            if scale_idx > 0:
                flow = _resize_align_corners(flow, h, w) * 2.0
                f1 = flow_warp(f1, flow)
            splits = cfg.attn_splits_list[scale_idx]
            pos = torch.from_numpy(sine_position(h // splits if splits > 1 else h, w // splits if splits > 1 else w,
                                                 cfg.feature_channels)).to(dev)
            if splits > 1:
                f0 = _merge_windows(_split_windows(f0, splits) + pos, splits, h, w)
                f1 = _merge_windows(_split_windows(f1, splits) + pos, splits, h, w)
            else:
                f0, f1 = f0 + pos, f1 + pos
            f0, f1 = self._transform(f0, f1, h, w, splits)
            radius = cfg.corr_radius_list[scale_idx]
            pred = global_correlation_flow(f0, f1) if radius == -1 else local_correlation_flow(f0, f1, radius)
            flow = pred if flow is None else flow + pred
            flow = self.feature_flow_attn(f0, flow, local_radius=max(cfg.prop_radius_list[scale_idx], 0))
            if scale_idx < cfg.num_scales - 1:
                continue
            if not cfg.reg_refine:
                mask = self.upsampler_conv2(F.relu(self.upsampler_conv1(torch.cat([flow, f0], dim=-1))))
                flow = upsample_flow_with_mask(flow, mask, cfg.upsample_factor)
            else:
                # the flow task's local regression refinement (unimatch.py:345-455):
                # the GRU state restarts from refine_proj each iteration, and
                # the last iteration's mask drives the convex upsample
                proj = self.refine_proj(f0)
                half = proj.shape[-1] // 2
                up_mask = None
                for _ in range(cfg.num_reg_refine):
                    corr = local_correlation_with_flow(f0_ori, f1_ori, flow, radius=4)
                    net, up_mask, dflow = self.refine(torch.tanh(proj[..., :half]), F.relu(proj[..., half:]),
                                                      corr, flow)
                    flow = flow + dflow
                flow = upsample_flow_with_mask(flow, up_mask, cfg.upsample_factor)
        return flow


GMFLOW_CONFIGS = {
    # reference __init__.py:115-158
    "gmflow-scale1": GMFlowConfig(),
    "gmflow-scale2": GMFlowConfig(num_scales=2, upsample_factor=4, attn_splits_list=(2, 8),
                                  corr_radius_list=(-1, 4), prop_radius_list=(-1, 1)),
    "gmflow-scale2-regrefine6": GMFlowConfig(num_scales=2, upsample_factor=4, attn_splits_list=(2, 8),
                                             corr_radius_list=(-1, 4), prop_radius_list=(-1, 1),
                                             reg_refine=True, num_reg_refine=6),
}
# the published file of each configuration
GMFLOW_FILES = {"gmflow-scale1": "gmflow-scale1-mixdata.pth", "gmflow-scale2": "gmflow-scale2-mixdata.pth",
                "gmflow-scale2-regrefine6": "gmflow-scale2-regrefine6-mixdata.pth"}


def convert_gmflow_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """UniMatch's torch state dict → the JAX module's leaf names, torch
    layouts kept (a Linear's ``[out, in]``, a conv's OIHW). Every key is used:
    one the table does not know raises ``KeyError``."""
    out: Dict[str, torch.Tensor] = {}
    used = set()

    def layer(t, j, leaf: Optional[str] = "kernel"):
        used.add(f"{t}.weight")
        out[f"{j}.{leaf}" if leaf else j] = sd[f"{t}.weight"]
        if f"{t}.bias" in sd:
            used.add(f"{t}.bias")
            out[f"{j}.bias"] = sd[f"{t}.bias"]

    layer("backbone.conv1", "backbone.conv1")
    for name in ("layer1", "layer2", "layer3"):
        for bi in range(2):
            t = f"backbone.{name}.{bi}"
            layer(f"{t}.conv1", f"{t}.conv1")
            layer(f"{t}.conv2", f"{t}.conv2")
            if f"{t}.downsample.0.weight" in sd:
                layer(f"{t}.downsample.0", f"{t}.downsample")
    layer("backbone.conv2", "backbone.conv2")
    if "backbone.trident_conv.weight" in sd:
        layer("backbone.trident_conv", "backbone.trident_kernel", leaf=None)
    n_layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("transformer.layers."))
    for i in range(n_layers):
        for part in ("self_attn", "cross_attn_ffn"):
            t, j = f"transformer.layers.{i}.{part}", f"layers.{i}.{part}"
            for p in ("q_proj", "k_proj", "v_proj", "merge", "norm1"):
                layer(f"{t}.{p}", f"{j}.{p}", leaf="kernel" if p != "norm1" else "weight")
            if f"{t}.mlp.0.weight" in sd:
                layer(f"{t}.mlp.0", f"{j}.mlp0")
                layer(f"{t}.mlp.2", f"{j}.mlp2")
                layer(f"{t}.norm2", f"{j}.norm2", leaf="weight")
    layer("feature_flow_attn.q_proj", "feature_flow_attn.q_proj")
    layer("feature_flow_attn.k_proj", "feature_flow_attn.k_proj")
    if "upsampler.0.weight" in sd:
        layer("upsampler.0", "upsampler_conv1")
        layer("upsampler.2", "upsampler_conv2")
    if "refine_proj.weight" in sd:  # the scale2-regrefine6 tier (reg_refine.py)
        layer("refine_proj", "refine_proj")
        for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
            layer(f"refine.encoder.{name}", f"refine.encoder.{name}")
        for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
            layer(f"refine.gru.{name}", f"refine.gru.{name}")
        layer("refine.flow_head.conv1", "refine.flow_head.conv1")
        layer("refine.flow_head.conv2", "refine.flow_head.conv2")
        layer("refine.mask.0", "refine.mask_conv1")
        layer("refine.mask.2", "refine.mask_conv2")
    unknown = sorted(set(sd) - used)
    if unknown:
        raise KeyError(f"GMFlow keys the converter does not know: {unknown[:8]}")
    return out


# -- visualization ---------------------------------------------------------------------


def _make_colorwheel() -> np.ndarray:
    """Middlebury color wheel (utils/flow_viz.py)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    wheel[:RY, 0] = 255
    wheel[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """[H, W, 2] flow → HWC uint8 Middlebury visualisation."""
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    rad_max = max(np.sqrt(u ** 2 + v ** 2).max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = np.sqrt(u ** 2 + v ** 2)
    wheel = _make_colorwheel()
    ncols = wheel.shape[0]
    fk = (np.arctan2(-v, -u) / np.pi + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros((*u.shape, 3), np.uint8)
    idx = rad <= 1
    for i in range(3):
        col0, col1 = wheel[k0, i] / 255.0, wheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., i] = np.floor(255 * col)
    return img


@preprocessor_registry.register("optical_flow", aliases=("unimatch", "UnimatchDetector", "flow", "ptlflow",
                                                         "PTLFlowDetector"))
class OpticalFlowPreprocessor(BasePreprocessor):
    """Frame-pair optical flow colormaps (reference src/preprocess/unimatch
    inference_flow); a frame's output is the flow to the next frame, the
    last frame repeating the one before. Weights: the ``variant``'s
    ``gmflow-*-mixdata.pth`` (or ``<variant>.*``) in the preprocessor models
    dir."""

    name = "optical_flow"
    params_schema = {"variant": "gmflow-scale1", "detect_resolution": 384}
    weights_id = "unimatch"

    def __init__(self, model: Optional[GMFlow] = None, variant: str = "gmflow-scale1"):
        self.model = model
        self.variant = variant
        self._pending = variant

    def setup(self) -> None:
        if self.model is None or self._pending != self.variant:
            from apex_studio_tpu_torch.preprocess.weights import load_detector

            self.variant = variant = self._pending
            self.model = load_detector(lambda: GMFlow(GMFLOW_CONFIGS[variant]), variant, GMFLOW_FILES[variant],
                                       convert_gmflow_keys, self.device)

    def predict_flow(self, frame0: Frame, frame1: Frame, detect_resolution: int = 384) -> np.ndarray:
        """The flow from ``frame0`` to ``frame1`` at the frames' size (float32
        [H, W, 2], in pixels)."""
        import cv2

        h, w = frame0.shape[:2]
        pf = 8 if self.model.cfg.num_scales == 1 else 16
        size = max(pf, int(detect_resolution) // pf * pf)
        dev = next(self.model.parameters()).device
        a, b = (torch.from_numpy(cv2.resize(f, (size, size)).astype(np.float32))[None].to(dev)
                for f in (frame0, frame1))
        with torch.no_grad():
            flow = self.model(a, b)[0].cpu().numpy()
        flow = cv2.resize(flow, (w, h), interpolation=cv2.INTER_LINEAR)
        flow[..., 0] *= w / size
        flow[..., 1] *= h / size
        return flow

    def __call__(self, frames, progress_callback=None, device=None, **params):
        single = isinstance(frames, np.ndarray) and frames.ndim == 3
        batch = [frames] if single else list(frames)
        if len(batch) < 2:
            return [np.zeros_like(batch[0])]
        self.device = device
        self._pending = params.get("variant", self.variant)
        self.setup()
        out = []
        for i in range(len(batch) - 1):
            flow = self.predict_flow(batch[i], batch[i + 1], detect_resolution=params.get("detect_resolution", 384))
            out.append(flow_to_image(flow))
            if progress_callback:
                progress_callback((i + 1) / (len(batch) - 1), f"flow {i + 1}/{len(batch) - 1}")
        out.append(out[-1].copy())
        return out

    def process_frame(self, frame: Frame, **_) -> Frame:  # pragma: no cover
        raise NotImplementedError("optical flow needs frame pairs")
