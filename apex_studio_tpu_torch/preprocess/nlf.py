"""NLF (Neural Localizer Fields) 3-D human body lifting, port of
``apex_studio_tpu/preprocess/nlf.py`` (Flax) to torch.

The 3-D stage behind the ``dwpose_nlf`` preprocessor (wan-scail
conditioning): the reference's multiperson NLF estimator
(``src/preprocess/dwpose_nlf/nlf``), of which the renderer reads the
nonparametric SMPL joints (``joints3d_nonparam``). NHWC at every function,
as in the JAX module, with its attribute names, so ``loaders/from_jax.py``
carries its parameters.

1. linearise the sRGB frame (``multiperson_model.py:1118 im_to_linear``);
2. a perspective crop a detection: the camera turned to look at the box
   centre and zoomed so that the box fills ``proc_side``, a homography warp
   from a 3-level box-filter pyramid (``warp_crop``, a gather on the
   device), gamma 0.8;
3. the crop model: the EfficientNetV2-L trunk (the vendored torchvision
   layout, TF-style fixed padding) → a 1×1 link layer → per-canonical-point
   weights from the GPS localizer field applied as a dynamic 1×1 conv → the
   2.5-D heatmap decode → absolute reconstruction by full-perspective least
   squares (``reconstruct_absolute``);
4. the plausibility filter and pose NMS on the host (numpy, copied);
5. the 24 SMPL joints of the 1048 canonical points.

No attention: nothing here reaches the flash kernel. The crop model is f32
on ``device`` (``None`` is the card) with products in full f32.

Departure: ``load_nlf`` loads strictly (every model parameter from the
checkpoint, on ``meta`` first), where the JAX loader passes
``strict=False``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.preprocess.depth_anything import _lecun, conv2d_nhwc
from apex_studio_tpu_torch.preprocess.efficientnet import BNInf

logger = logging.getLogger("apex.preprocess.nlf")


# ------------------------------------------------------------------ config


@dataclasses.dataclass(frozen=True)
class NLFConfig:
    """nlf_l tier (reference nlf/model_config.yaml)."""

    proc_side: int = 384
    stride: int = 32
    centered_stride: bool = True
    box_size_m: float = 2.2
    depth: int = 8                 # depth bins of the 2.5D heatmap
    backbone_link_dim: int = 512
    field_posenc_dim: int = 1024
    field_hidden_size: int = 384
    gps_pos_enc_dim: int = 512
    gps_hidden_dim: int = 2048
    uncert_bias: float = 0.0
    uncert_bias2: float = 0.001
    backbone_channels: int = 1280
    n_points: int = 1048           # 1024 cano vertices + 24 SMPL joints
    n_joints: int = 24
    # EfficientNetV2 stage table: (fused, expand, kernel, stride, out_ch, repeats), v2_l
    stages: Tuple[Tuple[bool, int, int, int, int, int], ...] = (
        (True, 1, 3, 1, 32, 4),
        (True, 4, 3, 2, 64, 7),
        (True, 4, 3, 2, 96, 7),
        (False, 4, 3, 2, 192, 10),
        (False, 6, 3, 1, 224, 19),
        (False, 6, 3, 2, 384, 25),   # bottomright_stride under centered_stride
        (False, 6, 3, 1, 640, 7),
    )
    stem_ch: int = 32
    bn_eps: float = 1e-3

    @classmethod
    def tiny(cls) -> "NLFConfig":
        """Small variant for tests (same topology, 1-2 blocks per stage)."""
        return cls(
            proc_side=64, stride=32, backbone_link_dim=24,
            field_posenc_dim=32, field_hidden_size=16, gps_pos_enc_dim=16,
            gps_hidden_dim=24, backbone_channels=48, n_points=36, n_joints=24,
            stages=((True, 1, 3, 1, 8, 1), (True, 4, 3, 2, 16, 1),
                    (True, 4, 3, 2, 16, 1), (False, 4, 3, 2, 16, 1),
                    (False, 6, 3, 1, 16, 1), (False, 6, 3, 2, 24, 2),
                    (False, 6, 3, 1, 32, 1)),
            stem_ch=8)


def _tf_same_pad(k: int, shift: int = 0) -> Tuple[Tuple[int, int], ...]:
    """fixed_padding_layer (efficientnet.py:1326): TF-style total pad k-1,
    the smaller half first; ``shift`` moves one row / column of padding to
    the end (bottomright_stride)."""
    beg = (k - 1) // 2
    end = k - 1 - beg
    return ((beg - shift, end + shift), (beg - shift, end + shift))


class _Conv(nn.Module):
    """``nnx.Conv`` with explicit padding: NHWC, ``weight`` OIHW (grouped
    ``[O, I / groups, k, k]``), optional bias."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, *, groups: int = 1, bias: bool = False,
                 pad=0):
        super().__init__()
        self.weight = _lecun(cout, cin // groups, k, k, fan_in=cin // groups * k * k)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.groups = stride, groups
        self.pad = ((pad, pad), (pad, pad)) if isinstance(pad, int) else tuple(pad)

    def forward(self, x):
        return conv2d_nhwc(x, self.weight, self.bias, self.stride, self.pad, groups=self.groups)


class _SqueezeExcite(nn.Module):
    """torchvision SqueezeExcitation: avgpool → fc1 → SiLU → fc2 → sigmoid."""

    def __init__(self, ch: int, squeeze_ch: int):
        super().__init__()
        self.fc1 = _Conv(ch, squeeze_ch, 1, bias=True)
        self.fc2 = _Conv(squeeze_ch, ch, 1, bias=True)

    def forward(self, x):
        s = x.mean(dim=(1, 2), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.silu(self.fc1(s))))


def _make_divisible(v: float, divisor: int) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return int(new_v)


class _FusedMBConv(nn.Module):
    """FusedMBConv (efficientnet.py:207): a padded k×k (expand or plain)
    conv and, when it expands, a 1×1 projection; residual at stride 1 with
    equal widths. BatchRenorm2d at eval time is BN with running statistics."""

    def __init__(self, in_ch, out_ch, expand, k, stride, shift, eps):
        super().__init__()
        mid = _make_divisible(in_ch * expand, 8)
        self.expanded = mid != in_ch
        pad = _tf_same_pad(k, shift)
        if self.expanded:
            self.conv_exp = _Conv(in_ch, mid, k, stride, pad=pad)
            self.bn_exp = BNInf(mid, eps)
            self.conv_proj = _Conv(mid, out_ch, 1)
            self.bn_proj = BNInf(out_ch, eps)
        else:
            self.conv_exp = _Conv(in_ch, out_ch, k, stride, pad=pad)
            self.bn_exp = BNInf(out_ch, eps)
        self.has_skip = stride == 1 and in_ch == out_ch

    def forward(self, x):
        y = F.silu(self.bn_exp(self.conv_exp(x)))
        if self.expanded:
            y = self.bn_proj(self.conv_proj(y))
        return x + y if self.has_skip else y


class _MBConv(nn.Module):
    """MBConv (efficientnet.py:133): 1×1 expand → padded k×k depthwise → SE
    (squeezed to in_ch // 4) → 1×1 projection."""

    def __init__(self, in_ch, out_ch, expand, k, stride, shift, eps):
        super().__init__()
        mid = _make_divisible(in_ch * expand, 8)
        self.conv_exp = _Conv(in_ch, mid, 1)
        self.bn_exp = BNInf(mid, eps)
        self.conv_dw = _Conv(mid, mid, k, stride, groups=mid, pad=_tf_same_pad(k, shift))
        self.bn_dw = BNInf(mid, eps)
        self.se = _SqueezeExcite(mid, max(1, in_ch // 4))
        self.conv_proj = _Conv(mid, out_ch, 1)
        self.bn_proj = BNInf(out_ch, eps)
        self.has_skip = stride == 1 and in_ch == out_ch

    def forward(self, x):
        y = F.silu(self.bn_exp(self.conv_exp(x)))
        y = F.silu(self.bn_dw(self.conv_dw(y)))
        y = self.bn_proj(self.conv_proj(self.se(y)))
        return x + y if self.has_skip else y


class EffNetV2Features(nn.Module):
    """EfficientNetV2 ``features`` in the vendored-torchvision layout: stem →
    stages → 1×1 head conv, every norm with running statistics. The input is
    the linear-light crop in [0, 1]; the model's input layer scales it to
    2x − 1 here."""

    def __init__(self, cfg: NLFConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_stem = _Conv(3, cfg.stem_ch, 3, 2, pad=_tf_same_pad(3))
        self.bn_stem = BNInf(cfg.stem_ch, cfg.bn_eps)
        stages, in_ch = [], cfg.stem_ch
        for si, (fused, e, k, s, out_ch, reps) in enumerate(cfg.stages):
            blocks = []
            for bi in range(reps):
                stride = s if bi == 0 else 1
                # centered_stride sends stage 5's stride-2 block through
                # bottom-right-shifted padding (efficientnet.py:519)
                shift = 1 if (si == 5 and bi == 0 and stride == 2 and cfg.centered_stride) else 0
                cls = _FusedMBConv if fused else _MBConv
                blocks.append(cls(in_ch, out_ch, e, k, stride, shift, cfg.bn_eps))
                in_ch = out_ch
            stages.append(nn.ModuleList(blocks))
        self.blocks = nn.ModuleList(stages)
        self.conv_head = _Conv(in_ch, cfg.backbone_channels, 1)
        self.bn_head = BNInf(cfg.backbone_channels, cfg.bn_eps)

    def forward(self, x):
        """x: (N, H, W, 3) linear [0, 1] → (N, H/32, W/32, C)."""
        x = F.silu(self.bn_stem(self.conv_stem(2.0 * x - 1.0)))
        for stage in self.blocks:
            for block in stage:
                x = block(x)
        return F.silu(self.bn_head(self.conv_head(x)))


# ------------------------------------------------------------ localizer field


class GPSField(nn.Module):
    """GPS localizer field (models/field.py): canonical (x, y, z) → dynamic
    per-point conv weights; the shipped config's "dynamic" norm: min / max
    over the current point set."""

    def __init__(self, cfg: NLFConfig):
        super().__init__()
        c = cfg
        out_dim = (c.backbone_link_dim + 1) * (c.depth + 2)
        self.fourier = nn.Linear(3, c.gps_pos_enc_dim // 2, bias=False)
        self.gps_l1 = nn.Linear(c.gps_pos_enc_dim, c.gps_hidden_dim)
        self.gps_l2 = nn.Linear(c.gps_hidden_dim, c.field_posenc_dim)
        self.r_sqrt_eigva = nn.Parameter(torch.ones(c.field_posenc_dim))
        self.pred_l1 = nn.Linear(c.field_posenc_dim, c.field_hidden_size)
        self.pred_l2 = nn.Linear(c.field_hidden_size, out_dim)
        self.factor = 1.0 / math.sqrt(np.float32(c.gps_pos_enc_dim))
        self.posenc_dim = c.field_posenc_dim
        self.eps = 1e-6

    def forward(self, points):
        """points: (P, 3) → (P, (c + 1)·(depth + 2)) weights."""
        mini, maxi = points.min(dim=0).values, points.max(dim=0).values
        x = (points - (mini + maxi) / 2) / torch.clamp(maxi - mini, min=self.eps)
        f = self.fourier(x)
        x = torch.cat([torch.sin(f), torch.cos(f)], dim=-1) * self.factor
        x = self.gps_l2(F.gelu(self.gps_l1(x)))
        lbo = x[..., :self.posenc_dim] * self.r_sqrt_eigva * 0.1
        return self.pred_l2(F.gelu(self.pred_l1(lbo)))


class NLFCropModel(nn.Module):
    """The single-crop NLF model (models/nlf_model.py NLFModel + LocalizerHead)."""

    def __init__(self, cfg: Optional[NLFConfig] = None):
        super().__init__()
        cfg = cfg or NLFConfig()
        self.cfg = cfg
        self.backbone = EffNetV2Features(cfg)
        self.link_conv = _Conv(cfg.backbone_channels, cfg.backbone_link_dim, 1)
        self.link_bn = BNInf(cfg.backbone_link_dim, cfg.bn_eps)
        self.field = GPSField(cfg)
        # the canonical point cloud (1024 vertices + 24 joints), the
        # checkpoint's cano_all_smpl
        self.canonical = nn.Parameter(torch.zeros(cfg.n_points, 3))

    def field_weights(self, points=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(P, C_out, c_in) kernel + (P, C_out) bias of the dynamic 1×1 conv
        (nlf_model.py:232 transpose_weights)."""
        pts = self.canonical if points is None else points
        raw = self.field(pts)
        c_in, c_out = self.cfg.backbone_link_dim, self.cfg.depth + 2
        resh = raw.reshape(pts.shape[0], c_in + 1, c_out)
        return resh[:, :-1, :].permute(0, 2, 1), resh[:, -1, :]

    def decode(self, feats, w, b):
        """feats: (N, h, w, c_link) link-layer output → coords2d (N, P, 2)
        px, coords3d (N, P, 3) m, uncertainties (N, P)."""
        cfg = self.cfg
        n, fh, fw, _ = feats.shape
        p = w.shape[0]
        # dynamic 1×1 conv: (N, h, w, c) × (P, C, c) → (N, P, C, h, w)
        logits = (torch.einsum("nhwc,pkc->npkhw", feats, w) + b[None, :, :, None, None]).float()
        uncert_map = logits[:, :, 0]
        xy_soft = _soft_argmax_2d(logits[:, :, 1])
        heat = torch.softmax(logits[:, :, 2:].reshape(n, p, -1), dim=-1).reshape(n, p, cfg.depth, fh, fw)
        uncert = torch.einsum("nphw,nphw->np", uncert_map, heat.sum(dim=2))
        uncert = F.softplus(uncert + cfg.uncert_bias) + cfg.uncert_bias2
        coords25d = _decode_heatmap_3d(heat)      # (N, P, 3): x, y, z in [0, 1]
        coords2d = _heatmap_to_image(coords25d[..., :2], cfg)
        xy_metric = _heatmap_to_image(xy_soft, cfg) * cfg.box_size_m / cfg.proc_side
        coords3d = torch.cat([xy_metric, coords25d[..., 2:] * cfg.box_size_m], dim=-1)
        return coords2d, coords3d, uncert

    def forward(self, crops, w, b, intrinsics):
        """crops (N, S, S, 3) linear [0, 1] → absolute (N, P, 3) mm and
        uncertainties (N, P) (nlf_model.py:72 predict_multi_same_canonicals)."""
        feats = F.silu(self.link_bn(self.link_conv(self.backbone(crops))))
        coords2d, coords3d, uncert = self.decode(feats, w, b)
        abs3d = reconstruct_absolute(coords2d, coords3d, uncert, intrinsics, self.cfg)
        return abs3d, uncert * 3.0   # fix_uncert_factor false → ×3


def _linspace(n: int, like) -> torch.Tensor:
    return torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=like.device)


def _soft_argmax_2d(logits):
    """(..., h, w) → (..., 2) soft-argmax in [0, 1] × [0, 1] (x, then y)."""
    *lead, h, w = logits.shape
    p = torch.softmax(logits.reshape(*lead, h * w), dim=-1).reshape(*lead, h, w)
    x = (p.sum(dim=-2) * _linspace(w, p)).sum(dim=-1)
    y = (p.sum(dim=-1) * _linspace(h, p)).sum(dim=-1)
    return torch.stack([x, y], dim=-1)


def _decode_heatmap_3d(heat):
    """(N, P, D, h, w) normalised heatmap → (N, P, 3) expected (x, y, z) in
    [0, 1] (ptu.decode_heatmap over dims [4, 3, 2])."""
    _, _, d, h, w = heat.shape
    zs = _linspace(d, heat) if d > 1 else torch.full((1,), 0.5, device=heat.device)
    x = torch.einsum("npdhw,w->np", heat, _linspace(w, heat))
    y = torch.einsum("npdhw,h->np", heat, _linspace(h, heat))
    z = torch.einsum("npdhw,d->np", heat, zs)
    return torch.stack([x, y, z], dim=-1)


def _heatmap_to_image(coords, cfg: NLFConfig):
    """[0, 1] heatmap coordinates → pixel coordinates (models/util.py:5)."""
    last = cfg.proc_side - 1
    out = coords * (last - (last % cfg.stride))
    return out + cfg.stride // 2 if cfg.centered_stride else out


# --------------------------------------------------- absolute reconstruction


def _is_within_fov(imcoords, cfg: NLFConfig, border: float):
    offset = 0.0 if cfg.centered_stride else -cfg.stride / 2.0
    lower = cfg.stride * border + offset
    upper = cfg.proc_side - cfg.stride * border + offset
    return ((imcoords >= lower) & (imcoords <= upper)).all(dim=-1)


def reconstruct_ref_fullpersp(norm2d, rel3d, valid):
    """The least-squares reference point (ptu3d.py:112
    reconstruct_ref_fullpersp): t such that norm2d·(z_rel + t_z) ≈ xy_rel +
    t_xy in a weighted least-squares sense, by the regularised normal
    equations."""
    nb, npt, _ = norm2d.shape
    v = valid[..., None].to(norm2d.dtype)

    def _rms_norm(x):
        # ptu.rms_normalize_and_reshape: the mean of x² over both coordinate
        # dims, divided by the count of valid points
        num = (x.square() * v).sum(dim=(1, 2), keepdim=True)
        cnt = v.sum(dim=(1, 2), keepdim=True)
        scale = torch.sqrt(torch.nan_to_num(num / torch.where(cnt == 0, 1.0, cnt)) + 1e-10)
        return scale, (x / scale).reshape(nb, npt * 2, 1)

    eyes = torch.eye(2, dtype=norm2d.dtype, device=norm2d.device)[None].repeat(nb, npt, 1)
    scale2d, resh2d = _rms_norm(norm2d)
    a_mat = torch.cat([eyes, -resh2d], dim=2)                  # (nb, 2P, 3)
    scale_rb, b_vec = _rms_norm(norm2d * rel3d[:, :, 2:] - rel3d[:, :, :2])
    wts = (valid.to(norm2d.dtype) + 1e-8).repeat_interleave(2, dim=1)[..., None]  # (nb, 2P, 1)
    aw = wts * a_mat
    gram = torch.einsum("bni,bnj->bij", aw, a_mat) + 1e-4 * torch.eye(3, dtype=norm2d.dtype, device=norm2d.device)
    atb = torch.einsum("bni,bnj->bij", aw, b_vec)
    ref = torch.linalg.solve(gram, atb)[..., 0]                # (nb, 3)
    scale_rb, scale2d = scale_rb[:, 0, 0], scale2d[:, 0, 0]
    return torch.cat([ref[:, :2] * scale_rb[:, None], ref[:, 2:] * (scale_rb / scale2d)[:, None]], dim=1)


def reconstruct_absolute(coords2d, coords3d, uncert, intrinsics, cfg: NLFConfig):
    """ptu3d.reconstruct_absolute with the LocalizerHead's fixed arguments
    (nlf_model.py:365): border factors (1.0, 0.6), mix 0.5, full
    perspective, valid where the uncertainty is below 0.3. Returns mm."""
    intrinsics = intrinsics.to(coords2d.dtype)
    homog = torch.cat([coords2d, torch.ones_like(coords2d[..., :1])], dim=-1)
    norm2d = torch.einsum("bnk,bjk->bnj", homog, torch.linalg.inv(intrinsics))[..., :2]
    ref = reconstruct_ref_fullpersp(norm2d, coords3d, _is_within_fov(coords2d, cfg, 1.0) & (uncert < 0.3))

    abs_3d = coords3d + ref[:, None, :]
    z = coords3d[..., 2] + ref[:, None, 2]
    abs_2d = torch.cat([norm2d, torch.ones_like(norm2d[..., :1])], dim=-1) * z[..., None]
    abs_2d = 0.5 * abs_3d + 0.5 * abs_2d                       # mix_3d_inside_fov
    proj = abs_3d / torch.clamp(abs_3d[..., 2:], min=0.1)
    proj = torch.einsum("bnk,bjk->bnj", proj, intrinsics[..., :2, :])
    in_fov2 = _is_within_fov(proj, cfg, 0.6) & (abs_3d[..., 2] > 0.001)
    return torch.where(in_fov2[..., None], abs_2d, abs_3d) * 1000.0


# ----------------------------------------------------------- crop extraction


def intrinsics_from_fov(h: int, w: int, fov_degrees: float = 55.0) -> np.ndarray:
    """ptu3d.intrinsic_matrix_from_field_of_view (the principal point at the
    pixel-centre convention (size - 1) / 2)."""
    focal = max(h, w) / (np.tan(np.deg2rad(fov_degrees) / 2) * 2)
    return np.array([[focal, 0, (w - 1) / 2], [0, focal, (h - 1) / 2], [0, 0, 1]], np.float32)


def _lookat(forward: np.ndarray, up: np.ndarray) -> np.ndarray:
    """ptu3d.lookat_matrix for one vector."""
    new_z = forward / np.linalg.norm(forward)
    new_x = np.cross(new_z, up)
    if np.linalg.norm(new_x) == 0:
        new_x = np.array([new_z[2], 0.0, -new_z[0]], np.float32)
    new_x = new_x / np.linalg.norm(new_x)
    new_y = np.cross(new_z, new_x)
    return np.stack([new_x, new_y, new_z], axis=0).astype(np.float32)


def crop_transforms(boxes: np.ndarray, intrinsics: np.ndarray, proc_side: int, aug_scale: float = 1.0
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-box camera reorientation (multiperson_model.py:889
    _get_new_rotation_and_scale): the rotation looking at the box centre and
    the zoom that makes the reprojected box fill ``proc_side``. boxes: (B,
    4+) pixel (x, y, w, h[, score]) → (R (B, 3, 3), new_K (B, 3, 3),
    crop_scales (B,))."""
    up = np.array([0, -1, 0], np.float32)
    inv_k = np.linalg.inv(intrinsics)
    rs, ks, scales = [], [], []
    for box in boxes:
        x, y, w, h = [float(v) for v in box[:4]]
        pts = np.array([[x + w / 2, y + h / 2, 1], [x + w / 2, y, 1], [x + w, y + h / 2, 1],
                        [x + w / 2, y + h, 1], [x, y + h / 2, 1]], np.float32)
        cam = pts @ inv_k.T
        r = _lookat(cam[0], up)
        side = cam[1:5] @ (intrinsics @ r).T
        side = side[:, :2] / side[:, 2:]
        size = max(np.linalg.norm(side[0] - side[2]), np.linalg.norm(side[1] - side[3]))
        scale = proc_side / size * aug_scale
        new_k = np.array([[intrinsics[0, 0] * scale, 0, proc_side / 2],
                          [0, intrinsics[1, 1] * scale, proc_side / 2], [0, 0, 1]], np.float32)
        rs.append(r)
        ks.append(new_k)
        scales.append(scale)
    return (np.stack(rs).astype(np.float32), np.stack(ks).astype(np.float32), np.asarray(scales, np.float32))


def _corner_scale_mat(factor: float) -> np.ndarray:
    shift = (factor - 1.0) / 2.0
    return np.array([[factor, 0, shift], [0, factor, shift], [0, 0, 1]], np.float32)


def warp_crop(image, intrinsics: np.ndarray, new_invprojmat: np.ndarray, out_side: int):
    """Homography warp (warping.py:72 warp_single_image): a bilinear sample
    with align-corners semantics and zero padding, gathered on ``image``'s
    device. image: (H, W, 3) float."""
    ih, iw = image.shape[:2]
    dev = image.device
    ar = torch.arange(out_side, dtype=torch.float32, device=dev)
    ys, xs = torch.meshgrid(ar, ar, indexing="ij")
    new_h = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    old = new_h @ torch.as_tensor(new_invprojmat, dtype=torch.float32, device=dev).T
    old = old[..., :2] / old[..., 2:]
    old = torch.cat([old, torch.ones_like(old[..., :1])], dim=-1)
    old = (old @ torch.as_tensor(intrinsics, dtype=torch.float32, device=dev).T)[..., :2]
    x, y = old[..., 0], old[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]

    def _gather(yy, xx):
        ok = (xx >= 0) & (xx <= iw - 1) & (yy >= 0) & (yy <= ih - 1)
        xi = torch.clamp(xx, 0, iw - 1).long()
        yi = torch.clamp(yy, 0, ih - 1).long()
        return image[yi, xi] * ok[..., None]

    return ((1 - wy) * ((1 - wx) * _gather(y0, x0) + wx * _gather(y0, x0 + 1))
            + wy * ((1 - wx) * _gather(y0 + 1, x0) + wx * _gather(y0 + 1, x0 + 1)))


def extract_crops(image_linear, boxes: np.ndarray, intrinsics: np.ndarray, proc_side: int,
                  gamma: float = 0.8) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """The crop path for one image: the pyramid level, the homography warp
    and the TTA gamma (multiperson_model.py:786 _get_crops, num_aug = 1).
    Returns (crops (B, S, S, 3), new_K (B, 3, 3), R (B, 3, 3))."""
    r, new_k, scales = crop_transforms(boxes, intrinsics, proc_side)
    # a 3-level box-filter pyramid; a crop's level = clip(floor(-log2(s)), 0, 2)
    levels = [image_linear]
    for _ in range(2):
        im = levels[-1]
        h2, w2 = (im.shape[0] // 2) * 2, (im.shape[1] // 2) * 2
        levels.append(im[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2, 3).mean(dim=(1, 3)))
    ilevel = np.clip(np.floor(-np.log2(scales)), 0, 2).astype(np.int32)
    crops = []
    for i in range(len(boxes)):
        li = int(ilevel[i])
        k_level = _corner_scale_mat(1 / 2 ** li) @ intrinsics
        invproj = np.linalg.inv(new_k[i] @ r[i])
        crops.append(warp_crop(levels[li], k_level, invproj, proc_side))
    return torch.stack(crops) ** (gamma / 2.2), new_k, r


# --------------------------------------------------------------- plausibility


def is_uncertainty_low(uncert: np.ndarray) -> np.ndarray:
    return np.mean((uncert < 0.25).astype(np.float32), axis=-1) > 1 / 3


def is_pose_consistent_with_box(pose2d: np.ndarray, box: np.ndarray) -> np.ndarray:
    start = pose2d.min(axis=-2)
    end = pose2d.max(axis=-2)
    b0 = box[..., :2]
    b1 = box[..., :2] + box[..., 2:4]
    area = np.prod(box[..., 2:4], axis=-1)
    inter = np.prod(np.maximum(np.minimum(b1, end) - np.maximum(b0, start), 0), axis=-1)
    return inter > 0.25 * area


def pose_nms(poses3d: np.ndarray, scores: np.ndarray, valid: np.ndarray,
             overlap_threshold: float = 0.4) -> np.ndarray:
    """plausibility_check.pose_non_max_suppression."""
    idx = np.flatnonzero(valid)
    if idx.size == 0:
        return idx
    poses = poses3d[idx]
    sq = np.mean(np.square(poses), axis=(-2, -1), keepdims=True)
    ms = (sq[None, :] + sq[:, None]) / 2
    f1 = np.sqrt(ms / sq[None, :])
    f2 = np.sqrt(ms / sq[:, None])
    dists = np.linalg.norm(f1 * poses[None] - f2 * poses[:, None], axis=-1)
    k = max(1, poses.shape[-2] // 5)
    best = np.sort(dists, axis=-1)[..., :k]
    overlaps = np.mean(np.maximum(1 - best / 300, 0), axis=-1)

    order = np.argsort(-scores[idx], kind="stable")
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        order = rest[overlaps[i, rest] <= overlap_threshold]
    return idx[np.asarray(keep, np.int64)]


# ------------------------------------------------------------------ estimator


class NLFEstimator:
    """Multi-person nonparametric NLF estimation (the consumed part of
    MultipersonNLF.detect_smpl_batched). The boxes come from the caller (the
    dwpose_nlf preprocessor's DWPose person boxes, as in JAX). The crop
    model runs where its parameters are."""

    def __init__(self, model: NLFCropModel):
        self.model = model
        self._w, self._b = None, None

    @property
    def device(self) -> torch.device:
        return self.model.canonical.device

    def _weights(self):
        if self._w is None:
            with torch.no_grad():
                self._w, self._b = self.model.field_weights()
        return self._w, self._b

    @torch.no_grad()
    def estimate(self, image_rgb: np.ndarray, boxes: np.ndarray) -> List[np.ndarray]:
        """image: (H, W, 3) uint8; boxes: (B, 5) pixel (x, y, w, h, score).
        Returns each surviving person's (24, 3) camera-space joints in mm."""
        if len(boxes) == 0:
            return []
        cfg = self.model.cfg
        h, w = image_rgb.shape[:2]
        k = intrinsics_from_fov(h, w)
        linear = (torch.as_tensor(np.asarray(image_rgb), device=self.device).float() / 255.0) ** 2.2
        crops, new_k, r = extract_crops(linear, boxes, k, cfg.proc_side)
        w_t, b_t = self._weights()
        poses, uncert = self.model(crops, w_t, b_t, torch.as_tensor(new_k, device=self.device))
        poses = poses.cpu().numpy().astype(np.float64) @ np.asarray(r, np.float64)
        uncert = uncert.cpu().numpy()

        # plausibility filter + NMS (multiperson_model.py:633 _filter_poses)
        proj = poses / np.maximum(poses[..., 2:], 0.1)
        pose2d = np.einsum("bnk,jk->bnj", proj.astype(np.float32), k[:2, :])
        valid = is_uncertainty_low(uncert) & is_pose_consistent_with_box(pose2d, boxes[:, :4])
        scores = boxes[:, 4] if boxes.shape[1] > 4 else np.ones(len(boxes))
        keep = pose_nms(poses.astype(np.float32), scores / np.mean(uncert, axis=-1), valid)
        return [poses[i, cfg.n_points - cfg.n_joints:, :].astype(np.float32) for i in keep]


# -------------------------------------------------------------- weight loading


def _nlf_key_pairs(cfg: NLFConfig) -> List[Tuple[str, str]]:
    """(module path under the JAX leaf names, published key without its
    ``crop_model.`` prefix) of every parameter. The trunk's keys follow the
    vendored torchvision Sequential ``backbone.1.<i>…`` (the model wraps
    [PreprocLayer, features]); a fused block without expansion has no
    projection."""
    pairs: List[Tuple[str, str]] = []

    def conv(dst: str, src: str, bias: bool = False) -> None:
        pairs.append((f"{dst}.kernel", f"{src}.weight"))
        if bias:
            pairs.append((f"{dst}.bias", f"{src}.bias"))

    def bn(dst: str, src: str) -> None:
        pairs.extend((f"{dst}.{ours}", f"{src}.{theirs}") for ours, theirs in (
            ("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"), ("var", "running_var")))

    f = "backbone.1"
    conv("backbone.conv_stem", f"{f}.0.0")
    bn("backbone.bn_stem", f"{f}.0.1")
    in_ch = cfg.stem_ch
    for si, (fused, e, _k, _s, out_ch, reps) in enumerate(cfg.stages):
        for bi in range(reps):
            src, dst = f"{f}.{si + 1}.{bi}.block", f"backbone.blocks.{si}.{bi}"
            conv(f"{dst}.conv_exp", f"{src}.0.0")
            bn(f"{dst}.bn_exp", f"{src}.0.1")
            if not fused:
                conv(f"{dst}.conv_dw", f"{src}.1.0")
                bn(f"{dst}.bn_dw", f"{src}.1.1")
                conv(f"{dst}.se.fc1", f"{src}.2.fc1", bias=True)
                conv(f"{dst}.se.fc2", f"{src}.2.fc2", bias=True)
                conv(f"{dst}.conv_proj", f"{src}.3.0")
                bn(f"{dst}.bn_proj", f"{src}.3.1")
            elif _make_divisible(in_ch * e, 8) != in_ch:
                conv(f"{dst}.conv_proj", f"{src}.1.0")
                bn(f"{dst}.bn_proj", f"{src}.1.1")
            in_ch = out_ch
    conv("backbone.conv_head", f"{f}.{len(cfg.stages) + 1}.0")
    bn("backbone.bn_head", f"{f}.{len(cfg.stages) + 1}.1")
    conv("link_conv", "heatmap_head.layer.0")
    bn("link_bn", "heatmap_head.layer.1")
    wf = "heatmap_head.weight_field"
    conv("field.fourier", f"{wf}.gps_net.learnable_fourier.linear")
    for dst, src in (("gps_l1", "gps_net.mlp.0"), ("gps_l2", "gps_net.mlp.2"), ("pred_l1", "pred_mlp.0"),
                     ("pred_l2", "pred_mlp.2")):
        conv(f"field.{dst}", f"{wf}.{src}", bias=True)
    pairs += [("field.r_sqrt_eigva", f"{wf}.r_sqrt_eigva"), ("canonical", "cano_all_smpl")]
    return pairs


def convert_nlf_checkpoint(sd: Dict[str, torch.Tensor], cfg: Optional[NLFConfig] = None
                           ) -> Dict[str, torch.Tensor]:
    """The published ``nlf_l_multi`` safetensors (MultipersonNLF's state
    dict, the crop model under ``crop_model.``) → :class:`NLFCropModel`
    paths (JAX leaf names, torch layouts), as the JAX converter maps them."""
    pre = "crop_model."
    sd = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)} | {
        k: v for k, v in sd.items() if not k.startswith(pre)}
    return {dst: sd[src] for dst, src in _nlf_key_pairs(cfg or NLFConfig())}


def nlf_published_state_dict(model: NLFCropModel) -> Dict[str, torch.Tensor]:
    """``model``'s parameters under the published names (``crop_model.``
    prefixed): the inverse of ``convert_nlf_checkpoint``."""
    from apex_studio_tpu_torch.loaders.state_mapping import port_path

    state = model.state_dict()
    return {f"crop_model.{src}": state[port_path(dst)] for dst, src in _nlf_key_pairs(model.cfg)}


def load_nlf(path, device=None, cfg: Optional[NLFConfig] = None) -> NLFEstimator:
    """The estimator (l tier unless ``cfg``) from a checkpoint file, built on
    ``meta`` and filled strictly on ``device`` (``None`` is the card)."""
    from apex_studio_tpu_torch.device import resolve_device
    from apex_studio_tpu_torch.engine.base import configure_float32_matmul
    from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict
    from apex_studio_tpu_torch.preprocess.weights import _load_any

    configure_float32_matmul()
    sd = _load_any(Path(path))
    dev = resolve_device(device)
    with torch.device("meta"):
        model = NLFCropModel(cfg)
    apply_state_dict(model, convert_nlf_checkpoint(sd, cfg), device=dev, strict=True)
    return NLFEstimator(model.eval().requires_grad_(False))
