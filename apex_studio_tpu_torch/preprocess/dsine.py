"""DSINE surface normals (port of ``apex_studio_tpu/preprocess/dsine.py``):
the EfficientNet-B5 encoder, the ray-conditioned decoder and the iterative
neighbourhood-rotation refinement with a ConvGRU state, NHWC at every
function as in the JAX module and with its attribute names
(``loaders/from_jax.py`` carries its parameters); the published ``dsine.pt``
loads through ``convert_dsine_keys`` strictly.

- ``_resize_half_pixel`` is ``jax.image.resize(..., "linear")``, which
  antialiases when it shrinks: it runs ``utils/jax_resize.py``, not
  ``F.interpolate``.
- ``ConvWS`` standardises its kernel per output filter (Bessel-corrected
  std + 1e-5); ``GroupNorm8`` normalises 8 groups in f32 with eps 1e-5.
- ``refine`` runs ``num_iter`` times: the GRU state, the neighbour
  probabilities, the axis / angle rotation of each 5×5 neighbour's normal
  into the centre pixel's tangent frame (``axis_angle_to_matrix``), the ray
  ReLU, then the convex 8× upsample.

The network runs in f32 on ``device`` (``None`` is the card); the cv2
resizes, the zero pad to a multiple of 64 and the intrinsics from the field
of view (``get_intrins_from_fov``) stay on the host, as in JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_anything import conv2d_nhwc
from apex_studio_tpu_torch.preprocess.efficientnet import (
    EffNetConfig,
    EfficientNetFeatures,
    SameConv,
    convert_timm_efficientnet,
)
from apex_studio_tpu_torch.preprocess.normalbae import _pad64, normalize_imagenet
from apex_studio_tpu_torch.utils.jax_resize import resize as jax_resize


def _resize_half_pixel(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, h, w, C), "linear")``: half-pixel centres,
    antialiased when it shrinks."""
    return jax_resize(x, (x.shape[0], h, w, x.shape[-1]), "linear")


def _normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize written as the JAX module writes it: x / max(‖x‖, eps)."""
    n = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """axis·angle (..., 3) → rotation matrices (..., 3, 3) via quaternions
    (the PyTorch3D formulation with its small-angle series)."""
    angles = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = angles * 0.5
    small = torch.abs(angles) < 1e-6
    sin_half_over = torch.where(small, 0.5 - (angles * angles) / 48,
                                torch.sin(half) / torch.where(small, torch.ones_like(angles), angles))
    quat = torch.cat([torch.cos(half), axis_angle * sin_half_over], dim=-1)
    r, i, j, k = torch.movedim(quat, -1, 0)
    two_s = 2.0 / torch.sum(quat * quat, dim=-1)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(axis_angle.shape[:-1] + (3, 3))


def get_unfold(x: torch.Tensor, ps: int, pad: int) -> torch.Tensor:
    """NHWC → (B, H, W, ps·ps, C) neighbourhoods with replicate pad."""
    xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="replicate").permute(0, 2, 3, 1)
    h, w = x.shape[1], x.shape[2]
    return torch.stack([xp[:, dy:dy + h, dx:dx + w, :] for dy in range(ps) for dx in range(ps)], dim=3)


def convex_upsample(out: torch.Tensor, up_mask: torch.Tensor, k: int) -> torch.Tensor:
    """(B,H,W,C) low-res + (B,H,W,9·k·k) mask → (B,kH,kW,C): replicate pad,
    3×3 unfold, softmax over the 9 neighbours."""
    b, h, w, c = out.shape
    mask = torch.softmax(up_mask.reshape(b, h, w, 9, k, k), dim=3)
    nb = get_unfold(out, ps=3, pad=1)  # (B, H, W, 9, C)
    up = torch.einsum("bhwnkl,bhwnc->bhwklc", mask, nb)
    up = up.permute(0, 1, 3, 2, 4, 5)  # (B, H, k, W, l, C)
    return up.reshape(b, h * k, w * k, c)


class ConvGRU(nn.Module):
    def __init__(self, hidden: int, inp: int, ks: int):
        super().__init__()
        self.convz, self.convr, self.convq = (SameConv(hidden + inp, hidden, ks, use_bias=True) for _ in range(3))

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=-1)))
        return (1 - z) * h + z * q


def ray_relu(pred_norm: torch.Tensor, ray: torch.Tensor, eps: float = 1e-2) -> torch.Tensor:
    """Clamp the along-ray component to ≥ eps (submodules RayReLU)."""
    cos = torch.sum(_normalize(pred_norm) * _normalize(ray), dim=-1, keepdim=True)
    diff = ray * (F.relu(cos - eps) + eps) - ray * cos
    return _normalize(pred_norm + diff)


class ConvWS(nn.Module):
    """Weight-standardized 3×3 conv (submodules Conv2d_WS): per-filter mean
    subtraction and std division (torch .std = Bessel-corrected)."""

    def __init__(self, in_ch: int, out: int):
        super().__init__()
        self.conv = SameConv(in_ch, out, 3, use_bias=True)

    def forward(self, x):
        w = self.conv.weight  # OIHW
        wc = w - w.mean(dim=(1, 2, 3), keepdim=True)
        n = w.shape[1] * w.shape[2] * w.shape[3]
        std = torch.sqrt(torch.sum(wc * wc, dim=(1, 2, 3), keepdim=True) / max(n - 1, 1)) + 1e-5
        return conv2d_nhwc(x, wc / std, self.conv.bias, 1, 1)


class GroupNorm8(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.groups = min(8, ch)

    def forward(self, x):
        b, h, w, c = x.shape
        xg = x.reshape(b, h, w, self.groups, c // self.groups)
        mean = xg.mean(dim=(1, 2, 4), keepdim=True)
        var = xg.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
        xg = (xg - mean) * torch.rsqrt(var + 1e-5)
        return xg.reshape(b, h, w, c) * self.scale + self.bias


class UpSampleGN(nn.Module):
    """ConvWS → GN → LeakyReLU twice after a half-pixel bilinear upsample and
    concat (align_corners=False in the DSINE decoder)."""

    def __init__(self, skip_input: int, out: int):
        super().__init__()
        self.conv_a = ConvWS(skip_input, out)
        self.gn_a = GroupNorm8(out)
        self.conv_b = ConvWS(out, out)
        self.gn_b = GroupNorm8(out)

    def forward(self, x, skip):
        x = _resize_half_pixel(x, skip.shape[1], skip.shape[2])
        x = torch.cat([x, skip], dim=-1)
        x = F.leaky_relu(self.gn_a(self.conv_a(x)), 0.01)
        return F.leaky_relu(self.gn_b(self.conv_b(x)), 0.01)


class PredHead(nn.Module):
    """conv3x3 → ReLU → conv1x1 → ReLU → conv1x1 (get_prediction_head)."""

    def __init__(self, in_ch: int, hidden: int, out: int):
        super().__init__()
        self.c0 = SameConv(in_ch, hidden, 3, use_bias=True)
        self.c1 = SameConv(hidden, hidden, 1, use_bias=True)
        self.c2 = SameConv(hidden, out, 1, use_bias=True)

    def forward(self, x):
        return self.c2(F.relu(self.c1(F.relu(self.c0(x)))))


class DSINE(nn.Module):
    PS = 5
    DOWN = 8

    def __init__(self, cfg: Optional[EffNetConfig] = None, num_iter: int = 5):
        super().__init__()
        cfg = cfg or EffNetConfig.b5()
        self.num_iter = num_iter
        self.encoder = EfficientNetFeatures(cfg)
        ch = self.encoder.feature_channels()
        nf = cfg.head_ch
        fdim, hdim = 64, 64
        self.conv2 = SameConv(nf + 2, nf, 1, use_bias=True)
        self.up1 = UpSampleGN(nf + ch[7] + 2, nf // 2)
        self.up2 = UpSampleGN(nf // 2 + ch[5] + 2, nf // 4)
        i_dim = nf // 4
        self.normal_head = PredHead(i_dim + 2, 128, 3)
        self.feature_head = PredHead(i_dim + 2, 128, fdim)
        self.hidden_head = PredHead(i_dim + 2, 128, hdim)
        self.gru = ConvGRU(hdim, fdim + 2, self.PS)
        ps2 = self.PS * self.PS
        self.prob_head = PredHead(hdim + 2, 64, ps2)
        self.xy_head = PredHead(hdim + 2, 64, ps2 * 2)
        self.angle_head = PredHead(hdim + 2, 64, ps2)
        self.up_prob_head = PredHead(hdim + 2, 64, 9 * self.DOWN * self.DOWN)

    # -- camera geometry ---------------------------------------------------

    @staticmethod
    def _pixel_coords(h: int, w: int, device) -> torch.Tensor:
        """(H, W, 2) pixel centres (x+0.5, y+0.5)."""
        xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
        ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
        gx, gy = torch.meshgrid(xs, ys, indexing="xy")
        return torch.stack([gx, gy], dim=-1)

    @staticmethod
    def _scaled_intrins(intrins, H, W, orig_H, orig_W):
        fu = intrins[:, 0, 0] * (W / orig_W)
        cu = intrins[:, 0, 2] * (W / orig_W)
        fv = intrins[:, 1, 1] * (H / orig_H)
        cv = intrins[:, 1, 2] * (H / orig_H)
        return fu, cu, fv, cv

    def get_uv(self, intrins, H, W, orig_H, orig_W) -> torch.Tensor:
        fu, cu, fv, cv = self._scaled_intrins(intrins, H, W, orig_H, orig_W)
        pc = self._pixel_coords(H, W, intrins.device)[None]
        u = (pc[..., 0] - cu[:, None, None]) / fu[:, None, None]
        v = (pc[..., 1] - cv[:, None, None]) / fv[:, None, None]
        return torch.stack([u, v], dim=-1)  # (B, H, W, 2)

    def get_ray(self, intrins, H, W, orig_H, orig_W) -> torch.Tensor:
        uv = self.get_uv(intrins, H, W, orig_H, orig_W)
        return _normalize(torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1))

    # -- refinement --------------------------------------------------------

    def refine(self, h, feat_map, pred_norm, intrins, orig_H, orig_W, uv_8, ray_8):
        ps, ps2 = self.PS, self.PS * self.PS
        pad = (ps - 1) // 2
        B, H, W, _ = pred_norm.shape
        fu, cu, fv, cv = (t[:, None, None, None] for t in self._scaled_intrins(intrins, H, W, orig_H, orig_W))

        h_new = self.gru(h, feat_map)
        hx = torch.cat([h_new, uv_8], dim=-1)

        nghbr_prob = torch.sigmoid(self.prob_head(hx))           # (B,H,W,ps2)
        nghbr_normals = get_unfold(pred_norm, ps, pad)           # (B,H,W,ps2,3)

        xys = self.xy_head(hx)                                   # (B,H,W,2*ps2)
        xy = _normalize(torch.stack([xys[..., :ps2], xys[..., ps2:]], dim=-1))  # (B,H,W,ps2,2)
        angle = torch.sigmoid(self.angle_head(hx))[..., None] * math.pi

        pix = get_unfold(torch.cat([self._pixel_coords(H, W, hx.device)[None],
                                    torch.ones((1, H, W, 1), dtype=torch.float32, device=hx.device)], dim=-1),
                         ps, pad)                                # (1,H,W,ps2,3)

        du_over_fu = xy[..., 0] / fu
        dv_over_fv = xy[..., 1] / fv
        term_u = (pix[..., 0] + xy[..., 0] - cu) / fu
        term_v = (pix[..., 1] + xy[..., 1] - cv) / fv
        nx, ny, nz = nghbr_normals[..., 0], nghbr_normals[..., 1], nghbr_normals[..., 2]
        num = -(du_over_fu * nx + dv_over_fv * ny)
        den = term_u * nx + term_v * ny + nz
        den = torch.where(torch.abs(den) < 1e-8, 1e-8 * torch.where(den >= 0, 1.0, -1.0), den)
        dz = num / den
        axes = _normalize(torch.stack([du_over_fu + dz * term_u, dv_over_fv + dz * term_v, dz], dim=-1))
        invalid = torch.any(~torch.isfinite(axes), dim=-1, keepdim=True)
        axes = torch.where(invalid, 0.0, axes)

        R = axis_angle_to_matrix(axes * angle)                   # (B,H,W,ps2,3,3)
        rot = _normalize(torch.einsum("bhwpij,bhwpj->bhwpi", R, nghbr_normals))
        rot = ray_relu(rot, ray_8[:, :, :, None, :])
        new_norm = _normalize(torch.sum(nghbr_prob[..., None] * rot, dim=3))

        up_mask = self.up_prob_head(hx)
        up_norm = _normalize(convex_upsample(new_norm, up_mask, self.DOWN))
        return h_new, new_norm, up_norm

    def forward(self, img, intrins):
        """img NHWC (normalized), intrins (B, 3, 3) — cx/cy already shifted
        by +0.5 (dsine_arch.py:270). Returns (B, H, W, 3) unit normals."""
        feats = self.encoder(img)
        _, orig_H, orig_W, _ = img.shape
        uv_32 = self.get_uv(intrins, orig_H // 32, orig_W // 32, orig_H, orig_W)
        uv_16 = self.get_uv(intrins, orig_H // 16, orig_W // 16, orig_H, orig_W)
        uv_8 = self.get_uv(intrins, orig_H // 8, orig_W // 8, orig_H, orig_W)
        ray_8 = self.get_ray(intrins, orig_H // 8, orig_W // 8, orig_H, orig_W)

        x_d0 = self.conv2(torch.cat([feats[10], uv_32], dim=-1))
        x_d1 = self.up1(x_d0, torch.cat([feats[7], uv_16], dim=-1))
        x_feat = self.up2(x_d1, torch.cat([feats[5], uv_8], dim=-1))
        x_feat = torch.cat([x_feat, uv_8], dim=-1)

        pred_norm = ray_relu(_normalize(self.normal_head(x_feat)), ray_8)
        feat_map = torch.cat([self.feature_head(x_feat), uv_8], dim=-1)
        h = self.hidden_head(x_feat)

        up_norm = _normalize(convex_upsample(pred_norm, self.up_prob_head(torch.cat([h, uv_8], dim=-1)),
                                             self.DOWN))
        for _ in range(self.num_iter):
            h, pred_norm, up_norm = self.refine(h, feat_map, pred_norm, intrins, orig_H, orig_W, uv_8, ray_8)
        return up_norm


def convert_dsine_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """dsine.pt state dict → the module's paths (JAX leaf names, torch layouts)."""
    for pre in ("model.", "module."):
        if any(k.startswith(pre) for k in sd):
            sd = {(k[len(pre):] if k.startswith(pre) else k): v for k, v in sd.items()}
    enc = convert_timm_efficientnet({k: v for k, v in sd.items() if k.startswith("encoder.original_model.")},
                                    prefix="encoder.original_model.")
    out = {f"encoder.{k}": v for k, v in enc.items()}

    def conv(dst, src, ws=False):
        tgt = f"{dst}.conv" if ws else dst
        out[f"{tgt}.kernel"] = sd[f"{src}.weight"]
        if f"{src}.bias" in sd:
            out[f"{tgt}.bias"] = sd[f"{src}.bias"]

    def gn(dst, src):
        out[f"{dst}.scale"] = sd[f"{src}.weight"]
        out[f"{dst}.bias"] = sd[f"{src}.bias"]

    conv("conv2", "decoder.conv2")
    for i in (1, 2):
        conv(f"up{i}.conv_a", f"decoder.up{i}._net.0", ws=True)
        gn(f"up{i}.gn_a", f"decoder.up{i}._net.1")
        conv(f"up{i}.conv_b", f"decoder.up{i}._net.3", ws=True)
        gn(f"up{i}.gn_b", f"decoder.up{i}._net.4")
    for head in ("normal_head", "feature_head", "hidden_head"):
        for li, ci in zip((0, 2, 4), ("c0", "c1", "c2")):
            conv(f"{head}.{ci}", f"decoder.{head}.{li}")
    for head in ("prob_head", "xy_head", "angle_head", "up_prob_head"):
        for li, ci in zip((0, 2, 4), ("c0", "c1", "c2")):
            conv(f"{head}.{ci}", f"{head}.{li}")
    for g in ("convz", "convr", "convq"):
        conv(f"gru.{g}", f"gru.{g}")
    return out


def get_intrins_from_fov(fov: float, H: int, W: int) -> np.ndarray:
    """(3,3) intrinsics from a field-of-view (utils/utils.py:71)."""
    f = (max(H, W) / 2.0) / np.tan(np.deg2rad(fov / 2.0))
    return np.array([[f, 0, W / 2.0 - 0.5],
                     [0, f, H / 2.0 - 0.5],
                     [0, 0, 1]], np.float32)


@preprocessor_registry.register("dsine", aliases=("DsineDetector",))
class DsinePreprocessor(BasePreprocessor):
    """Surface normals via DSINE. Weights: ``dsine.pt`` in the preprocessor
    models dir."""

    name = "dsine"
    params_schema = {"detect_resolution": 512, "fov": 60.0, "iterations": 5}

    def __init__(self, model: Optional[DSINE] = None):
        self._model = model

    def setup(self) -> None:
        if self._model is None:
            from apex_studio_tpu_torch.preprocess.weights import load_detector

            self._model = load_detector(DSINE, "dsine", "dsine.pt", convert_dsine_keys, self.device)

    @torch.no_grad()
    def process_frame(self, frame: np.ndarray, **params) -> np.ndarray:
        import cv2

        h, w = frame.shape[:2]
        res = int(params.get("detect_resolution", 512))
        fov = float(params.get("fov", 60.0))
        self._model.num_iter = int(params.get("iterations", 5))
        scale = res / min(h, w) if res else 1.0
        th, tw = int(round(h * scale)), int(round(w * scale))
        img = cv2.resize(frame, (tw, th), interpolation=cv2.INTER_CUBIC)
        ph, pw = _pad64(th, tw)
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="constant")
        intrins = get_intrins_from_fov(fov, th, tw)
        intrins[0, 2] += 0.5
        intrins[1, 2] += 0.5
        dev = next(self._model.parameters()).device
        normal = self._model(normalize_imagenet(img, dev), torch.from_numpy(intrins)[None].to(dev))
        vis = ((normal[0, :th, :tw].cpu().numpy() + 1.0) * 0.5).clip(0, 1)
        return cv2.resize((vis * 255.0).astype(np.uint8), (w, h), interpolation=cv2.INTER_CUBIC)
