"""NormalBAE surface normals (port of ``apex_studio_tpu/preprocess/normalbae.py``):
NNET, the EfficientNet-B5 encoder (``preprocess/efficientnet.py``) and the
uncertainty-aware decoder, NHWC at every function as in the JAX module and
with its attribute names (``loaders/from_jax.py`` carries its parameters);
the published ``scannet.pt`` (``{"model": state_dict}``) loads through
``convert_nnet_keys`` strictly.

Inference path, as in JAX: a 1×1 ``conv2`` on feature 10 (1/32), four
``UpSampleBN`` stages against features 7, 5, 4 and 3 (align-corners bilinear
upsample, concat, conv-BN-LeakyReLU twice); ``out_res8`` a 3×3 conv then
``norm_normalize``; the res4 / res2 / res1 heads upsample the features and
the previous prediction, concat and run a 1×1 conv stack. The network runs in
f32 on ``device`` (``None`` is the card); the cv2 resizes and the edge pad to
a multiple of 64 stay on the host, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_anything import IMAGENET_MEAN, IMAGENET_STD, resize_bilinear_ac
from apex_studio_tpu_torch.preprocess.efficientnet import (
    BNInf,
    EffNetConfig,
    EfficientNetFeatures,
    SameConv,
    convert_timm_efficientnet,
)


class UpSampleBN(nn.Module):
    """conv3x3 → BN → LeakyReLU twice, after an align-corners bilinear
    upsample and concat (normalbae submodules.py:69)."""

    def __init__(self, skip_input: int, out: int, bn_eps: float):
        super().__init__()
        self.conv_a = SameConv(skip_input, out, 3)
        self.bn_a = BNInf(out, bn_eps)
        self.conv_b = SameConv(out, out, 3)
        self.bn_b = BNInf(out, bn_eps)

    def forward(self, x, skip):
        x = resize_bilinear_ac(x, skip.shape[1], skip.shape[2])
        x = torch.cat([x, skip], dim=-1)
        x = F.leaky_relu(self.bn_a(self.conv_a(x)), 0.01)
        return F.leaky_relu(self.bn_b(self.conv_b(x)), 0.01)


def norm_normalize(x: torch.Tensor) -> torch.Tensor:
    """Unit-normalize the normal vector, ELU-shift kappa (submodules.py:102)."""
    n, kappa = x[..., :3], x[..., 3:]
    mag = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True)) + 1e-10
    kappa = F.elu(kappa) + 1.0 + 0.01
    return torch.cat([n / mag, kappa], dim=-1)


class _Head(nn.Module):
    """Conv1d(1x1) stack head: (C+4) → 128 → 128 → 128 → 4 with ReLU."""

    def __init__(self, in_ch: int):
        super().__init__()
        self.c0, self.c1, self.c2, self.c3 = (SameConv(i, o, 1, use_bias=True)
                                              for i, o in ((in_ch, 128), (128, 128), (128, 128), (128, 4)))

    def forward(self, x):
        x = F.relu(self.c0(x))
        x = F.relu(self.c1(x))
        x = F.relu(self.c2(x))
        return self.c3(x)


class NNET(nn.Module):
    def __init__(self, cfg: Optional[EffNetConfig] = None):
        super().__init__()
        cfg = cfg or EffNetConfig.b5()
        self.encoder = EfficientNetFeatures(cfg)
        ch = self.encoder.feature_channels()
        nf = cfg.head_ch
        # decoder widths scale with the head like the reference's 2048→1024→…
        d1, d2, d3, d4 = nf // 2, nf // 4, nf // 8, nf // 16
        self.conv2 = SameConv(nf, nf, 1, use_bias=True)
        self.up1 = UpSampleBN(nf + ch[7], d1, cfg.bn_eps)
        self.up2 = UpSampleBN(d1 + ch[5], d2, cfg.bn_eps)
        self.up3 = UpSampleBN(d2 + ch[4], d3, cfg.bn_eps)
        self.up4 = UpSampleBN(d3 + ch[3], d4, cfg.bn_eps)
        self.out_conv_res8 = SameConv(d2, 4, 3, use_bias=True)
        self.out_conv_res4 = _Head(d2 + 4)
        self.out_conv_res2 = _Head(d3 + 4)
        self.out_conv_res1 = _Head(d4 + 4)

    def forward(self, x):
        """NHWC normalized image → NHWC [nx, ny, nz, kappa] at input res."""
        f = self.encoder(x)
        x_d0 = self.conv2(f[10])
        x_d1 = self.up1(x_d0, f[7])
        x_d2 = self.up2(x_d1, f[5])
        x_d3 = self.up3(x_d2, f[4])
        x_d4 = self.up4(x_d3, f[3])

        out_res8 = norm_normalize(self.out_conv_res8(x_d2))

        def level(feat, prev, head):
            h, w = feat.shape[1] * 2, feat.shape[2] * 2
            fm = resize_bilinear_ac(feat, h, w)
            pr = resize_bilinear_ac(prev, h, w)
            return norm_normalize(head(torch.cat([fm, pr], dim=-1)))

        out_res4 = level(x_d2, out_res8, self.out_conv_res4)
        out_res2 = level(x_d3, out_res4, self.out_conv_res2)
        return level(x_d4, out_res2, self.out_conv_res1)


def convert_nnet_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """scannet.pt state dict (its ``model``) → the module's paths. Handles
    the ``module.`` prefix (normalbae/__init__.py:26-38); the heads' Conv1d
    ``[out, in, 1]`` become 1×1 conv weights."""
    sd = {k.replace("module.", "", 1) if k.startswith("module.") else k: v for k, v in sd.items()}
    enc = convert_timm_efficientnet({k: v for k, v in sd.items() if k.startswith("encoder.original_model.")},
                                    prefix="encoder.original_model.")
    out = {f"encoder.{k}": v for k, v in enc.items()}

    def conv(dst, src):
        w = sd[f"{src}.weight"]
        out[f"{dst}.kernel"] = w[..., None] if w.ndim == 3 else w
        if f"{src}.bias" in sd:
            out[f"{dst}.bias"] = sd[f"{src}.bias"]

    conv("conv2", "decoder.conv2")
    for i in range(1, 5):
        conv(f"up{i}.conv_a", f"decoder.up{i}._net.0")
        conv(f"up{i}.conv_b", f"decoder.up{i}._net.3")
        for ours, theirs in ((f"up{i}.bn_a", f"decoder.up{i}._net.1"), (f"up{i}.bn_b", f"decoder.up{i}._net.4")):
            out[f"{ours}.scale"] = sd[f"{theirs}.weight"]
            out[f"{ours}.bias"] = sd[f"{theirs}.bias"]
            out[f"{ours}.mean"] = sd[f"{theirs}.running_mean"]
            out[f"{ours}.var"] = sd[f"{theirs}.running_var"]
    conv("out_conv_res8", "decoder.out_conv_res8")
    for res in (4, 2, 1):
        for li, ci in zip((0, 2, 4, 6), ("c0", "c1", "c2", "c3")):
            conv(f"out_conv_res{res}.{ci}", f"decoder.out_conv_res{res}.{li}")
    return out


def _pad64(h: int, w: int):
    return (-h) % 64, (-w) % 64


def normalize_imagenet(img: np.ndarray, device) -> torch.Tensor:
    """uint8 HWC RGB → ImageNet-normalized NHWC f32 on ``device``, computed on
    the host in numpy as the JAX preprocessors compute it."""
    x = (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    return torch.from_numpy(x)[None].to(device)


@preprocessor_registry.register("normalbae", aliases=("NormalBaeDetector",))
class NormalBaePreprocessor(BasePreprocessor):
    """Surface-normal map via NNET. Weights: ``scannet.pt`` (the ControlNet
    annotator release) in the preprocessor models dir."""

    name = "normalbae"
    params_schema = {"detect_resolution": 512}

    def __init__(self, model: Optional[NNET] = None):
        self._model = model

    def setup(self) -> None:
        if self._model is None:
            from apex_studio_tpu_torch.preprocess.weights import load_detector

            self._model = load_detector(NNET, "scannet", "scannet.pt", convert_nnet_keys, self.device)

    @torch.no_grad()
    def process_frame(self, frame: np.ndarray, **params) -> np.ndarray:
        import cv2

        h, w = frame.shape[:2]
        res = int(params.get("detect_resolution", 512))
        scale = res / min(h, w) if res else 1.0
        th, tw = int(round(h * scale)), int(round(w * scale))
        img = cv2.resize(frame, (tw, th), interpolation=cv2.INTER_CUBIC)
        ph, pw = _pad64(th, tw)
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
        out = self._model(normalize_imagenet(img, next(self._model.parameters()).device))
        normal = out[0, :th, :tw, :3].cpu().numpy()
        vis = ((normal + 1.0) * 0.5).clip(0, 1)
        vis = (vis * 255.0).astype(np.uint8)
        return cv2.resize(vis, (w, h), interpolation=cv2.INTER_CUBIC)
