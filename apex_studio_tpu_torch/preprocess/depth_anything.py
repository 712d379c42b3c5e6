"""Depth Anything V2, monocular relative depth (port of
``apex_studio_tpu/preprocess/depth_anything.py``): a DINOv2 ViT encoder and a
DPT decoder, NHWC at every function as in the JAX module, with its attribute
names, so ``loaders/from_jax.py`` carries its parameters; the published
checkpoints (``depth_anything_v2_{vits,vitb,vitl}.pth``) load through
``convert_dav2_keys`` strictly.

The ViT's attention is the plain version (``naive_attention``), as in JAX,
which computes it with ``naive_attention`` and not ``attention_op``: no
Pallas kernel is on this path. The model is f32 and runs on ``device``
(``None`` is the card); a conv runs on NHWC memory (a permuted view is
channels-last, which cuDNN takes without a copy).

``jax.image.resize`` is not ``F.interpolate``: DINOv2's position-embedding
resize (bicubic, no antialias) and the input resize (bicubic, antialiased)
run ``utils/jax_resize.py``; the DPT's own resizes are ``resize_bilinear_ac``
(align_corners, torch's semantics, as the JAX module writes them out).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import GELUMLP, LayerNorm, Linear
from apex_studio_tpu_torch.ops.attention import naive_attention
from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, preprocessor_registry
from apex_studio_tpu_torch.utils.jax_resize import resize as jax_resize

logger = logging.getLogger("apex.preprocess.depth")

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass
class DAv2Config:
    encoder: str = "vits"
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    features: int = 64
    out_channels: Tuple[int, int, int, int] = (48, 96, 192, 384)
    intermediate_idx: Tuple[int, int, int, int] = (2, 5, 8, 11)
    patch_size: int = 14
    mlp_ratio: float = 4.0
    pos_grid: int = 37  # 518/14 — the pretraining grid for pos_embed

    @classmethod
    def from_name(cls, name: str) -> "DAv2Config":
        presets = {
            "vits": dict(embed_dim=384, depth=12, num_heads=6, features=64,
                         out_channels=(48, 96, 192, 384), intermediate_idx=(2, 5, 8, 11)),
            "vitb": dict(embed_dim=768, depth=12, num_heads=12, features=128,
                         out_channels=(96, 192, 384, 768), intermediate_idx=(2, 5, 8, 11)),
            "vitl": dict(embed_dim=1024, depth=24, num_heads=16, features=256,
                         out_channels=(256, 512, 1024, 1024), intermediate_idx=(4, 11, 17, 23)),
        }
        if name not in presets:
            raise ValueError(f"unknown DAv2 encoder {name!r} (have {sorted(presets)})")
        return cls(encoder=name, **presets[name])

    @classmethod
    def tiny(cls) -> "DAv2Config":
        """Test-sized config: full topology, toy dims."""
        return cls(encoder="tiny", embed_dim=32, depth=4, num_heads=2, features=16,
                   out_channels=(8, 12, 16, 24), intermediate_idx=(0, 1, 2, 3),
                   patch_size=14, pos_grid=4)


def _lecun(*shape, fan_in: int) -> nn.Parameter:
    """normal(0, 1/√fan_in), as JAX's lecun_normal; on the ``meta`` device (a
    module built to be filled from a checkpoint) nothing is drawn."""
    t = torch.zeros(shape)
    if not t.is_meta:
        t.normal_(0.0, fan_in ** -0.5)
    return nn.Parameter(t)


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                stride: int = 1, padding=0, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated`` on NHWC with an OIHW ``weight`` (grouped:
    ``[O, I / groups, kh, kw]``): ``padding`` is an int (the same on every
    side) or ``((top, bottom), (left, right))`` of zeros, as JAX takes it."""
    xc = x.permute(0, 3, 1, 2)
    if not isinstance(padding, int):
        (top, bottom), (left, right) = padding
        if top == bottom and left == right:
            padding = (top, left)
        else:
            xc, padding = F.pad(xc, (left, right, top, bottom)), 0
    return F.conv2d(xc, weight, bias, stride, padding, dilation, groups).permute(0, 2, 3, 1)


def _bn_params(module: nn.Module, ch: int) -> None:
    module.bn_scale = nn.Parameter(torch.ones(ch))
    module.bn_bias = nn.Parameter(torch.zeros(ch))
    module.bn_mean = nn.Parameter(torch.zeros(ch))
    module.bn_var = nn.Parameter(torch.ones(ch))


def _bn(module: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """Eval BatchNorm (eps 1e-5) with the running statistics as parameters
    (M-LSD's and U²-Net's ``bn_*`` leaves), written as the JAX modules write it."""
    y = (y - module.bn_mean) * torch.rsqrt(module.bn_var + 1e-5)
    return y * module.bn_scale + module.bn_bias


class Conv(nn.Module):
    """NHWC conv; ``weight`` OIHW, optional bias."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, use_bias: bool = True):
        super().__init__()
        self.weight = _lecun(cout, cin, kernel, kernel, fan_in=cin * kernel * kernel)
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return conv2d_nhwc(x, self.weight, self.bias, self.stride, self.padding)


class BlockUpsample(nn.Module):
    """ConvTranspose2d with kernel_size == stride: each input pixel expands to
    an s×s block. ``weight`` is the published ``[in, out, s, s]``; the JAX
    module keeps it as an unflipped HWIO ``w`` (``jax_w_flipped``)."""

    jax_w_flipped = False

    def __init__(self, cin: int, cout: int, scale: int):
        super().__init__()
        self.weight = _lecun(cin, cout, scale, scale, fan_in=cin * scale * scale)
        self.bias = nn.Parameter(torch.zeros(cout))
        self.scale = scale

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias, stride=self.scale)
        return y.permute(0, 2, 3, 1)


def resize_bilinear_ac(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True on NHWC (torch F.interpolate
    semantics used throughout DPT), written out as the JAX module writes it."""
    _, H, W, _ = x.shape
    if (H, W) == (h, w):
        return x
    dev = x.device
    ys = torch.linspace(0.0, H - 1.0, h, device=dev) if h > 1 else torch.zeros(1, device=dev)
    xs = torch.linspace(0.0, W - 1.0, w, device=dev) if w > 1 else torch.zeros(1, device=dev)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = (y0 + 1).clamp_max(H - 1)
    x1 = (x0 + 1).clamp_max(W - 1)
    fy = (ys - y0)[None, :, None, None]
    fx = (xs - x0)[None, None, :, None]
    r0, r1 = x[:, y0], x[:, y1]
    top = r0[:, :, x0] * (1 - fx) + r0[:, :, x1] * fx
    bot = r1[:, :, x0] * (1 - fx) + r1[:, :, x1] * fx
    return top * (1 - fy) + bot * fy


class _VitAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.qkv = Linear(dim, dim * 3, dtype=torch.float32)
        self.proj = Linear(dim, dim, dtype=torch.float32)
        self.heads = heads

    def forward(self, x):
        b, n, d = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, d // self.heads)
        out = naive_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).to(x.dtype)
        return self.proj(out.reshape(b, n, d))


class _LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class _VitBlock(nn.Module):
    def __init__(self, cfg: DAv2Config):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = LayerNorm(d)
        self.attn = _VitAttention(d, cfg.num_heads)
        self.ls1 = _LayerScale(d)
        self.norm2 = LayerNorm(d)
        self.mlp = GELUMLP(d, int(d * cfg.mlp_ratio), approximate=False, dtype=torch.float32)
        self.ls2 = _LayerScale(d)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DINOv2(nn.Module):
    """ViT encoder exposing intermediate layers (the final norm applied to
    each collected layer, the cls token returned)."""

    def __init__(self, cfg: DAv2Config):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.patch_embed = Conv(3, d, kernel=cfg.patch_size, stride=cfg.patch_size, padding=0)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pos_grid * cfg.pos_grid, d))
        self.blocks = nn.ModuleList([_VitBlock(cfg) for _ in range(cfg.depth)])
        self.norm = LayerNorm(d)

    def _interp_pos(self, gh: int, gw: int) -> torch.Tensor:
        pe = self.pos_embed
        g = self.cfg.pos_grid
        if (gh, gw) == (g, g):
            return pe
        grid = pe[:, 1:].reshape(1, g, g, -1)
        grid = jax_resize(grid, (1, gh, gw, grid.shape[-1]), "bicubic", antialias=False)
        return torch.cat([pe[:, :1], grid.reshape(1, gh * gw, -1)], dim=1)

    def intermediate_layers(self, x: torch.Tensor, idx: Sequence[int]):
        """x: NHWC float, H/W multiples of patch_size → [(patch_tokens, cls)]."""
        b, H, W, _ = x.shape
        p = self.cfg.patch_size
        gh, gw = H // p, W // p
        tok = self.patch_embed(x).reshape(b, gh * gw, -1)
        cls = self.cls_token.expand(b, 1, tok.shape[-1])
        tok = torch.cat([cls, tok], dim=1) + self._interp_pos(gh, gw)
        want = set(int(i) for i in idx)
        outs: Dict[int, torch.Tensor] = {}
        for i, blk in enumerate(self.blocks):
            tok = blk(tok)
            if i in want:
                outs[i] = tok
        normed = {i: self.norm(t) for i, t in outs.items()}
        return [(normed[i][:, 1:], normed[i][:, 0]) for i in idx]


class _ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv(features, features)
        self.conv2 = Conv(features, features)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class _FeatureFusion(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = _ResidualConvUnit(features)
        self.resConfUnit2 = _ResidualConvUnit(features)
        self.out_conv = Conv(features, features, kernel=1, padding=0)

    def forward(self, x0, x1=None, size: Optional[Tuple[int, int]] = None):
        out = x0 if x1 is None else x0 + self.resConfUnit1(x1)
        out = self.resConfUnit2(out)
        h, w = size if size is not None else (out.shape[1] * 2, out.shape[2] * 2)
        return self.out_conv(resize_bilinear_ac(out, h, w))


class DPTHead(nn.Module):
    def __init__(self, cfg: DAv2Config):
        super().__init__()
        d, f = cfg.embed_dim, cfg.features
        oc = cfg.out_channels
        self.projects = nn.ModuleList([Conv(d, c, kernel=1, padding=0) for c in oc])
        self.resize0 = BlockUpsample(oc[0], oc[0], 4)
        self.resize1 = BlockUpsample(oc[1], oc[1], 2)
        self.resize3 = Conv(oc[3], oc[3], kernel=3, stride=2, padding=1)
        self.layer_rn = nn.ModuleList([Conv(c, f, use_bias=False) for c in oc])
        self.refinenet1 = _FeatureFusion(f)
        self.refinenet2 = _FeatureFusion(f)
        self.refinenet3 = _FeatureFusion(f)
        self.refinenet4 = _FeatureFusion(f)
        self.output_conv1 = Conv(f, f // 2)
        self.output_conv2_0 = Conv(f // 2, 32)
        self.output_conv2_2 = Conv(32, 1, kernel=1, padding=0)
        self.patch_size = cfg.patch_size

    def forward(self, features, gh: int, gw: int):
        maps = []
        for i, (tok, _cls) in enumerate(features):
            x = self.projects[i](tok.reshape(tok.shape[0], gh, gw, tok.shape[-1]))
            if i == 0:
                x = self.resize0(x)
            elif i == 1:
                x = self.resize1(x)
            elif i == 3:
                x = self.resize3(x)
            maps.append(self.layer_rn[i](x))
        l1, l2, l3, l4 = maps
        p4 = self.refinenet4(l4, size=l3.shape[1:3])
        p3 = self.refinenet3(p4, l3, size=l2.shape[1:3])
        p2 = self.refinenet2(p3, l2, size=l1.shape[1:3])
        p1 = self.refinenet1(p2, l1)
        out = self.output_conv1(p1)
        out = resize_bilinear_ac(out, gh * self.patch_size, gw * self.patch_size)
        out = F.relu(self.output_conv2_0(out))
        out = F.relu(self.output_conv2_2(out))
        return out[..., 0]  # (B, H, W) relative inverse depth


class DepthAnythingV2(nn.Module):
    """NHWC normalized image → relative depth (B, H, W)."""

    config_class = DAv2Config

    def __init__(self, cfg: DAv2Config):
        super().__init__()
        self.cfg = cfg
        self.pretrained = DINOv2(cfg)
        self.depth_head = DPTHead(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.cfg.patch_size
        gh, gw = x.shape[1] // p, x.shape[2] // p
        return self.depth_head(self.pretrained.intermediate_layers(x, self.cfg.intermediate_idx), gh, gw)


def convert_dav2_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Published checkpoint keys → the JAX module's leaf names (``.kernel``
    for conv and Linear weights, which ``state_mapping`` maps to the port's
    ``.weight``); values keep torch's layout, the transposed convolutions'
    ``[in, out, s, s]`` included."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.startswith("pretrained."):
            r = k[len("pretrained."):]
            if r == "mask_token":
                continue
            r = r.replace("patch_embed.proj.weight", "patch_embed.kernel")
            r = r.replace("patch_embed.proj.bias", "patch_embed.bias")
            r = r.replace(".attn.qkv.weight", ".attn.qkv.kernel")
            r = r.replace(".attn.proj.weight", ".attn.proj.kernel")
            r = r.replace(".mlp.fc1.weight", ".mlp.fc1.kernel")
            r = r.replace(".mlp.fc2.weight", ".mlp.fc2.kernel")
            out[f"pretrained.{r}"] = v
            continue
        if k.startswith("depth_head."):
            r = k[len("depth_head."):]
            if r.startswith("resize_layers."):
                i = int(r.split(".")[1])
                leaf = r.split(".")[-1]
                if i in (0, 1):
                    out[f"depth_head.resize{i}.{leaf}"] = v
                elif i == 3:
                    out[f"depth_head.resize3.{'kernel' if leaf == 'weight' else 'bias'}"] = v
                continue
            r = r.replace("scratch.", "")
            for n in range(1, 5):
                r = r.replace(f"layer{n}_rn.weight", f"layer_rn.{n - 1}.kernel")
            if ".conv" in r or "out_conv" in r or "projects" in r or "output_conv" in r:
                r = r.replace(".weight", ".kernel")
            r = r.replace("output_conv2.0.", "output_conv2_0.")
            r = r.replace("output_conv2.2.", "output_conv2_2.")
            out[f"depth_head.{r}"] = v
            continue
        logger.debug("DAv2 converter: skipping %s", k)
    return out


# -------- preprocessor ----------------------------------------------------------------


def _prepare(frame: np.ndarray, resolution: int, patch: int, device) -> torch.Tensor:
    """uint8 HWC RGB → normalized NHWC f32 on ``device``, min side ≥
    resolution, dims multiples of the patch size (the reference's lower_bound
    Resize), through JAX's antialiased bicubic."""
    h, w = frame.shape[:2]
    scale = resolution / min(h, w) if resolution else 1.0
    th = max(patch, int(round(h * scale / patch)) * patch)
    tw = max(patch, int(round(w * scale / patch)) * patch)
    img = torch.from_numpy(frame.astype(np.float32) / 255.0).to(device)
    x = jax_resize(img, (th, tw, 3), "bicubic", antialias=True)
    mean, std = (torch.from_numpy(a).to(device) for a in (IMAGENET_MEAN, IMAGENET_STD))
    return ((x - mean) / std)[None]


@preprocessor_registry.register("depth_anything_v2")
class DepthAnythingV2Preprocessor(BasePreprocessor):
    """Relative depth map (grayscale uint8). Params: ``encoder`` (vits/vitb/
    vitl), ``detect_resolution`` (0 = native). Weights:
    ``depth_anything_v2_<encoder>.{safetensors,pth}`` in the preprocessor
    models dir."""

    name = "depth_anything_v2"
    params_schema = {"encoder": "vits", "detect_resolution": 518}

    def __init__(self, model: Optional[DepthAnythingV2] = None):
        self._model = model

    _pending_encoder = "vits"

    def setup(self) -> None:
        if self._model is None:
            from apex_studio_tpu_torch.preprocess.weights import load_detector

            cfg = DAv2Config.from_name(self._pending_encoder)
            stem = f"depth_anything_v2_{cfg.encoder}"
            self._model = load_detector(lambda: DepthAnythingV2(cfg), stem, f"{stem}.pth", convert_dav2_keys,
                                        self.device)

    def __call__(self, frames, progress_callback=None, device=None, **params):
        self._pending_encoder = params.pop("encoder", "vits")
        return super().__call__(frames, progress_callback=progress_callback, device=device, **params)

    @torch.no_grad()
    def process_frame(self, frame: np.ndarray, **params) -> np.ndarray:
        res = int(params.get("detect_resolution", 518) or min(frame.shape[:2]))
        dev = next(self._model.parameters()).device
        h, w = frame.shape[:2]
        depth = self._model(_prepare(frame, res, self._model.cfg.patch_size, dev))
        d = resize_bilinear_ac(depth[..., None], h, w)[0, ..., 0].float().cpu().numpy()
        lo, hi = float(d.min()), float(d.max())
        norm = (d - lo) / (hi - lo) if hi > lo else np.zeros_like(d)
        g = (norm * 255.0).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)


# editor alias used by reference manifests ("depth")
preprocessor_registry.register("depth")(DepthAnythingV2Preprocessor)
