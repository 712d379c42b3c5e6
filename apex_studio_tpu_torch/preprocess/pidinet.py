"""PiDiNet soft edges, carv4 with inplane 60, dil 24 and spatial attention
(port of ``apex_studio_tpu/preprocess/pidinet.py``), NHWC at every function
as in the JAX module and with its attribute names (``loaders/from_jax.py``
carries its parameters).

The published ``table5_pidinet.pth`` holds raw pixel-difference weights;
``convert_pidinet_keys`` folds them into vanilla kernels as the JAX
converter does (reference model.py:300 createConvFunc):

- **cd** (central difference): W'[centre] -= ΣW;
- **ad** (angular difference): W' = W − W[clockwise-shuffled];
- **rd** (radial difference): the 3×3 weights scattered ± into a 5×5 kernel.

So the network that runs is plain depthwise, dilated and 1×1 convs: four
stages with a stride-2 max pool between, CDCM dilated fusion, CSAM spatial
gates (a 1×1-conv sigmoid, no attention), the side maps resized to the input
by ``jax.image.resize`` (``utils/jax_resize.py``) and fused by a 1×1
classifier. The fold is not invertible, so ``loaders/export.py`` has no
PiDiNet family; ``published_shapes`` gives the file's names and shapes, from
which seeded raw weights are written.

The network runs in f32 on ``device`` (``None`` is the card). Departure: a
missing checkpoint raises ``FileNotFoundError`` and the load is strict,
where the JAX preprocessor runs random weights or loads by shape.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry
from apex_studio_tpu_torch.preprocess.depth_anything import Conv, _lecun, conv2d_nhwc
from apex_studio_tpu_torch.preprocess.hed import edge_to_frame, max_pool_2x2
from apex_studio_tpu_torch.utils.jax_resize import resize as jax_resize

_CARV4 = ["cd", "ad", "rd", "cv"] * 4
# the published blocks of each stage, in order
_STAGES = (("blocks1", ("block1_1", "block1_2", "block1_3")),
           ("blocks2", ("block2_1", "block2_2", "block2_3", "block2_4")),
           ("blocks3", ("block3_1", "block3_2", "block3_3", "block3_4")),
           ("blocks4", ("block4_1", "block4_2", "block4_3", "block4_4")))


class _DWConv(nn.Module):
    """Depthwise conv, ``weight`` [C, 1, k, k]."""

    def __init__(self, ch, k, padding, dilation=1):
        super().__init__()
        self.weight = _lecun(ch, 1, k, k, fan_in=k * k)
        self.padding, self.dilation, self.ch = padding, dilation, ch

    def forward(self, x):
        return conv2d_nhwc(x, self.weight, None, 1, self.padding, self.dilation, self.ch)


class _PDCBlock(nn.Module):
    def __init__(self, pdc, cin, cout, stride=1):
        super().__init__()
        self.stride = stride
        self.shortcut = Conv(cin, cout, 1, padding=0) if stride > 1 else None
        k = 5 if pdc == "rd" else 3
        self.conv1 = _DWConv(cin, k, k // 2)
        self.conv2 = Conv(cin, cout, 1, padding=0, use_bias=False)

    def forward(self, x):
        if self.stride > 1:
            x = max_pool_2x2(x)
        y = self.conv2(F.relu(self.conv1(x)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return y + x


class _DilConv(nn.Module):
    def __init__(self, ch, dilation):
        super().__init__()
        self.weight = _lecun(ch, ch, 3, 3, fan_in=ch * 9)
        self.dilation = dilation

    def forward(self, x):
        return conv2d_nhwc(x, self.weight, None, 1, self.dilation, self.dilation)


class _CDCM(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = Conv(cin, cout, 1, padding=0)
        self.branches = nn.ModuleList([_DilConv(cout, d) for d in (5, 7, 9, 11)])

    def forward(self, x):
        x = self.conv1(F.relu(x))
        return sum(b(x) for b in self.branches)


class _CSAM(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv1 = Conv(ch, 4, 1, padding=0)
        self.conv2 = Conv(4, 1, 3, padding=1, use_bias=False)

    def forward(self, x):
        return x * torch.sigmoid(self.conv2(self.conv1(F.relu(x))))


class PiDiNet(nn.Module):
    def __init__(self, inplane: int = 60, dil: int = 24):
        super().__init__()
        self.init_block = Conv(3, inplane, 3, padding=1, use_bias=False)
        c = inplane
        self.blocks1 = nn.ModuleList([_PDCBlock(_CARV4[i], c, c) for i in (1, 2, 3)])
        self.blocks2 = nn.ModuleList([_PDCBlock(_CARV4[4], c, 2 * c, stride=2)]
                                     + [_PDCBlock(_CARV4[i], 2 * c, 2 * c) for i in (5, 6, 7)])
        self.blocks3 = nn.ModuleList([_PDCBlock(_CARV4[8], 2 * c, 4 * c, stride=2)]
                                     + [_PDCBlock(_CARV4[i], 4 * c, 4 * c) for i in (9, 10, 11)])
        self.blocks4 = nn.ModuleList([_PDCBlock(_CARV4[12], 4 * c, 4 * c, stride=2)]
                                     + [_PDCBlock(_CARV4[i], 4 * c, 4 * c) for i in (13, 14, 15)])
        planes = [c, 2 * c, 4 * c, 4 * c]
        self.dilations = nn.ModuleList([_CDCM(p, dil) for p in planes])
        self.attentions = nn.ModuleList([_CSAM(dil) for _ in planes])
        self.conv_reduces = nn.ModuleList([Conv(dil, 1, 1, padding=0) for _ in planes])
        self.classifier = Conv(4, 1, 1, padding=0)

    def forward(self, x):  # NHWC in [0,1] (BGR order like the reference)
        h, w = x.shape[1:3]
        x = self.init_block(x)
        feats = []
        for blocks in (self.blocks1, self.blocks2, self.blocks3, self.blocks4):
            for blk in blocks:
                x = blk(x)
            feats.append(x)
        maps = []
        for i, f in enumerate(feats):
            e = self.conv_reduces[i](self.attentions[i](self.dilations[i](f)))
            maps.append(jax_resize(e, (e.shape[0], h, w, 1), "bilinear"))
        return torch.sigmoid(self.classifier(torch.cat(maps, dim=-1)))


def fold(pdc: str, w: torch.Tensor) -> torch.Tensor:
    """A raw pixel-difference kernel (O, I, 3, 3) → the vanilla kernel that
    computes the same convolution (5×5 for ``rd``)."""
    if pdc == "cd":
        w = w.clone()
        w[:, :, 1, 1] -= w.sum(dim=(2, 3))
        return w
    if pdc == "ad":
        flat = w.reshape(w.shape[0], w.shape[1], 9)
        return (flat - flat[:, :, [3, 0, 1, 6, 4, 2, 7, 8, 5]]).reshape(w.shape)
    if pdc == "rd":
        buf = torch.zeros(w.shape[0], w.shape[1], 25, dtype=w.dtype)
        flat = w.reshape(w.shape[0], w.shape[1], 9)
        buf[:, :, [0, 2, 4, 10, 14, 20, 22, 24]] = flat[:, :, 1:]
        buf[:, :, [6, 7, 8, 11, 13, 16, 17, 18]] = -flat[:, :, 1:]
        return buf.reshape(w.shape[0], w.shape[1], 5, 5)
    return w


def _block_of() -> Dict[str, Tuple[str, int, str]]:
    """Published block name → (stage attribute, index, its PDC type)."""
    out, base = {}, 1
    for stage, names in _STAGES:
        for j, n in enumerate(names):
            out[n] = (stage, j, _CARV4[base])
            base += 1
    return out


def convert_pidinet_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """table5_pidinet.pth state dict (raw carv4 PDC weights) → folded vanilla
    kernels at the module's paths (JAX leaf names, torch layouts)."""
    out = {}
    blocks = _block_of()

    def leaf(name: str) -> str:
        return "kernel" if name == "weight" else name

    for k, v in sd.items():
        parts = k.replace("module.", "").split(".")
        top, last = parts[0], parts[-1]
        if top == "init_block":
            out[f"init_block.{leaf(last)}"] = fold(_CARV4[0], v) if last == "weight" else v
        elif top in blocks:
            stage, j, pdc = blocks[top]
            sub = parts[1]
            if sub == "conv1" and last == "weight":
                out[f"{stage}.{j}.conv1.kernel"] = fold(pdc, v)
            elif sub in ("conv2", "shortcut"):
                out[f"{stage}.{j}.{sub}.{leaf(last)}"] = v
        elif top == "dilations":
            i, sub = parts[1], parts[2]
            if sub == "conv1":
                out[f"dilations.{i}.conv1.{leaf(last)}"] = v
            else:  # conv2_1..conv2_4
                out[f"dilations.{i}.branches.{int(sub[-1]) - 1}.kernel"] = v
        elif top == "attentions":
            out[f"attentions.{parts[1]}.{parts[2]}.{leaf(last)}"] = v
        elif top == "conv_reduces":
            out[f"conv_reduces.{parts[1]}.{leaf(last)}"] = v
        elif top == "classifier":
            out[f"classifier.{leaf(last)}"] = v
    return out


def published_shapes(inplane: int = 60, dil: int = 24) -> Dict[str, Tuple[int, ...]]:
    """The names and shapes of the raw weights in ``table5_pidinet.pth``
    (``module.`` prefixes left out) at ``inplane`` and ``dil``."""
    c = inplane
    shapes: Dict[str, Tuple[int, ...]] = {"init_block.weight": (c, 3, 3, 3)}
    widths = {"blocks1": (c, c), "blocks2": (2 * c, 2 * c), "blocks3": (4 * c, 4 * c), "blocks4": (4 * c, 4 * c)}
    prev = {"blocks2": c, "blocks3": 2 * c, "blocks4": 4 * c}
    for stage, names in _STAGES:
        for j, n in enumerate(names):
            cout = widths[stage][1]
            cin = prev[stage] if (j == 0 and stage != "blocks1") else cout
            shapes[f"{n}.conv1.weight"] = (cin, 1, 3, 3)
            shapes[f"{n}.conv2.weight"] = (cout, cin, 1, 1)
            if j == 0 and stage != "blocks1":
                shapes[f"{n}.shortcut.weight"] = (cout, cin, 1, 1)
                shapes[f"{n}.shortcut.bias"] = (cout,)
    for i, p in enumerate((c, 2 * c, 4 * c, 4 * c)):
        shapes[f"dilations.{i}.conv1.weight"] = (dil, p, 1, 1)
        shapes[f"dilations.{i}.conv1.bias"] = (dil,)
        for b in range(1, 5):
            shapes[f"dilations.{i}.conv2_{b}.weight"] = (dil, dil, 3, 3)
        shapes[f"attentions.{i}.conv1.weight"] = (4, dil, 1, 1)
        shapes[f"attentions.{i}.conv1.bias"] = (4,)
        shapes[f"attentions.{i}.conv2.weight"] = (1, 4, 3, 3)
        shapes[f"conv_reduces.{i}.weight"] = (1, dil, 1, 1)
        shapes[f"conv_reduces.{i}.bias"] = (1,)
    shapes["classifier.weight"] = (1, 4, 1, 1)
    shapes["classifier.bias"] = (1,)
    return shapes


@preprocessor_registry.register("pidinet", aliases=("softedge_pidinet", "pidi", "scribble_pidinet"))
class PiDiNetPreprocessor(BasePreprocessor):
    """Soft edge map. Weights: ``table5_pidinet.pth`` in the preprocessor
    models dir."""

    name = "pidinet"
    params_schema = {"safe": False, "scribble": False, "apply_filter": False}

    def __init__(self, model: Optional[PiDiNet] = None):
        self.model = model

    def setup(self) -> None:
        if self.model is None:
            from apex_studio_tpu_torch.preprocess.weights import load_detector

            self.model = load_detector(PiDiNet, "pidinet", "table5_pidinet.pth", convert_pidinet_keys,
                                       self.device)

    def edge(self, frame: Frame) -> np.ndarray:
        """The f32 edge map at the frame's size, before the filter, ``safe``
        and ``scribble``."""
        h, w = frame.shape[:2]
        x = np.pad(frame[:, :, ::-1], ((0, (-h) % 8), (0, (-w) % 8), (0, 0)), mode="edge")
        dev = next(self.model.parameters()).device
        with torch.no_grad():
            edge = self.model(torch.from_numpy(x.astype(np.float32) / 255.0)[None].to(dev))
        return edge[0, :h, :w, 0].cpu().numpy()

    def process_frame(self, frame: Frame, safe: bool = False, scribble: bool = False, apply_filter: bool = False,
                      **_: Any) -> Frame:
        edge = self.edge(frame)
        if apply_filter:
            edge = (edge > 0.5).astype(np.float32)
        return edge_to_frame(edge, safe, scribble)
