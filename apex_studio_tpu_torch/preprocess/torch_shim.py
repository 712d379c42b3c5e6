"""The ``torchvision::nms`` and ``torchvision::roi_align`` operators that
TorchScript detection exports call into, in plain torch (port of
``apex_studio_tpu/preprocess/torch_shim.py``).

The reference runs DensePose as a TorchScript export whose graph invokes
those builtins and imports torchvision only to register them (reference
``src/preprocess/densepose/__init__.py:1``). Neither machine has
torchvision; the two ops are a few dozen lines of torch, registered through
``torch.library`` under the same names, which is all the TorchScript runtime
resolves: a published export then loads and runs unmodified, on the CPU or
on the card (the implementation is ``CompositeExplicitAutograd``, one kernel
for every device).

Semantics as the JAX shim's (which follow torchvision's):
- ``nms(dets, scores, iou_threshold)``: greedy descending-score suppression
  of [N, 4] xyxy boxes → the kept indices (int64);
- ``roi_align(input, rois, spatial_scale, h, w, sampling_ratio, aligned)``:
  Mask R-CNN's bilinear ROI pooling on [N, C, H, W] with rois [K, 5]
  (batch index, xyxy), the ``aligned=True`` half-pixel shift included, the
  sample points clamped into the map. The ROI corners are read on the host
  once (the per-ROI sampling grid depends on them); the sampling runs on
  the input's device.

Departure: the JAX shim first imports ``torchvision`` and takes its ops if
the import succeeds, which a stub module in ``sys.modules`` satisfies without
providing them. The port never imports torchvision: it looks for the two ops
in ``torch.ops.torchvision`` (torchvision's, or another registration's in the
same process, such as the JAX shim's) and registers its own where they are
missing.
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger("apex.preprocess.torch_shim")


def _nms_impl(dets, scores, iou_threshold: float):
    if dets.numel() == 0:
        return torch.empty((0,), dtype=torch.int64, device=dets.device)
    x1, y1, x2, y2 = dets.unbind(dim=1)
    areas = (x2 - x1) * (y2 - y1)
    order = scores.argsort(descending=True)
    keep = []
    while order.numel() > 0:
        i = order[0]
        keep.append(i)
        if order.numel() == 1:
            break
        rest = order[1:]
        xx1 = torch.maximum(x1[i], x1[rest])
        yy1 = torch.maximum(y1[i], y1[rest])
        xx2 = torch.minimum(x2[i], x2[rest])
        yy2 = torch.minimum(y2[i], y2[rest])
        inter = (xx2 - xx1).clamp(min=0) * (yy2 - yy1).clamp(min=0)
        iou = inter / (areas[i] + areas[rest] - inter)
        order = rest[iou <= iou_threshold]
    return torch.stack(keep).to(torch.int64)


def _roi_align_impl(inp, rois, spatial_scale: float, pooled_h: int, pooled_w: int, sampling_ratio: int,
                    aligned: bool):
    """Bilinear ROI align on [N, C, H, W] with rois [K, 5] (batch index, xyxy)."""
    n, c, h, w = inp.shape
    k = rois.shape[0]
    out = inp.new_zeros((k, c, pooled_h, pooled_w))
    if k == 0:
        return out
    offset = 0.5 if aligned else 0.0
    boxes = rois.detach().to("cpu")
    dev, dt = inp.device, inp.dtype
    iy = torch.arange(pooled_h, device=dev, dtype=dt)
    ix = torch.arange(pooled_w, device=dev, dtype=dt)
    for r in range(k):
        b = int(boxes[r, 0])
        x1 = boxes[r, 1] * spatial_scale - offset
        y1 = boxes[r, 2] * spatial_scale - offset
        x2 = boxes[r, 3] * spatial_scale - offset
        y2 = boxes[r, 4] * spatial_scale - offset
        roi_w, roi_h = x2 - x1, y2 - y1
        if not aligned:  # the legacy clamp: a roi of no size gets unit extent
            roi_w, roi_h = roi_w.clamp(min=1.0), roi_h.clamp(min=1.0)
        bin_w, bin_h = roi_w / pooled_w, roi_h / pooled_h
        sr_h = sampling_ratio if sampling_ratio > 0 else max(int(torch.ceil(roi_h / pooled_h)), 1)
        sr_w = sampling_ratio if sampling_ratio > 0 else max(int(torch.ceil(roi_w / pooled_w)), 1)
        # for each output bin, sr_h × sr_w bilinear taps
        sy = torch.arange(sr_h, device=dev, dtype=dt)
        sx = torch.arange(sr_w, device=dev, dtype=dt)
        ys = (y1.to(dev) + (iy[:, None] + (sy[None, :] + 0.5) / sr_h) * bin_h.to(dev)).reshape(-1)
        xs = (x1.to(dev) + (ix[:, None] + (sx[None, :] + 0.5) / sr_w) * bin_w.to(dev)).reshape(-1)
        ys = ys.clamp(min=0, max=h - 1)
        xs = xs.clamp(min=0, max=w - 1)
        y0 = ys.floor().long().clamp(max=h - 1)
        x0 = xs.floor().long().clamp(max=w - 1)
        y1i = (y0 + 1).clamp(max=h - 1)
        x1i = (x0 + 1).clamp(max=w - 1)
        ly = (ys - y0.to(dt)).reshape(1, -1, 1)
        lx = (xs - x0.to(dt)).reshape(1, 1, -1)
        feat = inp[b]
        val = (feat[:, y0][:, :, x0] * (1 - ly) * (1 - lx) + feat[:, y0][:, :, x1i] * (1 - ly) * lx
               + feat[:, y1i][:, :, x0] * ly * (1 - lx) + feat[:, y1i][:, :, x1i] * ly * lx)
        # [C, ph·sr_h, pw·sr_w] → the average of each sr_h × sr_w bin
        out[r] = val.reshape(c, pooled_h, sr_h, pooled_w, sr_w).mean(dim=(2, 4))
    return out


def _have_ops() -> bool:
    ns = torch.ops.torchvision
    return hasattr(ns, "nms") and hasattr(ns, "roi_align")


def install_torchvision_ops() -> bool:
    """``torchvision::nms`` and ``roi_align`` available: True where they
    already are (torchvision's or another registration's), else after
    registering the plain-torch ones. Idempotent; call before
    ``torch.jit.load`` of an export that references them."""
    if _have_ops():
        return True
    try:
        if not hasattr(torch.ops.torchvision, "nms"):
            torch.library.define("torchvision::nms", "(Tensor dets, Tensor scores, float iou_threshold) -> Tensor")
            torch.library.impl("torchvision::nms", "CompositeExplicitAutograd")(_nms_impl)
        if not hasattr(torch.ops.torchvision, "roi_align"):
            torch.library.define(
                "torchvision::roi_align",
                "(Tensor input, Tensor rois, float spatial_scale, int pooled_height, int pooled_width,"
                " int sampling_ratio, bool aligned) -> Tensor")
            torch.library.impl("torchvision::roi_align", "CompositeExplicitAutograd")(_roi_align_impl)
    except RuntimeError as e:  # registered meanwhile by another caller
        logger.warning("torchvision op registration: %s", e)
    return _have_ops()
