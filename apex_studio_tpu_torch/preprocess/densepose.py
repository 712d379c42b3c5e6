"""DensePose IUV surface maps from the published TorchScript export (port of
``DensePosePreprocessor`` in ``apex_studio_tpu/preprocess/segmentation.py``;
the rest of that module, the Hugging Face segmenters, is not ported).

Reference ``src/preprocess/densepose/__init__.py``: the R50-FPN export of
LayerNorm/DensePose-TorchScript-with-hint-image
(``densepose_r50_fpn_dl.torchscript``), its body-part labels drawn with a
viridis (or parula) colormap. The export's graph calls ``torchvision::nms``
and ``roi_align``, which ``torch_shim.py`` provides. The export is loaded
with ``map_location`` = the device (``None`` is the card), so the detector
and the shim's ops run on the card's tensors there; each detection's labels
and UV are resampled on the device (densepose.py:284-360) and drawn on the
host with OpenCV, as in JAX.

Departure: nothing is fetched. The JAX preprocessor downloads a missing
export from its Hugging Face repository; here a missing file raises
``FileNotFoundError`` naming it and the preprocessor models dir.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, Frame, preprocessor_registry


@preprocessor_registry.register("densepose", aliases=("DenseposeDetector",))
class DensePosePreprocessor(BasePreprocessor):
    """DensePose part-label map. Weights: ``densepose_r50_fpn_dl.torchscript``
    in the preprocessor models dir, or ``model_path``."""

    name = "densepose"
    hf_repo = "LayerNorm/DensePose-TorchScript-with-hint-image"
    filename = "densepose_r50_fpn_dl.torchscript"
    params_schema = {"detect_resolution": 512, "cmap": "viridis"}
    N_PART_LABELS = 24

    def __init__(self, model_path: Optional[str] = None):
        self._model = None
        self._model_path = model_path

    def setup(self) -> None:
        if self._model is not None:
            return
        from apex_studio_tpu_torch.device import resolve_device
        from apex_studio_tpu_torch.preprocess.torch_shim import install_torchvision_ops
        from apex_studio_tpu_torch.preprocess.weights import find_local
        from apex_studio_tpu_torch.utils.defaults import get_preprocessor_models_path

        if not install_torchvision_ops():
            raise RuntimeError("densepose: could not provide torchvision::nms / roi_align")
        path = self._model_path or find_local(self.filename.rsplit(".", 1)[0], filename=self.filename)
        if path is None:
            raise FileNotFoundError(f"no '{self.filename}' under {get_preprocessor_models_path()}: place the "
                                    f"published export there (nothing is fetched)")
        self._dev = resolve_device(self.device)
        self._model = torch.jit.load(str(path), map_location=self._dev).eval()

    @staticmethod
    def _resample_instance(box_xyxy, coarse, fine, u, v):
        """One detection → (x, y, w, h, labels [h, w] uint8, uv [2, h, w])."""
        x0, y0, x1, y1 = [float(t) for t in box_xyxy]
        x, y = int(x0), int(y0)
        w, h = max(int(x1 - x0), 1), max(int(y1 - y0), 1)

        def up(t):
            return F.interpolate(t, (h, w), mode="bilinear", align_corners=False)

        labels = (up(fine).argmax(dim=1) * (up(coarse).argmax(dim=1) > 0).long())[0]
        u_up, v_up = up(u)[0], up(v)[0]
        idx = labels.clamp(min=0)[..., None]
        uv = torch.stack([torch.gather(u_up.permute(1, 2, 0), 2, idx)[..., 0],
                          torch.gather(v_up.permute(1, 2, 0), 2, idx)[..., 0]])
        uv = uv * (labels > 0)[None]
        return x, y, w, h, labels.to(torch.uint8).cpu().numpy(), uv.cpu().numpy()

    def process_frame(self, frame: Frame, detect_resolution: int = 512, cmap: str = "viridis", **_) -> Frame:
        import cv2

        h0, w0 = frame.shape[:2]
        k = float(detect_resolution) / float(min(h0, w0))
        ht, wt = int(round(h0 * k)), int(round(w0 * k))
        img = cv2.resize(np.asarray(frame)[..., :3], (wt, ht), interpolation=cv2.INTER_CUBIC if k > 1 else
                         cv2.INTER_AREA)
        img = np.pad(img, [[0, (-ht) % 64], [0, (-wt) % 64], [0, 0]], mode="edge")
        canvas = np.zeros((img.shape[0], img.shape[1], 3), np.uint8)
        with torch.no_grad():
            boxes, coarse, fine, u, v = self._model(torch.from_numpy(img).permute(2, 0, 1).to(self._dev))
            boxes = boxes.cpu()
            cv_map = cv2.COLORMAP_VIRIDIS if cmap == "viridis" else cv2.COLORMAP_PARULA
            for i in range(len(boxes)):
                x, y, w, h, labels, _uv = self._resample_instance(boxes[i], coarse[i:i + 1], fine[i:i + 1],
                                                                  u[i:i + 1], v[i:i + 1])
                scaled = np.clip(labels.astype(np.float32) * (255.0 / self.N_PART_LABELS), 0, 255).astype(np.uint8)
                vis = cv2.applyColorMap(scaled, cv_map)
                ys, ye = max(y, 0), min(y + h, canvas.shape[0])
                xs, xe = max(x, 0), min(x + w, canvas.shape[1])
                if ye <= ys or xe <= xs:
                    continue
                m = labels[ys - y:ye - y, xs - x:xe - x] > 0
                canvas[ys:ye, xs:xe][m] = vis[ys - y:ye - y, xs - x:xe - x][m]
        out = cv2.cvtColor(canvas, cv2.COLOR_BGR2RGB)
        if cmap == "viridis":  # the reference paints the background viridis' zero colour
            out[(out == 0).all(axis=-1)] = (68, 1, 84)
        return cv2.resize(out[:ht, :wt], (w0, h0), interpolation=cv2.INTER_NEAREST)

