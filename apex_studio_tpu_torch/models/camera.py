"""Camera-pose conditioning for Wan ReCamMaster (port of
``apex_studio_tpu/models/camera.py``, pure numpy, kept as the port's own
copy): camera extrinsics (a JSON trajectory file, a raw (F, 3, 4) / (F, 12)
or (F, 4, 4) array, or a named preset) → the per-latent-frame 12-value
relative-pose embedding the ReCam DiT takes.
"""

from __future__ import annotations

import json
import math
from typing import Any, Optional

import numpy as np

def _relative_pose(c2ws: np.ndarray) -> np.ndarray:
    """(F, 4, 4) cam-to-world → (F, 12) pose relative to the first frame
    (helpers/wan/recam.py:28 get_relative_pose)."""
    inv0 = np.linalg.inv(c2ws[0])
    rel = np.einsum("ij,fjk->fik", inv0, c2ws)
    return rel[:, :3, :].reshape(len(c2ws), 12).astype(np.float32)


def _preset(name: str, frames: int) -> np.ndarray:
    """Built-in trajectories when no extrinsics file is given."""
    t = np.linspace(0.0, 1.0, frames)
    c2ws = np.tile(np.eye(4, dtype=np.float64)[None], (frames, 1, 1))
    if name in ("zoom_in", "1"):
        c2ws[:, 2, 3] = -t
    elif name in ("zoom_out", "2"):
        c2ws[:, 2, 3] = t
    elif name in ("pan_left", "3"):
        c2ws[:, 0, 3] = -t
    elif name in ("pan_right", "4"):
        c2ws[:, 0, 3] = t
    elif name in ("tilt_up", "5"):
        c2ws[:, 1, 3] = t
    elif name in ("orbit", "6"):
        ang = t * math.pi / 4
        for i, a in enumerate(ang):
            c2ws[i, 0, 0] = c2ws[i, 2, 2] = math.cos(a)
            c2ws[i, 0, 2] = math.sin(a)
            c2ws[i, 2, 0] = -math.sin(a)
            c2ws[i, 0, 3] = math.sin(a)
    return c2ws


class WanRecamCameraEmbedder:
    """camera spec → (1, F_lat, 12) relative-pose embedding."""

    def __init__(self, cam_type: Any = 1, temporal_scale: int = 4):
        self.cam_type = cam_type
        self.temporal_scale = temporal_scale

    def __call__(self, camera: Any, num_frames: int,
                 cam_type: Optional[Any] = None) -> np.ndarray:
        cam_type = cam_type if cam_type is not None else self.cam_type
        f_lat = (num_frames - 1) // self.temporal_scale + 1
        if isinstance(camera, np.ndarray):
            arr = camera.reshape(camera.shape[0], -1).astype(np.float32)
            if arr.shape[-1] == 16:
                return _relative_pose(camera.reshape(-1, 4, 4))[None, :f_lat]
            return arr[None, :f_lat]
        if isinstance(camera, str) and camera.endswith(".json"):
            with open(camera) as f:
                data = json.load(f)
            idx = list(range(num_frames))[:: self.temporal_scale]
            mats = []
            for i in idx:
                m = data[f"frame{i}"][f"cam{int(cam_type):02d}"]
                vals = [float(v) for v in str(m).replace("[", " ")
                        .replace("]", " ").split()] if isinstance(m, str) \
                    else np.asarray(m, np.float64).reshape(-1).tolist()
                mats.append(np.asarray(vals, np.float64).reshape(4, 4)
                            if len(vals) == 16
                            else np.vstack([np.asarray(vals).reshape(3, 4),
                                            [0, 0, 0, 1]]))
            return _relative_pose(np.stack(mats))[None, :f_lat]
        # named / numeric preset
        c2ws = _preset(str(camera), f_lat)
        return _relative_pose(c2ws)[None]
