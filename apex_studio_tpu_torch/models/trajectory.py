"""Trajectory conditioning for Wan ATI ("Any Trajectory Instruction"), port
of ``apex_studio_tpu/models/trajectory.py``.

Sparse point tracks are normalised and resampled from 24 fps capture to the
model's 16 fps frame grid (``process_tracks``, numpy), then painted into the
i2v condition latent (``patch_motion``, torch): each later latent frame gets
a soft splat of the first frame's features at the tracked positions (a
gaussian in short-edge-normalised screen space, the top-k nearest tracks a
pixel), and the mask channels carry the splat weight. It runs once a
request on latent-sized tensors, in f32 on the condition's device.
"""

from __future__ import annotations

import io
from typing import Tuple, Union

import numpy as np
import torch


def unzip_to_array(data: bytes, key: str = "array") -> np.ndarray:
    """npz bytes → array."""
    with np.load(io.BytesIO(data)) as z:
        return z[key]


def process_tracks(tracks_np: np.ndarray, frame_size: Tuple[int, int], quant_multi: int = 8) -> np.ndarray:
    """Raw captured tracks → (rows, N, 4) model tracks ``[trange, x, y,
    visible]``: coordinates centred and scaled by the short edge, visibility
    mapped to ±1, and 121 capture rows (24 fps) resampled to 1 + 80."""
    tracks = np.asarray(tracks_np, np.float32) / float(quant_multi)
    if tracks.ndim == 4 and tracks.shape[1] == 121:
        tracks = tracks.transpose(1, 0, 2, 3)
    xy, visible = tracks[..., :2], tracks[..., 2:3]
    short_edge = float(min(frame_size))
    xy = (xy - np.asarray(frame_size, np.float32) / 2.0) / short_edge * 2.0
    visible = visible * 2.0 - 1.0
    T = xy.shape[0]
    trange = np.linspace(-1.0, 1.0, T, dtype=np.float32).reshape((-1,) + (1,) * (visible.ndim - 1)) \
        * np.ones_like(visible)
    out = np.concatenate([trange, xy, visible], axis=-1).reshape(T, -1, 4)
    if T == 121:  # 24 fps capture → the 16 fps grid (1 + 80 rows)
        head, tail = out[:1], out[1:]
        tail = np.repeat(tail, 2, axis=0)[1::3]
        out = np.concatenate([head, tail], axis=0)
    return out


def _bilinear_sample(feat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(C, H, W) features at (N, 2) normalised [-1, 1] (x, y) points → (N, C):
    ``grid_sample`` with ``align_corners=False`` and zero padding, written
    out corner by corner as the JAX function is."""
    _, H, W = feat.shape
    ix = (xy[:, 0] + 1.0) * 0.5 * W - 0.5
    iy = (xy[:, 1] + 1.0) * 0.5 * H - 0.5
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx, wy = ix - x0, iy - y0
    out = torch.zeros(xy.shape[0], feat.shape[0], dtype=feat.dtype, device=feat.device)
    for dx, dy, w in ((0, 0, (1 - wx) * (1 - wy)), (1, 0, wx * (1 - wy)), (0, 1, (1 - wx) * wy), (1, 1, wx * wy)):
        xi = (x0 + dx).long()
        yi = (y0 + dy).long()
        valid = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).to(feat.dtype)
        out = out + feat[:, yi.clamp(0, H - 1), xi.clamp(0, W - 1)].T * (w * valid)[:, None]
    return out


def patch_motion(
    tracks: torch.Tensor,
    vid: torch.Tensor,
    temperature: float = 220.0,
    vae_divide: Tuple[int, int] = (4, 16),
    topk: int = 2,
    frames_per_latent: int = 4,
) -> torch.Tensor:
    """Paint sparse track motion into the i2v condition latent.

    ``tracks`` (rows, N, 4) from :func:`process_tracks`, rows = 1 +
    ``frames_per_latent``·(T − 1); ``vid`` (mask + z, T, H, W), the mask
    channels first. Returns the same shape as ``vid``, f32."""
    n_mask, _ = vae_divide
    vid = vid.float()
    tracks = tracks.to(device=vid.device, dtype=torch.float32)
    _, T, H, W = vid.shape
    N = tracks.shape[1]
    xy, visible = tracks[..., 1:3], tracks[..., 3:4]
    short = float(min(H, W))
    tracks_n = torch.clamp(xy / torch.tensor([W / short, H / short], device=vid.device), -1.0, 1.0)
    visible = visible.clamp(0.0, 1.0)

    # the pixel grid in short-edge-normalised (x, y)
    xx = torch.linspace(-W / short, W / short, W, device=vid.device)
    yy = torch.linspace(-H / short, H / short, H, device=vid.device)
    gy, gx = torch.meshgrid(yy, xx, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)  # (H, W, 2)

    # the pixel-frame rows that share a latent frame, averaged over their visible rows
    f = frames_per_latent
    tracks_pad = tracks_n[1:].reshape(T - 1, f, N, 2)
    visible_pad = visible[1:].reshape(T - 1, f, N, 1)
    visible_align = visible_pad.sum(1)  # (T-1, N, 1)
    tracks_align = (tracks_pad * visible_pad).sum(1) / (visible_align + 1e-5)

    dist = ((tracks_align[:, None, None] - grid[None, :, :, None]) ** 2).sum(-1)  # (T-1, H, W, N)
    weight = torch.exp(-dist * temperature) * visible_align.clamp(0.0, 1.0).reshape(T - 1, 1, 1, N)
    vert_weight, vert_index = torch.topk(weight, min(topk, N), dim=-1)  # (T-1, H, W, k)

    point_feature = _bilinear_sample(vid[n_mask:, 0], tracks_n[0])  # (N, C)
    out_feature = (point_feature[vert_index] * vert_weight[..., None]).sum(-2)  # (T-1, H, W, C)
    out_feature = out_feature.permute(3, 0, 1, 2)  # (C, T-1, H, W)
    out_weight = vert_weight.sum(-1)  # (T-1, H, W)

    mix = out_feature + vid[n_mask:, 1:] * (1.0 - out_weight.clamp(0.0, 1.0))
    feature_full = torch.cat([vid[n_mask:, :1], mix], dim=1)
    mask_full = torch.cat([torch.ones_like(out_weight[:1]), out_weight], dim=0)  # (T, H, W)
    return torch.cat([mask_full[None].expand(n_mask, T, H, W), feature_full], dim=0)


def prepare_tracks(trajectory: Union[str, bytes, np.ndarray], width: int, height: int,
                   quant_multi: int = 8) -> np.ndarray:
    """An .npz path, npz bytes, raw (T, N, 3) pixel tracks or processed
    (rows, N, 4) tracks → (rows, N, 4)."""
    if isinstance(trajectory, (str, bytes)):
        if isinstance(trajectory, bytes):
            data = trajectory
        else:
            with open(trajectory, "rb") as f:
                data = f.read()
        trajectory = unzip_to_array(data)
    arr = np.asarray(trajectory, np.float32)
    if arr.ndim >= 3 and arr.shape[-1] == 4:  # already processed
        return arr.reshape(arr.shape[0], -1, 4)
    return process_tracks(arr, (width, height), quant_multi=quant_multi)
