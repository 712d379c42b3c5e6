"""Spatially tiled decode for the 3D-causal video VAEs, port of
``apex_studio_tpu/models/vaes/tiling.py``.

A 720p × 121-frame decode held whole needs tens of GB of activations; tiles
of ``tile`` latent pixels with 25% overlap bound that by the tile. Tiles are
uniform (edge tiles shift inward, never shrink), seams blend with linear ramps
in pixel space, and the time axis stays whole (slicing the causal axis would
need conv-state carry). Each decoded tile is rounded to f16 before the f32
accumulation, as the JAX function hands its tiles back; that rounding is part
of the result. The accumulation stays on the latents' device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _ramp(n: int, ov: int, lead: bool, trail: bool) -> np.ndarray:
    wv = np.ones(n, np.float32)
    if lead:
        wv[:ov] = np.linspace(0.0, 1.0, ov, endpoint=False)
    if trail:
        wv[-ov:] = np.linspace(1.0, 0.0, ov, endpoint=False)
    return wv


def decode_tiled_3d(
    decode_fn: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,                # [B, C, T, H, W] latents
    spatial_scale: int,
    tile: int = 24,
    overlap: Optional[int] = None,
) -> torch.Tensor:
    """→ [B, out_ch, T_pix, H·s, W·s] in f32. ``decode_fn`` maps latent tiles
    to pixel tiles; overlap defaults to tile/4 (at least 2)."""
    b, c, t, h, w = z.shape
    if h <= tile and w <= tile:
        return decode_fn(z)
    if overlap is None:
        overlap = max(2, tile // 4)
    s = spatial_scale
    stride = tile - overlap
    out = None
    weight = torch.zeros((1, 1, 1, h * s, w * s), dtype=torch.float32, device=z.device)
    for y0 in range(0, max(h - overlap, 1), stride):
        for x0 in range(0, max(w - overlap, 1), stride):
            y1, x1 = min(y0 + tile, h), min(x0 + tile, w)
            y0a, x0a = max(0, y1 - tile), max(0, x1 - tile)  # uniform shape
            patch = decode_fn(z[:, :, :, y0a:y1, x0a:x1]).to(torch.float16).float()
            if out is None:
                out = torch.zeros((b, patch.shape[1], patch.shape[2], h * s, w * s),
                                  dtype=torch.float32, device=z.device)
            ph, pw = patch.shape[-2:]
            wy = _ramp(ph, overlap * s, lead=y0a > 0, trail=y1 < h)
            wx = _ramp(pw, overlap * s, lead=x0a > 0, trail=x1 < w)
            wmap = torch.from_numpy(wy[:, None] * wx[None, :]).to(z.device)
            region = (slice(None), slice(None), slice(None), slice(y0a * s, y1 * s), slice(x0a * s, x1 * s))
            out[region] += patch * wmap
            weight[region] += wmap
            del patch
    return out / weight.clamp_min(1e-6)
