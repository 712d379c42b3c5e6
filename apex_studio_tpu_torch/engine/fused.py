"""The denoise step: forward, optional CFG, Euler update (port of
``apex_studio_tpu/engine/fused.py`` ``build_euler_step``).

The JAX step is one jitted program with the latents donated. PyTorch runs
eagerly, so here the step is a plain function; it updates the f32 latents in
place, which is what the donation buys on the TPU.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def build_euler_step(apply: Callable) -> Callable:
    """``apply(x, *cond) -> v`` (post-CFG velocity) → ``step(x, sigma,
    sigma_next, *cond) -> x``, with ``x ← x + (σ' − σ)·v`` computed in f32 and
    written into ``x``."""

    def step(x: torch.Tensor, sigma: float, sigma_next: float, *cond) -> torch.Tensor:
        v = apply(x, *cond).float()
        # the JAX step traces both sigmas as f32 scalars and subtracts them there
        dt = float(np.float32(sigma_next) - np.float32(sigma))
        if x.dtype == torch.float32:
            return x.add_(v.mul_(dt))
        return x.copy_(x.float() + dt * v)

    return step


def cfg_combine(pos: torch.Tensor, neg: torch.Tensor, g: float) -> torch.Tensor:
    """Classifier-free guidance in f32: neg + g·(pos − neg)."""
    pos, neg = pos.float(), neg.float()
    return neg + g * (pos - neg)
