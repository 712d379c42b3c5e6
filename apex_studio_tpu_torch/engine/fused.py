"""The denoise step: forward, optional CFG and the scheduler's update (port
of ``apex_studio_tpu/engine/fused.py`` ``build_euler_step``,
``build_unipc_step`` and ``init_unipc_carry``).

The JAX step is one jitted program with the latents (and UniPC's carry)
donated. PyTorch runs eagerly, so here the step is a plain function; it
updates the f32 latents and carry in place, which is what the donation buys
on the TPU.

- Euler family: ``x ← x + (σ' − σ)·v``.
- UniPC: the predictor-corrector is linear in (sample, x0 history, x0_i), so
  the update is two small linear combinations whose weights the scheduler
  precomputes on the host in float64 (``FlowUniPCMultistepScheduler.fused_plan``).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

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


def build_unipc_step(apply: Callable, solver_order: int) -> Callable:
    """``apply(x, *cond) -> v`` (post-CFG velocity) → ``step(x, hist, last,
    sigma, use_corr, corr_w, pred_w, *cond) -> x``. ``hist`` is the
    ``[K, *latent]`` f32 x0 history (index K−1 newest) and ``last`` the
    previous corrected sample, both updated in place; the weights are one
    entry of ``fused_plan()``. All arithmetic is f32."""
    K = solver_order

    def step(x: torch.Tensor, hist: torch.Tensor, last: torch.Tensor, sigma, use_corr,
             corr_w: Sequence[float], pred_w: Sequence[float], *cond) -> torch.Tensor:
        v = apply(x, *cond).float()
        x32 = x.float()
        x0 = x32 - float(sigma) * v
        cw, pw = [float(w) for w in corr_w], [float(w) for w in pred_w]
        # use_corr·corr + (1 − use_corr)·x, use_corr being 0 or 1
        sample = cw[0] * last + _weighted_sum(cw[1:K + 1], hist) + cw[K + 1] * x0 if float(use_corr) else x32
        last.copy_(sample)
        for j in range(K - 1):
            hist[j].copy_(hist[j + 1])
        hist[K - 1].copy_(x0)
        return x.copy_(pw[0] * last + _weighted_sum(pw[1:], hist))

    return step


def _weighted_sum(weights: Sequence[float], stack: torch.Tensor) -> torch.Tensor:
    """Σ_k w_k·stack[k], left to right (``jnp.tensordot(w, stack, axes=1)``)."""
    out = weights[0] * stack[0]
    for w, t in zip(weights[1:], stack[1:]):
        out = out + w * t
    return out


def init_unipc_carry(latents: torch.Tensor, solver_order: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-filled f32 (hist, last_sample) carry for :func:`build_unipc_step`."""
    hist = torch.zeros((solver_order, *latents.shape), dtype=torch.float32, device=latents.device)
    return hist, torch.zeros(latents.shape, dtype=torch.float32, device=latents.device)


def cfg_combine(pos: torch.Tensor, neg: torch.Tensor, g: float) -> torch.Tensor:
    """Classifier-free guidance in f32: neg + g·(pos − neg)."""
    pos, neg = pos.float(), neg.float()
    return neg + g * (pos - neg)
