"""EasyCache-style step skipping for denoise loops (port of
``apex_studio_tpu/ops/easycache.py``).

When the transformer input changes slowly between steps, the forward is
skipped and the previous velocity reused, until the accumulated relative
input change crosses the threshold. The JAX step decides inside its jitted
program (``lax.cond``); eager PyTorch reads the decision on the host, one
scalar a step, and runs only the chosen branch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch


class EasyCacheState(NamedTuple):
    prev_input: torch.Tensor   # transformer input at the last step, f32
    prev_output: torch.Tensor  # last computed (or reused) velocity, f32
    accum: torch.Tensor        # accumulated relative input change since the last compute
    computed: int              # real forwards so far (telemetry)


def init_state(x_like: torch.Tensor, v_like: torch.Tensor) -> EasyCacheState:
    return EasyCacheState(
        prev_input=torch.zeros_like(x_like, dtype=torch.float32),
        prev_output=torch.zeros_like(v_like, dtype=torch.float32),
        accum=torch.tensor(float("inf"), dtype=torch.float32, device=x_like.device),  # compute first
        computed=0,
    )


def cached_step(
    forward: Callable[[torch.Tensor], torch.Tensor],
    x_in: torch.Tensor,
    state: EasyCacheState,
    thresh: float,
    force_compute: bool,
) -> Tuple[torch.Tensor, EasyCacheState]:
    """One denoise forward with the skip rule. ``force_compute`` covers the
    warm-up and the last steps (the reference's ret_steps)."""
    # the caller updates its latents, and the Euler step its velocity, in
    # place: the state keeps copies of its own
    x32 = x_in.to(torch.float32, copy=True)
    denom = state.prev_input.abs().mean().clamp_min(1e-6)
    rel = (x32 - state.prev_input).abs().mean() / denom
    accum = state.accum + rel
    skip = (not force_compute) and bool(accum < thresh)
    v = state.prev_output.clone() if skip else forward(x_in).float()
    return v, EasyCacheState(
        prev_input=x32,
        prev_output=v.clone(),
        accum=accum if skip else torch.zeros_like(accum),
        computed=state.computed + (0 if skip else 1),
    )
