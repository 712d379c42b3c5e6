"""Rectified-flow scheduler, the LTX-Video sampler (port of
``apex_studio_tpu/schedulers/rectified_flow.py``).

- timesteps ARE sigmas in [0, 1]; the LTX transformer scales them by 1000
- samplers: "Uniform" (linspace 1 → 1/n), "LinearQuadratic" (a linear ramp
  to a threshold noise, then a quadratic tail) and "Constant" (exp-μ time
  shift)
- resolution-dependent shifting: "SD3" token-count shift with optional
  terminal stretching, or the SimpleDiffusion log-SNR shift
- Euler updates on the flow velocity, per token where conditioning tokens
  sit at their own noise level (``step_tokens``)

The grids are float64 numpy on the host; a step is element-wise torch math
on the latents' device.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.schedulers.base import SchedulerBase, scheduler_registry


def linear_quadratic_schedule(
    num_steps: int, threshold_noise: float = 0.025, linear_steps: Optional[int] = None
) -> np.ndarray:
    """Descending sigma grid 1 → … of n entries (no trailing 0): a linear
    head, then a quadratic tail in t."""
    if num_steps == 1:
        return np.array([1.0])
    ls = linear_steps if linear_steps is not None else num_steps // 2
    linear = [i * threshold_noise / ls for i in range(ls)]
    diff = ls - threshold_noise * num_steps
    qs = num_steps - ls
    qcoef = diff / (ls * qs**2)
    lcoef = threshold_noise / ls - 2 * diff / qs**2
    const = qcoef * ls**2
    quad = [qcoef * i**2 + lcoef * i + const for i in range(ls, num_steps)]
    t = np.array(linear + quad, dtype=np.float64)
    return 1.0 - t


def token_shift(n_tokens: int, min_tokens=1024, max_tokens=4096,
                min_shift=0.95, max_shift=2.05) -> float:
    m = (max_shift - min_shift) / (max_tokens - min_tokens)
    return m * n_tokens + (min_shift - m * min_tokens)


def time_shift(mu: float, sigma: float, t: np.ndarray) -> np.ndarray:
    return math.exp(mu) / (math.exp(mu) + (1.0 / np.maximum(t, 1e-9) - 1.0) ** sigma)


def stretch_to_terminal(sigmas: np.ndarray, terminal: float) -> np.ndarray:
    one_minus = 1.0 - sigmas
    scale = one_minus[-1] / (1.0 - terminal)
    return 1.0 - one_minus / scale


def _euler(sample: torch.Tensor, model_output: torch.Tensor, dt) -> torch.Tensor:
    return (sample.float() - dt * model_output.float()).to(sample.dtype)


@scheduler_registry.register("RectifiedFlowScheduler", aliases=("rf",))
class RectifiedFlowScheduler(SchedulerBase):
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        shifting: Optional[str] = None,  # None | "SD3" | "SimpleDiffusion"
        base_resolution: int = 32 * 32,
        target_shift_terminal: Optional[float] = None,
        sampler: str = "Uniform",  # "Uniform" | "LinearQuadratic" | "Constant"
        shift: Optional[float] = None,
        **_: object,
    ):
        super().__init__(
            num_train_timesteps=num_train_timesteps, shifting=shifting,
            base_resolution=base_resolution, target_shift_terminal=target_shift_terminal,
            sampler=sampler, shift=shift,
        )
        self.num_train_timesteps = num_train_timesteps
        self.shifting = shifting
        self.base_resolution = base_resolution
        self.target_shift_terminal = target_shift_terminal
        self.sampler = sampler
        self.shift = shift

    def _initial_grid(self, n: int) -> np.ndarray:
        if self.sampler == "LinearQuadratic":
            return linear_quadratic_schedule(n)
        grid = np.linspace(1.0, 1.0 / n, n)
        if self.sampler == "Constant":
            assert self.shift is not None, "Constant sampler requires shift"
            return time_shift(self.shift, 1.0, grid)
        return grid

    def _apply_shift(self, sigmas: np.ndarray, n_tokens: Optional[int]) -> np.ndarray:
        if self.shifting == "SD3":
            mu = math.log(token_shift(n_tokens or self.base_resolution))
            out = math.exp(mu) / (math.exp(mu) + (1.0 / np.maximum(sigmas, 1e-9) - 1.0))
            if self.target_shift_terminal:
                out = stretch_to_terminal(out, self.target_shift_terminal)
            return out
        if self.shifting == "SimpleDiffusion":
            m = n_tokens or self.base_resolution
            snr = (sigmas / np.maximum(1.0 - sigmas, 1e-9)) ** 2
            shifted = np.log(np.maximum(snr, 1e-30)) + 2 * math.log(m / self.base_resolution)
            return 1.0 / (1.0 + np.exp(-0.5 * shifted))
        return sigmas

    def set_timesteps(
        self,
        num_inference_steps: int,
        n_tokens: Optional[int] = None,
        samples_shape=None,
        timesteps: Optional[List[float]] = None,
        **_: object,
    ) -> None:
        if timesteps is not None:
            grid = np.asarray(timesteps, np.float64)
            num_inference_steps = len(grid)
        else:
            num_inference_steps = min(self.num_train_timesteps, num_inference_steps)
            if samples_shape is not None and n_tokens is None:
                # token sequences are (b, s, c); dense latents (b, c, ...)
                n_tokens = (
                    int(samples_shape[1]) if len(samples_shape) == 3
                    else int(np.prod(samples_shape[2:]))
                )
            grid = self._apply_shift(self._initial_grid(num_inference_steps), n_tokens)
        self.num_inference_steps = num_inference_steps
        self.sigmas = np.concatenate([grid, [0.0]])
        self.timesteps = grid.astype(np.float32)
        self._step_index = None

    def step(self, model_output, timestep, sample, return_dict: bool = False, **_: object):
        if self._step_index is None:
            self._step_index = self._resolve_step_index(timestep)
        prev = self.step_at(model_output, sample, self._step_index)
        self._step_index += 1
        return {"prev_sample": prev} if return_dict else (prev,)

    def step_at(self, model_output, sample, step_index: int):
        # dt in f32, as the JAX step traces the Python float
        dt = float(np.float32(self.sigmas[step_index] - self.sigmas[step_index + 1]))
        return _euler(sample, model_output, dt)

    def step_tokens(self, model_output, t_tokens, sample):
        """Per-token Euler update: each token integrates from its own timestep
        down to the closest strictly lower grid point. ``t_tokens`` is
        [B, S] in [0, 1]."""
        grid = torch.as_tensor(np.concatenate([self.timesteps, [0.0]]).astype(np.float32), device=t_tokens.device)
        t = t_tokens.float()
        below = torch.where(grid[:, None, None] < t[None] - 1e-6, grid[:, None, None],
                            torch.zeros((), device=t.device))
        dt = (t - below.amax(dim=0))[..., None]
        return _euler(sample, model_output, dt)
