"""Flow-matching Euler samplers (port of ``apex_studio_tpu/schedulers/flow_match.py``):

- ``FlowMatchEulerDiscreteScheduler``: diffusers-config-compatible, with static
  or dynamic (resolution-dependent) time shifting (Flux);
- ``FlowMatchDiscreteScheduler``: HunyuanVideo's, linspace(1→0, n+1) then the
  SD3 shift.

Both integrate dx/dsigma = v with Euler steps: x ← x + (σ_next − σ)·v.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from apex_studio_tpu_torch.schedulers.base import (
    SchedulerBase,
    compute_dynamic_shift_mu,
    exponential_time_shift,
    scheduler_registry,
    shift_sigmas,
)


def _euler_step(sample: torch.Tensor, model_output: torch.Tensor, sigma: float, sigma_next: float):
    # Upcast: bf16 accumulation across 30+ steps visibly drifts. dt is taken
    # between the two sigmas rounded to f32, as the JAX step traces them.
    dt = float(np.float32(sigma_next) - np.float32(sigma))
    return (sample.float() + dt * model_output.float()).to(sample.dtype)


@scheduler_registry.register("FlowMatchEulerDiscreteScheduler", default=True)
class FlowMatchEulerDiscreteScheduler(SchedulerBase):
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        shift: float = 1.0,
        use_dynamic_shifting: bool = False,
        base_shift: float = 0.5,
        max_shift: float = 1.15,
        base_image_seq_len: int = 256,
        max_image_seq_len: int = 4096,
        invert_sigmas: bool = False,
        shift_terminal: Optional[float] = None,
        use_karras_sigmas: bool = False,
        use_exponential_sigmas: bool = False,
        use_beta_sigmas: bool = False,
        time_shift_type: str = "exponential",
        stochastic_sampling: bool = False,
        **_: object,
    ):
        super().__init__(
            num_train_timesteps=num_train_timesteps,
            shift=shift,
            use_dynamic_shifting=use_dynamic_shifting,
            base_shift=base_shift,
            max_shift=max_shift,
            base_image_seq_len=base_image_seq_len,
            max_image_seq_len=max_image_seq_len,
            invert_sigmas=invert_sigmas,
            shift_terminal=shift_terminal,
            time_shift_type=time_shift_type,
        )
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.use_dynamic_shifting = use_dynamic_shifting
        self.time_shift_type = time_shift_type
        # Training-grid sigmas (t/T shifted), exposed before set_timesteps.
        t = np.arange(1, num_train_timesteps + 1, dtype=np.float64)[::-1] / num_train_timesteps
        if not use_dynamic_shifting:
            t = shift_sigmas(t, shift)
        self.sigmas = np.concatenate([t, [0.0]])
        self.timesteps = (t * num_train_timesteps).astype(np.float32)

    def set_timesteps(
        self,
        num_inference_steps: int,
        mu: Optional[float] = None,
        sigmas: Optional[np.ndarray] = None,
        image_seq_len: Optional[int] = None,
        **_: object,
    ) -> None:
        self.num_inference_steps = num_inference_steps
        if sigmas is None:
            sigmas = np.linspace(1.0, 1.0 / self.num_train_timesteps, num_inference_steps, dtype=np.float64)
        else:
            sigmas = np.asarray(sigmas, dtype=np.float64)

        if self.use_dynamic_shifting:
            if mu is None:
                if image_seq_len is None:
                    raise ValueError("dynamic shifting requires `mu` or `image_seq_len`")
                mu = compute_dynamic_shift_mu(
                    image_seq_len,
                    self.config["base_image_seq_len"],
                    self.config["max_image_seq_len"],
                    self.config["base_shift"],
                    self.config["max_shift"],
                )
            if self.time_shift_type == "exponential":
                sigmas = exponential_time_shift(mu, 1.0, sigmas)
            else:  # linear
                sigmas = np.exp(mu) / (np.exp(mu) + 1.0 / np.maximum(sigmas, 1e-12) - 1.0)
        else:
            sigmas = shift_sigmas(sigmas, self.shift)

        terminal = self.config.get("shift_terminal")
        if terminal:
            # Stretch the grid so the final non-zero sigma lands on `terminal`.
            one_minus = 1.0 - sigmas
            scale = one_minus[-1] / (1.0 - terminal)
            sigmas = 1.0 - one_minus / scale
        self.timesteps = (sigmas * self.num_train_timesteps).astype(np.float32)
        if self.config.get("invert_sigmas"):
            sigmas = 1.0 - sigmas
            self.timesteps = (sigmas * self.num_train_timesteps).astype(np.float32)
            self.sigmas = np.concatenate([sigmas, [1.0]])
        else:
            self.sigmas = np.concatenate([sigmas, [0.0]])
        self._step_index = None

    def step(self, model_output, timestep, sample, return_dict: bool = False, **_: object):
        if self._step_index is None:
            self._step_index = self._resolve_step_index(timestep)
        i = self._step_index
        prev = _euler_step(sample, model_output, float(self.sigmas[i]), float(self.sigmas[i + 1]))
        self._step_index += 1
        return {"prev_sample": prev} if return_dict else (prev,)

    def step_at(self, model_output, sample, step_index: int):
        """Stateless indexed step."""
        return _euler_step(
            sample, model_output, float(self.sigmas[step_index]), float(self.sigmas[step_index + 1])
        )


@scheduler_registry.register("FlowMatchDiscreteScheduler")
class FlowMatchDiscreteScheduler(SchedulerBase):
    """HunyuanVideo's Euler variant: linspace(1→0, n+1) then the SD3 shift."""

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        shift: float = 1.0,
        reverse: bool = True,
        solver: str = "euler",
        **_: object,
    ):
        super().__init__(num_train_timesteps=num_train_timesteps, shift=shift, reverse=reverse)
        if solver != "euler":
            raise ValueError(f"unsupported solver {solver!r}")
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.reverse = reverse
        sigmas = np.linspace(1.0, 0.0, num_train_timesteps + 1, dtype=np.float64)
        if not reverse:
            sigmas = sigmas[::-1]
        self.sigmas = sigmas
        self.timesteps = (sigmas[:-1] * num_train_timesteps).astype(np.float32)

    def set_timesteps(self, num_inference_steps: int, shift: Optional[float] = None, **_: object) -> None:
        self.num_inference_steps = num_inference_steps
        sigmas = np.linspace(1.0, 0.0, num_inference_steps + 1, dtype=np.float64)
        sigmas = shift_sigmas(sigmas, shift if shift is not None else self.shift)
        if not self.reverse:
            sigmas = 1.0 - sigmas
        self.sigmas = sigmas
        self.timesteps = (sigmas[:-1] * self.num_train_timesteps).astype(np.float32)
        self._step_index = None

    def step(self, model_output, timestep, sample, return_dict: bool = False, **_: object):
        if self._step_index is None:
            self._step_index = self._resolve_step_index(timestep)
        i = self._step_index
        prev = _euler_step(sample, model_output, float(self.sigmas[i]), float(self.sigmas[i + 1]))
        self._step_index += 1
        return {"prev_sample": prev} if return_dict else (prev,)

    def step_at(self, model_output, sample, step_index: int):
        """Stateless indexed step."""
        return _euler_step(
            sample, model_output, float(self.sigmas[step_index]), float(self.sigmas[step_index + 1])
        )
