"""Flow-matching Euler samplers (port of ``apex_studio_tpu/schedulers/flow_match.py``):

- ``FlowMatchEulerDiscreteScheduler``: diffusers-config-compatible, with static
  or dynamic (resolution-dependent) time shifting (Flux);
- ``FlowMatchDiscreteScheduler``: HunyuanVideo's, linspace(1→0, n+1) then the
  SD3 shift;
- ``FlowMatchScheduler``: Wan's, with a ``sigma_min`` floor and the
  ``extra_one_step`` grid (the causal Self-Forcing manifest's scheduler), and
  ``FlowMatchPairScheduler``, the same with an exponential shift and a
  (visual, audio) pairing interface.

All of them integrate dx/dsigma = v with Euler steps: x ← x + (σ_next − σ)·v.
"""

from __future__ import annotations

import math
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


@scheduler_registry.register("FlowMatchScheduler")
class FlowMatchScheduler(SchedulerBase):
    """Wan's flow sampler with a ``sigma_min`` floor and ``extra_one_step`` grids."""

    def __init__(
        self,
        num_inference_steps: int = 100,
        num_train_timesteps: int = 1000,
        shift: float = 3.0,
        sigma_max: float = 1.0,
        sigma_min: float = 0.003 / 1.002,
        inverse_timesteps: bool = False,
        extra_one_step: bool = False,
        reverse_sigmas: bool = False,
        **_: object,
    ):
        super().__init__(num_train_timesteps=num_train_timesteps, shift=shift, sigma_max=sigma_max,
                         sigma_min=sigma_min, inverse_timesteps=inverse_timesteps,
                         extra_one_step=extra_one_step, reverse_sigmas=reverse_sigmas)
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.sigma_max = sigma_max
        self.sigma_min = sigma_min
        self.inverse_timesteps = inverse_timesteps
        self.extra_one_step = extra_one_step
        self.reverse_sigmas = reverse_sigmas
        self.set_timesteps(num_inference_steps)

    def _grid(self, num_inference_steps: int, denoising_strength: float) -> np.ndarray:
        sigma_start = self.sigma_min + (self.sigma_max - self.sigma_min) * denoising_strength
        if self.extra_one_step:
            grid = np.linspace(sigma_start, self.sigma_min, num_inference_steps + 1, dtype=np.float64)[:-1]
        else:
            grid = np.linspace(sigma_start, self.sigma_min, num_inference_steps, dtype=np.float64)
        return grid[::-1] if self.inverse_timesteps else grid

    @property
    def _terminal(self) -> float:
        return 1.0 if (self.inverse_timesteps or self.reverse_sigmas) else 0.0

    def _set_grid(self, num_inference_steps: int, grid: np.ndarray) -> None:
        if self.reverse_sigmas:
            grid = 1.0 - grid
        self.num_inference_steps = num_inference_steps
        self.sigmas = np.concatenate([grid, [self._terminal]])
        self.timesteps = (grid * self.num_train_timesteps).astype(np.float32)
        self._step_index = None

    def set_timesteps(self, num_inference_steps: int = 100, denoising_strength: float = 1.0,
                      shift: Optional[float] = None, **_: object) -> None:
        grid = shift_sigmas(self._grid(num_inference_steps, denoising_strength),
                            shift if shift is not None else self.shift)
        self._set_grid(num_inference_steps, grid)

    def step(self, model_output, timestep, sample, to_final: bool = False, **_: object):
        i = self.index_for_timestep(float(np.asarray(timestep).reshape(-1)[0]))
        sigma = float(self.sigmas[i])
        sigma_next = self._terminal if (to_final or i + 1 >= len(self.timesteps)) else float(self.sigmas[i + 1])
        return (_euler_step(sample, model_output, sigma, sigma_next),)

    def step_at(self, model_output, sample, step_index: int):
        return _euler_step(sample, model_output, float(self.sigmas[step_index]),
                                float(self.sigmas[step_index + 1]))


@scheduler_registry.register("FlowMatchPairScheduler")
class FlowMatchPairScheduler(FlowMatchScheduler):
    """``FlowMatchScheduler`` with an optional exponential shift
    (σ' = e^μ / (e^μ + 1/σ − 1)) and a (t_visual, t_audio) pairing interface
    for joint audio-video engines: ``get_pairs()`` returns [N, 2] rows of
    (t, t), or of sigmas; the named postprocess ``dual_sigma_shift`` re-shifts
    each column with its own shift and denoising strength."""

    def __init__(self, *args, exponential_shift: bool = False, exponential_shift_mu: Optional[float] = None,
                 shift_terminal: Optional[float] = None, **kw):
        self.exponential_shift = exponential_shift
        self.exponential_shift_mu = exponential_shift_mu
        self.shift_terminal = shift_terminal
        self._pair_postprocess = None
        super().__init__(*args, **kw)

    def set_timesteps(self, num_inference_steps: int = 100, denoising_strength: float = 1.0,
                      shift: Optional[float] = None, **kw) -> None:
        if not (self.exponential_shift and self.exponential_shift_mu is not None):
            return super().set_timesteps(num_inference_steps, denoising_strength, shift, **kw)
        mu = self.exponential_shift_mu
        grid = math.exp(mu) / (math.exp(mu) + (1.0 / self._grid(num_inference_steps, denoising_strength) - 1.0))
        if self.shift_terminal is not None:
            one_minus = 1.0 - grid
            grid = 1.0 - one_minus / (one_minus[-1] / (1.0 - self.shift_terminal))
        self._set_grid(num_inference_steps, grid)

    def set_pair_postprocess(self, fn) -> None:
        if fn is not None and not callable(fn):
            raise TypeError("pair_postprocess must be callable or None")
        self._pair_postprocess = fn

    def set_pair_postprocess_by_name(self, name: Optional[str], **kw) -> None:
        if name is None or str(name).lower() in ("none", "off", "false", "no"):
            self._pair_postprocess = None
            return
        if name != "dual_sigma_shift":
            raise ValueError(f"unknown pair postprocess {name!r}")
        shifts = (float(kw.get("visual_shift", self.shift)), float(kw.get("audio_shift", self.shift)))
        strengths = (float(kw.get("visual_denoising_strength", 1.0)),
                     float(kw.get("audio_denoising_strength", 1.0)))

        def column(shift, strength, n):
            s = FlowMatchScheduler(num_inference_steps=n, num_train_timesteps=self.num_train_timesteps,
                                   shift=shift, sigma_max=self.sigma_max, sigma_min=self.sigma_min,
                                   inverse_timesteps=self.inverse_timesteps, extra_one_step=self.extra_one_step,
                                   reverse_sigmas=self.reverse_sigmas)
            s.set_timesteps(n, denoising_strength=strength)
            return s

        def fn(pairs: np.ndarray, source: str = "timesteps") -> np.ndarray:
            n = pairs.shape[0]
            cols = [column(sh, st, n) for sh, st in zip(shifts, strengths)]
            if source == "sigmas":
                return np.stack([c.sigmas[:n] for c in cols], axis=1)
            return np.stack([c.timesteps[:n] for c in cols], axis=1)

        self._pair_postprocess = fn

    def get_pairs(self, source: str = "timesteps") -> np.ndarray:
        base = self.sigmas[:-1] if source == "sigmas" else self.timesteps
        pairs = np.stack([base, base], axis=1).astype(np.float64)
        if self._pair_postprocess is not None:
            out = np.asarray(self._pair_postprocess(pairs, source=source))
            if out.shape != pairs.shape:
                raise ValueError("pair postprocess changed the pairs shape")
            return out
        return pairs
