"""CogVideoX DDIM scheduler (v-prediction, zero terminal SNR), port of
``apex_studio_tpu/schedulers/ddim.py``.

Scaled-linear betas, the CogVideoX SNR shift (``snr_shift_scale``), the
rescale of √ᾱ to zero terminal SNR, trailing timestep spacing and the
deterministic (η = 0) DDIM update from a v-prediction. The schedule's
scalars are host float64, as in JAX; the tensor math is f32.
"""

from __future__ import annotations

import numpy as np
import torch

from apex_studio_tpu_torch.schedulers.base import SchedulerBase, scheduler_registry


def rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift √ᾱ so the final timestep has exactly zero SNR."""
    s = np.sqrt(alphas_cumprod)
    s0, sT = s[0].copy(), s[-1].copy()
    s = s - sT
    s = s * s0 / (s0 - sT)
    return s**2


@scheduler_registry.register("CogVideoXDDIMScheduler", aliases=("DDIMScheduler", "ddim", "cogvideox_ddim"))
class CogVideoXDDIMScheduler(SchedulerBase):
    order = 1

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        snr_shift_scale: float = 3.0,
        rescale_betas_zero_snr: bool = True,
        prediction_type: str = "v_prediction",
        timestep_spacing: str = "trailing",
        **_: object,
    ):
        super().__init__(num_train_timesteps=num_train_timesteps, beta_start=beta_start, beta_end=beta_end,
                         prediction_type=prediction_type)
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.timestep_spacing = timestep_spacing
        if beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps) ** 2
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps)
        else:
            raise ValueError(f"unsupported beta_schedule {beta_schedule!r}")
        ac = np.cumprod(1.0 - betas, axis=0)
        ac = ac / (snr_shift_scale - (snr_shift_scale - 1.0) * ac)  # ᾱ ← ᾱ / (s − (s−1)·ᾱ)
        if rescale_betas_zero_snr:
            ac = rescale_zero_terminal_snr(ac)
        self.alphas_cumprod = ac
        self.final_alpha_cumprod = 1.0 if rescale_betas_zero_snr else float(ac[0])

    def set_timesteps(self, num_inference_steps: int, **_: object) -> None:
        self.num_inference_steps = num_inference_steps
        n, full = num_inference_steps, self.num_train_timesteps
        if self.timestep_spacing == "trailing":
            ts = (np.arange(full, 0, -full / n).round() - 1).astype(np.int64)
        elif self.timestep_spacing == "linspace":
            ts = np.linspace(0, full - 1, n).round()[::-1].astype(np.int64)
        else:  # leading
            ts = (np.arange(0, n) * (full // n))[::-1].astype(np.int64)
        self.timesteps = ts.astype(np.float32)
        self._train_indices = ts
        self.sigmas = np.concatenate([np.sqrt(1.0 - self.alphas_cumprod[ts]), [0.0]])
        self._step_index = 0

    def _alpha_pair(self, i: int):
        a_t = float(self.alphas_cumprod[int(self._train_indices[i])])
        if i + 1 < len(self._train_indices):
            a_prev = float(self.alphas_cumprod[int(self._train_indices[i + 1])])
        else:
            a_prev = self.final_alpha_cumprod
        return a_t, a_prev

    def step(self, model_output, timestep, sample, return_dict: bool = False, **_: object):
        return self.step_at(model_output, sample, self._resolve_step_index(timestep))

    def step_at(self, model_output: torch.Tensor, sample: torch.Tensor, step_index: int):
        a_t, a_prev = self._alpha_pair(step_index)
        sq_a, sq_b = a_t**0.5, (1.0 - a_t) ** 0.5
        v, x = model_output.float(), sample.float()
        if self.prediction_type == "v_prediction":
            x0 = sq_a * x - sq_b * v
            eps = sq_a * v + sq_b * x
        elif self.prediction_type == "epsilon":
            eps = v
            x0 = (x - sq_b * eps) / sq_a
        else:  # "sample"
            x0 = v
            eps = (x - sq_a * x0) / sq_b
        prev = a_prev**0.5 * x0 + (1.0 - a_prev) ** 0.5 * eps
        self._step_index = step_index + 1
        return (prev,)

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor, timestep) -> torch.Tensor:
        """DDPM corruption at ``timestep`` (v2v's start)."""
        a_t, _ = self._alpha_pair(self._resolve_step_index(timestep))
        return a_t**0.5 * original_samples + (1.0 - a_t) ** 0.5 * noise

    def training_target(self, sample, noise, timestep=None):
        a_t, _ = self._alpha_pair(self._resolve_step_index(timestep) if timestep is not None else 0)
        return a_t**0.5 * noise - (1.0 - a_t) ** 0.5 * sample
