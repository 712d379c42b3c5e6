"""Scheduler foundations (copy of ``apex_studio_tpu/schedulers/base.py``).

The schedule itself (sigmas/timesteps) is computed on the host in float64
numpy at ``set_timesteps`` time; the per-step update is element-wise torch
math on the latents' device.

Config compatibility: constructors accept the diffusers ``scheduler_config.json``
key names so manifests pointing at HF scheduler configs work unchanged.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np

from apex_studio_tpu_torch.registry import Registry

scheduler_registry = Registry("scheduler")


def shift_sigmas(sigmas: np.ndarray, shift: float) -> np.ndarray:
    """The SD3/Flux time shift: sigma ← s*sigma / (1 + (s-1)*sigma)."""
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


def exponential_time_shift(mu: float, sigma_exp: float, t: np.ndarray) -> np.ndarray:
    """Dynamic (resolution-dependent) shift: exp(mu) / (exp(mu) + (1/t - 1)^sigma)."""
    with np.errstate(divide="ignore"):
        return np.where(
            t > 0.0, np.exp(mu) / (np.exp(mu) + (1.0 / np.maximum(t, 1e-12) - 1.0) ** sigma_exp), 0.0
        )


def compute_dynamic_shift_mu(
    image_seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
) -> float:
    """Flux-style resolution-dependent mu for dynamic shifting."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


class SchedulerBase:
    """Minimal interface every scheduler implements.

    After ``set_timesteps(n)``:
      - ``timesteps`` — float32 numpy [n], the values fed to the model
      - ``sigmas``    — float64 numpy [n+1] (trailing terminal sigma)
    ``step(model_output, timestep_or_index, sample)`` returns the previous
    (less noisy) sample; index-based stepping is preferred (jit-friendly).
    """

    order = 1

    def __init__(self, **config: Any):
        self.config: Dict[str, Any] = config
        self.sigmas: np.ndarray = np.array([])
        self.timesteps: np.ndarray = np.array([])
        self.num_inference_steps: Optional[int] = None
        self._step_index: Optional[int] = None

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_config(cls, config: Union[Dict[str, Any], str, Path], **overrides: Any):
        if isinstance(config, (str, Path)):
            config = json.loads(Path(config).read_text())
        cfg = {k: v for k, v in dict(config).items() if not k.startswith("_")}
        cfg.update(overrides)
        import inspect

        accepted = set(inspect.signature(cls.__init__).parameters)
        return cls(**{k: v for k, v in cfg.items() if k in accepted})

    # -- stepping helpers -------------------------------------------------------

    @property
    def step_index(self) -> Optional[int]:
        return self._step_index

    def set_begin_index(self, begin_index: int = 0) -> None:
        self._step_index = begin_index

    def index_for_timestep(self, timestep: float) -> int:
        """Nearest schedule index for a timestep value."""
        return int(np.argmin(np.abs(self.timesteps - float(timestep))))

    def _resolve_step_index(self, timestep_or_index: Any) -> int:
        if isinstance(timestep_or_index, (int, np.integer)) and 0 <= int(
            timestep_or_index
        ) < len(self.timesteps):
            # Heuristic matching the reference's timesteps-as-indices mode: small
            # ints are schedule indices, floats are timestep values.
            if isinstance(timestep_or_index, (int, np.integer)):
                return int(timestep_or_index)
        return self.index_for_timestep(float(timestep_or_index))

    def scale_model_input(self, sample, timestep=None):
        return sample

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    # -- flow-matching forward process -------------------------------------------

    def add_noise(self, original_samples, noise, timestep):
        """x_t = (1 - sigma_t) * x0 + sigma_t * noise (rectified-flow corruption)."""
        idx = self.index_for_timestep(float(np.asarray(timestep).reshape(-1)[0]))
        sigma = float(self.sigmas[idx])
        return (1.0 - sigma) * original_samples + sigma * noise

    def training_target(self, sample, noise, timestep=None):
        return noise - sample


def create_scheduler(base: str, config: Optional[Dict[str, Any]] = None, **kwargs: Any):
    """Instantiate a scheduler from a manifest ``base`` key.

    Accepts both bare class names and ``diffusers.``-prefixed names so the
    reference's manifests resolve unchanged.
    """
    name = base.split(".")[-1]
    cls = scheduler_registry.get(name)
    if config:
        return cls.from_config(config, **kwargs)
    return cls(**kwargs)
