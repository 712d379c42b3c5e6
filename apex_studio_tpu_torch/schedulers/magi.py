"""MAGI-1 chunk-wise flow scheduler, port of ``apex_studio_tpu/schedulers/magi.py``.

A forward-time schedule t ∈ [0, 1] (0 = noise, 1 = clean) built on the host in
float64 from a linspace (or the distilled 12-step ``16,16,8`` shortcut ladder)
warped by ``sd3`` (squared, then the SD3 shift), ``square`` or ``piecewise``;
stepped chunk-wise: each active chunk of the sliding window sits at its own
point of the schedule, so the Euler update ``x += v · Δt`` takes one Δt a chunk.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from apex_studio_tpu_torch.schedulers.base import SchedulerBase, scheduler_registry


@scheduler_registry.register("MagiScheduler")
class MagiScheduler(SchedulerBase):
    """Timesteps run noise → clean (t ascending)."""

    def __init__(self, num_inference_steps: int = 64, num_train_timesteps: int = 1000, shift: float = 3.0,
                 scheduler_type: str = "sd3", shortcut_mode: str = "16,16,8", clean_t: float = 0.9999,
                 **_: object):
        super().__init__(num_inference_steps=num_inference_steps, num_train_timesteps=num_train_timesteps,
                         shift=shift, scheduler_type=scheduler_type, shortcut_mode=shortcut_mode, clean_t=clean_t)
        self.num_train_timesteps = num_train_timesteps
        self.shift = float(shift)
        self.scheduler_type = scheduler_type
        self.shortcut_mode = shortcut_mode
        self.clean_t = float(clean_t)
        self.denoise_step_per_stage: Optional[int] = None
        self.chunk_width: Optional[int] = None
        self.set_timesteps(num_inference_steps)

    def set_timesteps(self, num_inference_steps: int = 64, **_: object) -> np.ndarray:
        n = int(num_inference_steps)
        if n == 12:
            # the distilled 12-step shortcut ladder
            base = np.linspace(0.0, 1.0, 5, dtype=np.float64) / 4.0
            accu = np.linspace(0.0, 1.0, 5, dtype=np.float64)
            base = base[:3] if self.shortcut_mode == "16,16,8" else np.concatenate([base[:1], base[2:4]])
            t = np.concatenate([base + a for a in accu])[: n + 1]
        else:
            t = np.linspace(0.0, 1.0, n + 1, dtype=np.float64)
        if self.scheduler_type == "sd3":
            t = t ** 2
            s_inv = 1.0 / self.shift
            t = s_inv * t / (1.0 + (s_inv - 1.0) * t)
        elif self.scheduler_type == "square":
            t = t ** 2
        elif self.scheduler_type == "piecewise":
            t = np.where(t < 0.875, t * (0.5 / 0.875), 0.5 + (t - 0.875) * (0.5 / 0.125))
        self.num_inference_steps = n
        self.timesteps = t.astype(np.float64)
        return self.timesteps

    def set_scheduler_params(self, chunk_width: int, denoise_step_per_stage: int) -> None:
        self.chunk_width = int(chunk_width)
        self.denoise_step_per_stage = int(denoise_step_per_stage)

    def chunk_timesteps(self, start: int, end: int, denoise_idx: int, has_clean_t: bool = False) -> np.ndarray:
        """Per-chunk t of window chunks [start, end) at micro-step
        ``denoise_idx``, newest chunk last (the index list is built ascending,
        then reversed)."""
        d = self.denoise_step_per_stage
        if d is None:
            raise RuntimeError("call set_scheduler_params first")
        idx = [i * d + denoise_idx for i in range(start, end)][::-1]
        t = self.timesteps[idx]
        if has_clean_t:
            t = np.concatenate([[self.clean_t], t])
        return t.astype(np.float32)

    def step(self, sample: torch.Tensor, model_output: torch.Tensor, t_start: int, t_end: int, i: int,
             **_: object) -> torch.Tensor:
        """Chunk-wise Euler update on (B, C, T, H, W): each chunk of
        ``chunk_width`` latent frames advances by its own Δt."""
        dt = self.chunk_timesteps(t_start, t_end, i + 1) - self.chunk_timesteps(t_start, t_end, i)
        n, c, t, h, w = sample.shape
        cw = self.chunk_width
        dt = torch.from_numpy(dt).to(device=sample.device, dtype=sample.dtype).reshape(1, 1, -1, 1, 1, 1)
        s = sample.reshape(n, c, -1, cw, h, w) + model_output.reshape(n, c, -1, cw, h, w) * dt
        return s.reshape(n, c, t, h, w)
