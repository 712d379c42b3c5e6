"""UniPC multistep sampler on the rectified-flow parameterization (port of
``apex_studio_tpu/schedulers/unipc.py``, the Wan-family default sampler).

The UniPC predictor-corrector (Zhao et al. 2023, arXiv:2302.04867) with
x0-prediction on flow sigmas, where alpha_t = 1 - sigma_t and
lambda_t = log(alpha_t) - log(sigma_t). Solver variants: bh1 (B(h) = h) and
bh2 (B(h) = e^h - 1, the default).

The sigma grid and every coefficient (a small Vandermonde solve, order <= 3)
are computed on the host in float64 numpy, exactly as the JAX scheduler
computes them, so the grid, the integer timesteps and ``fused_plan`` are
bit-identical to JAX. The tensor update is a short chain of element-wise
torch ops in float32 on the latents' device.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.schedulers.base import SchedulerBase, scheduler_registry, shift_sigmas


def _lambda(sigma: float) -> float:
    alpha = 1.0 - sigma
    return math.log(max(alpha, 1e-12)) - math.log(max(sigma, 1e-12))


def _unipc_Rb(rks: List[float], hh: float, b_h: float, rows: int):
    """The UniPC linear system: R[i][j] = rks[j]^i, b[i] = i!·phi_{i+1}·hh^{i+1}/B_h,
    with g_1 = expm1(hh), g_{k+1} = g_k/hh − 1/k! scaled by the running factorial."""
    r_mat = np.array([[rk**i for rk in rks] for i in range(rows)], dtype=np.float64)
    b = []
    h_phi_k = math.expm1(hh) / hh - 1.0
    fac = 1.0
    for i in range(1, rows + 1):
        b.append(h_phi_k * fac / b_h)
        fac *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / fac
    return r_mat, np.array(b, dtype=np.float64)


@scheduler_registry.register(
    "FlowUniPCMultistepScheduler", aliases=("UniPCMultistepScheduler", "unipc")
)
class FlowUniPCMultistepScheduler(SchedulerBase):
    order = 1  # timesteps consumed per iteration

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        solver_order: int = 2,
        shift: float = 1.0,
        use_dynamic_shifting: bool = False,
        predict_x0: bool = True,
        solver_type: str = "bh2",
        lower_order_final: bool = True,
        disable_corrector: Optional[List[int]] = None,
        **_: object,
    ):
        super().__init__(
            num_train_timesteps=num_train_timesteps,
            solver_order=solver_order,
            shift=shift,
            predict_x0=predict_x0,
            solver_type=solver_type,
            lower_order_final=lower_order_final,
        )
        if solver_type not in ("bh1", "bh2"):
            raise ValueError(f"unsupported solver_type {solver_type!r}")
        self.num_train_timesteps = num_train_timesteps
        self.solver_order = solver_order
        self.shift = shift
        self.use_dynamic_shifting = use_dynamic_shifting
        self.predict_x0 = predict_x0
        self.solver_type = solver_type
        self.lower_order_final = lower_order_final
        self.disable_corrector = disable_corrector or []
        self._reset_state()

    def _reset_state(self) -> None:
        self._step_index = None
        self.model_outputs: List[Optional[torch.Tensor]] = [None] * self.solver_order
        self.lower_order_nums = 0
        self.last_sample = None
        self._this_order = self.solver_order

    def set_timesteps(self, num_inference_steps: int, shift: Optional[float] = None, **_: object) -> None:
        """Sigmas from linspace(1−1/T, 0, n+1)[:-1], shifted, with integer
        timesteps (the JAX grid, bit for bit)."""
        self.num_inference_steps = num_inference_steps
        sigma_max = 1.0 - 1.0 / self.num_train_timesteps
        grid = np.linspace(sigma_max, 0.0, num_inference_steps + 1, dtype=np.float64)[:-1]
        grid = shift_sigmas(grid, shift if shift is not None else self.shift)
        self.sigmas = np.concatenate([grid, [0.0]])
        self.timesteps = (grid * self.num_train_timesteps).astype(np.int64).astype(np.float32)
        self._reset_state()

    # -- core math ---------------------------------------------------------------

    @staticmethod
    def _to_x0(model_output: torch.Tensor, sample: torch.Tensor, sigma: float) -> torch.Tensor:
        """The network's flow velocity as an x0 prediction, in f32."""
        return sample.float() - sigma * model_output.float()

    def _h_terms(self, i: int):
        s0, st = float(self.sigmas[i]), float(self.sigmas[i + 1])
        l0, lt = _lambda(s0), _lambda(st)
        h = lt - l0
        hh = -h if self.predict_x0 else h
        h_phi_1 = math.expm1(hh)
        b_h = h_phi_1 if self.solver_type == "bh2" else hh
        return s0, st, l0, h, hh, h_phi_1, b_h

    def _rks_d1s(self, i: int, order: int, l0: float, h: float):
        rks: List[float] = []
        d1s = []
        m0 = self.model_outputs[-1]
        for j in range(1, order):
            rk = (_lambda(float(self.sigmas[i - j])) - l0) / h
            rks.append(rk)
            d1s.append((self.model_outputs[-(j + 1)] - m0) / rk)
        return rks, d1s

    def _uni_p(self, sample: torch.Tensor, i: int, order: int) -> torch.Tensor:
        """UniP predictor: advance from sigma_i to sigma_{i+1} using ``order`` points."""
        m0 = self.model_outputs[-1]
        s0, st, l0, h, hh, h_phi_1, b_h = self._h_terms(i)
        if st <= 0.0:  # terminal step: the x0 prediction is the answer
            return m0

        rks, d1s = self._rks_d1s(i, order, l0, h)
        x = sample.float()
        alpha_t = 1.0 - st

        x_t = (st / s0) * x - (alpha_t * h_phi_1) * m0
        if d1s:
            r_mat, b = _unipc_Rb(rks + [1.0], hh, b_h, rows=order)
            if order == 2:
                # the published UniPC implementation fixes the order-2
                # predictor weight at 0.5 instead of solving the 1x1 system
                rhos_p = np.array([0.5])
            else:
                rhos_p = np.linalg.solve(r_mat[:-1, :-1], b[:-1])
            pred_res = sum(float(r) * d for r, d in zip(rhos_p, d1s))
            x_t = x_t - alpha_t * b_h * pred_res
        return x_t

    def _uni_c(self, last_sample: torch.Tensor, this_model_output_x0: torch.Tensor, i: int,
               order: int) -> torch.Tensor:
        """UniC corrector: refine x_{i+1} using the model output evaluated there."""
        m0 = self.model_outputs[-1]
        s0, st, l0, h, hh, h_phi_1, b_h = self._h_terms(i)
        if st <= 0.0:
            return this_model_output_x0  # terminal: the corrected sample is x0

        rks, d1s = self._rks_d1s(i, order, l0, h)
        x = last_sample.float()
        alpha_t = 1.0 - st

        r_mat, b = _unipc_Rb(rks + [1.0], hh, b_h, rows=order)
        rhos_c = np.array([0.5]) if order == 1 else np.linalg.solve(r_mat, b)

        x_t = (st / s0) * x - (alpha_t * h_phi_1) * m0
        corr_res = sum(float(r) * d for r, d in zip(rhos_c[:-1], d1s)) if d1s else 0.0
        d1_t = this_model_output_x0 - m0
        return x_t - alpha_t * b_h * (corr_res + float(rhos_c[-1]) * d1_t)

    # -- fused stepping --------------------------------------------------------------

    def fused_plan(self):
        """Per-step linear weights for a UniPC step applied as two linear
        combinations (engine/fused.py ``build_unipc_step``).

        The predictor-corrector is linear in (sample, x0 history, current x0
        prediction) with coefficients that depend only on the sigma grid and
        the step index. Returns a list over steps ``i`` of dicts of f32 numpy
        values:
          sigma          — sigma_i (x0 = x − sigma·v)
          use_corrector  — 0.0 / 1.0
          corr_w [K+2]   — weights for [last_sample, hist[0..K−1], x0_i]
          pred_w [K+1]   — weights for [sample, hist_new[0..K−1]]
        History layout: hist[K−1] is the newest x0; hist_new = shift(hist)+x0_i.
        Weights of history slots not yet filled are exactly 0.
        """
        K = self.solver_order
        N = len(self.timesteps)
        plan = []
        for i in range(N):
            use_corr = i > 0 and (i - 1) not in self.disable_corrector
            corr_w = np.zeros(K + 2, np.float64)
            if use_corr:
                order_prev = max(1, min(K, i, N - (i - 1) if self.lower_order_final else N))
                s0, st = float(self.sigmas[i - 1]), float(self.sigmas[i])
                l0 = _lambda(s0)
                h = _lambda(st) - l0
                hh = -h if self.predict_x0 else h
                h_phi_1 = math.expm1(hh)
                b_h = h_phi_1 if self.solver_type == "bh2" else hh
                alpha = 1.0 - st
                rks = [
                    (_lambda(float(self.sigmas[i - 1 - j])) - l0) / h
                    for j in range(1, order_prev)
                ]
                r_mat, bvec = _unipc_Rb(rks + [1.0], hh, b_h, rows=order_prev)
                rhos_c = np.array([0.5]) if order_prev == 1 else np.linalg.solve(r_mat, bvec)
                corr_w[0] = st / s0                                 # last_sample
                corr_w[K + 1] = -alpha * b_h * float(rhos_c[-1])   # x0_i
                m0_w = -alpha * h_phi_1 + alpha * b_h * float(rhos_c[-1])
                for j in range(1, order_prev):
                    wj = alpha * b_h * float(rhos_c[j - 1]) / rks[j - 1]
                    corr_w[1 + (K - 1 - j)] += -wj
                    m0_w += wj
                corr_w[1 + (K - 1)] += m0_w
            order_i = max(1, min(K, i + 1, (N - i) if self.lower_order_final else N))
            pred_w = np.zeros(K + 1, np.float64)
            s0, st = float(self.sigmas[i]), float(self.sigmas[i + 1])
            if st <= 0.0:
                pred_w[1 + (K - 1)] = 1.0  # terminal: the x0 prediction is the answer
            else:
                l0 = _lambda(s0)
                h = _lambda(st) - l0
                hh = -h if self.predict_x0 else h
                h_phi_1 = math.expm1(hh)
                b_h = h_phi_1 if self.solver_type == "bh2" else hh
                alpha = 1.0 - st
                pred_w[0] = st / s0
                m0_w = -alpha * h_phi_1
                rks = [
                    (_lambda(float(self.sigmas[i - j])) - l0) / h
                    for j in range(1, order_i)
                ]
                if rks:
                    r_mat, bvec = _unipc_Rb(rks + [1.0], hh, b_h, rows=order_i)
                    rhos_p = (
                        np.array([0.5])
                        if order_i == 2
                        else np.linalg.solve(r_mat[:-1, :-1], bvec[:-1])
                    )
                    for j in range(1, order_i):
                        wj = alpha * b_h * float(rhos_p[j - 1]) / rks[j - 1]
                        pred_w[1 + (K - 1 - j)] += -wj
                        m0_w += wj
                pred_w[1 + (K - 1)] += m0_w
            plan.append(
                {
                    "sigma": np.float32(float(self.sigmas[i])),
                    "use_corrector": np.float32(1.0 if use_corr else 0.0),
                    "corr_w": corr_w.astype(np.float32),
                    "pred_w": pred_w.astype(np.float32),
                }
            )
        return plan

    # -- host stepping -------------------------------------------------------------

    def step(self, model_output, timestep, sample, return_dict: bool = False, **_: object):
        if self._step_index is None:
            self._step_index = self._resolve_step_index(timestep)
        i = self._step_index

        x0_pred = self._to_x0(model_output, sample, float(self.sigmas[i]))

        use_corrector = (
            i > 0 and (i - 1) not in self.disable_corrector and self.last_sample is not None
        )
        if use_corrector:
            sample = self._uni_c(self.last_sample, x0_pred, i - 1, self._this_order).to(model_output.dtype)

        # shift the x0 history
        self.model_outputs = self.model_outputs[1:] + [x0_pred]

        order = min(self.solver_order, self.lower_order_nums + 1)
        if self.lower_order_final:
            order = min(order, len(self.timesteps) - i)
        self._this_order = max(1, order)

        self.last_sample = sample
        prev = self._uni_p(sample, i, self._this_order).to(model_output.dtype)

        if self.lower_order_nums < self.solver_order:
            self.lower_order_nums += 1
        self._step_index += 1
        return {"prev_sample": prev} if return_dict else (prev,)
