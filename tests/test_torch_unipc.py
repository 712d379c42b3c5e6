"""The port's FlowUniPC scheduler and fused UniPC step against the JAX package's.

The sigma grid, the integer timesteps and the fused plan are host float64
maths in both packages: equal bit for bit. The host ``step`` and the fused
step update f32 latents: each step's output within rel L2 ≤ 1e-6 of the JAX
host step, over 10 steps of seeded velocities, at solver orders 1 and 2 and
both solver types.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_studio_tpu.schedulers.unipc import FlowUniPCMultistepScheduler as JaxUniPC
from apex_studio_tpu_torch.engine.fused import build_unipc_step, init_unipc_carry
from apex_studio_tpu_torch.schedulers import create_scheduler
from apex_studio_tpu_torch.schedulers.unipc import FlowUniPCMultistepScheduler
from tests.torch_port_helpers import assert_rel_l2

STEPS = 10
SHAPE = (1, 4, 2, 6, 8)


@pytest.mark.parametrize("n,shift", [(1, 5.0), (3, 12.0), (30, 5.0), (40, 12.0)])
def test_grid_is_bit_equal(n, shift):
    ref, port = JaxUniPC(shift=shift), FlowUniPCMultistepScheduler(shift=shift)
    ref.set_timesteps(n)
    port.set_timesteps(n)
    assert port.sigmas.dtype == np.float64 and port.timesteps.dtype == np.float32
    np.testing.assert_array_equal(port.sigmas, ref.sigmas)
    np.testing.assert_array_equal(port.timesteps, ref.timesteps)


@pytest.mark.parametrize("order,solver_type,disable", [(1, "bh2", None), (2, "bh2", None), (2, "bh1", [3]),
                                                       (3, "bh2", None)])
def test_fused_plan_is_bit_equal(order, solver_type, disable):
    kw = dict(shift=5.0, solver_order=order, solver_type=solver_type, disable_corrector=disable)
    ref, port = JaxUniPC(**kw), FlowUniPCMultistepScheduler(**kw)
    ref.set_timesteps(30)
    port.set_timesteps(30)
    for got, want in zip(port.fused_plan(), ref.fused_plan(), strict=True):
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])


def velocities(n):
    rng = np.random.default_rng(0)
    return (rng.normal(size=SHAPE).astype(np.float32),
            [rng.normal(size=SHAPE).astype(np.float32) for _ in range(n)])


@pytest.mark.parametrize("order,solver_type", [(1, "bh2"), (2, "bh2"), (2, "bh1")])
def test_host_and_fused_steps_match_jax(order, solver_type):
    kw = dict(shift=12.0, solver_order=order, solver_type=solver_type)
    ref, host = JaxUniPC(**kw), FlowUniPCMultistepScheduler(**kw)
    fused = FlowUniPCMultistepScheduler(**kw)
    for s in (ref, host, fused):
        s.set_timesteps(STEPS)
    x0, vs = velocities(STEPS)
    x_ref, x_host = jnp.asarray(x0), torch.from_numpy(x0)
    x_fused = torch.from_numpy(x0.copy())
    hist, last = init_unipc_carry(x_fused, order)
    step = build_unipc_step(lambda x, v: v, order)
    for i, (t, v) in enumerate(zip(ref.timesteps, vs)):
        (x_ref,) = ref.step(jnp.asarray(v), float(t), x_ref)
        (x_host,) = host.step(torch.from_numpy(v), float(t), x_host)
        p = fused.fused_plan()[i]
        x_fused = step(x_fused, hist, last, p["sigma"], p["use_corrector"], p["corr_w"], p["pred_w"],
                       torch.from_numpy(v))
        assert x_host.dtype == x_fused.dtype == torch.float32
        assert_rel_l2(x_host, np.asarray(x_ref), 1e-6)
        assert_rel_l2(x_fused, np.asarray(x_ref), 1e-6)


def test_registered_names_and_manifest_config():
    for name in ("FlowUniPCMultistepScheduler", "UniPCMultistepScheduler", "unipc",
                 "diffusers.FlowUniPCMultistepScheduler"):
        s = create_scheduler(name, {"num_train_timesteps": 1000, "shift": 12.0})
        assert type(s) is FlowUniPCMultistepScheduler and s.shift == 12.0 and s.solver_order == 2
    with pytest.raises(ValueError, match="solver_type"):
        FlowUniPCMultistepScheduler(solver_type="midpoint")
