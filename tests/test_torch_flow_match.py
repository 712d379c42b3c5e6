"""The port's ``FlowMatchScheduler`` and ``FlowMatchPairScheduler`` against
the JAX package's, on the host.

Grids (timesteps f32, sigmas f64) must be equal to the bit; ``step``,
``step_at`` and ``add_noise`` on seeded f32 latents within max|Δ| ≤ 1e-6 of
max|ref| (the same f32 arithmetic). Cases: the causal Self-Forcing
manifest's scheduler (shift 8, ``extra_one_step``) at 4 steps, the defaults,
``inverse_timesteps``, ``reverse_sigmas``, a denoising strength of 0.6 and a
shift override; the pair scheduler with an exponential shift and a terminal,
its pairs, and the ``dual_sigma_shift`` postprocess.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_studio_tpu.schedulers import create_scheduler as jax_scheduler
from apex_studio_tpu_torch.schedulers import create_scheduler
from tests.torch_port_helpers import assert_close

CONFIGS = {
    "self_forcing_manifest": ({"num_train_timesteps": 1000, "shift": 8.0, "extra_one_step": True}, 4, {}),
    "defaults": ({}, 10, {}),
    "inverse_timesteps": ({"shift": 5.0, "inverse_timesteps": True}, 6, {}),
    "reverse_sigmas": ({"shift": 2.0, "reverse_sigmas": True}, 5, {}),
    "strength_0_6": ({"shift": 3.0}, 8, {"denoising_strength": 0.6}),
    "shift_override": ({"shift": 3.0, "extra_one_step": True}, 7, {"shift": 12.0}),
}


def pair(name, base="FlowMatchScheduler"):
    cfg, steps, kw = CONFIGS[name]
    ref, port = jax_scheduler(base, dict(cfg)), create_scheduler(base, dict(cfg))
    ref.set_timesteps(steps, **kw)
    port.set_timesteps(steps, **kw)
    return ref, port


@pytest.mark.parametrize("name", list(CONFIGS))
def test_grid_matches_jax(name):
    ref, port = pair(name)
    np.testing.assert_array_equal(port.timesteps, ref.timesteps)
    np.testing.assert_array_equal(port.sigmas, ref.sigmas)
    assert port.timesteps.dtype == np.float32 and port.sigmas.dtype == np.float64


@pytest.mark.parametrize("name", ["self_forcing_manifest", "strength_0_6", "reverse_sigmas"])
def test_steps_match_jax(name):
    ref, port = pair(name)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 4, 3, 8, 8)).astype(np.float32)
    for i, t in enumerate(port.timesteps):
        v = rng.normal(size=x.shape).astype(np.float32)
        (want,) = ref.step(jnp.asarray(v), float(t), jnp.asarray(x))
        (got,) = port.step(torch.from_numpy(v), float(t), torch.from_numpy(x))
        assert_close(got, want, rel=1e-6)
        assert_close(port.step_at(torch.from_numpy(v), torch.from_numpy(x), i),
                     ref.step_at(jnp.asarray(v), jnp.asarray(x), i), rel=1e-6)
        x = got.numpy()
    noise = rng.normal(size=x.shape).astype(np.float32)
    t = port.timesteps[1]
    assert_close(port.add_noise(torch.from_numpy(x), torch.from_numpy(noise), t),
                 ref.add_noise(jnp.asarray(x), jnp.asarray(noise), t), rel=1e-6)


def test_final_step_goes_to_the_terminal():
    ref, port = pair("self_forcing_manifest")
    x, v = np.ones((2, 3), np.float32), np.full((2, 3), 0.5, np.float32)
    (got,) = port.step(torch.from_numpy(v), float(port.timesteps[1]), torch.from_numpy(x), to_final=True)
    (want,) = ref.step(jnp.asarray(v), float(ref.timesteps[1]), jnp.asarray(x), to_final=True)
    assert_close(got, want, rel=1e-6)


PAIR_CFG = {"shift": 5.0, "exponential_shift": True, "exponential_shift_mu": 1.2, "shift_terminal": 0.02}


@pytest.mark.parametrize("cfg", [PAIR_CFG, {"shift": 5.0}], ids=["exponential", "plain"])
def test_pair_scheduler_matches_jax(cfg):
    ref = jax_scheduler("FlowMatchPairScheduler", dict(cfg))
    port = create_scheduler("FlowMatchPairScheduler", dict(cfg))
    for s in (ref, port):
        s.set_timesteps(6)
    np.testing.assert_array_equal(port.timesteps, ref.timesteps)
    np.testing.assert_array_equal(port.sigmas, ref.sigmas)
    for source in ("timesteps", "sigmas"):
        np.testing.assert_array_equal(port.get_pairs(source), ref.get_pairs(source))
    kw = dict(visual_shift=3.0, audio_shift=7.0, audio_denoising_strength=0.8)
    ref.set_pair_postprocess_by_name("dual_sigma_shift", **kw)
    port.set_pair_postprocess_by_name("dual_sigma_shift", **kw)
    for source in ("timesteps", "sigmas"):
        got = port.get_pairs(source)
        np.testing.assert_array_equal(got, ref.get_pairs(source))
        assert got.shape == (6, 2) and not np.array_equal(got[:, 0], got[:, 1])
    port.set_pair_postprocess_by_name("none")
    assert np.array_equal(port.get_pairs()[:, 0], port.get_pairs()[:, 1])
    with pytest.raises(ValueError):
        port.set_pair_postprocess_by_name("unknown")
