"""The port's Flux DiT, latent packing, Euler scheduler and denoise step against
the JAX package's, on the CPU in f32.

Weights come from the JAX module (its own seeded init) through
``apex_studio_tpu_torch.loaders.from_jax``. Tolerance: max|Δ| ≤ 1e-4·max|ref|;
the sigma grids are float64 numpy on both sides and must agree to 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.engine.fused import build_euler_step as jax_build_euler_step
from apex_studio_tpu.models import layers as jax_layers
from apex_studio_tpu.models.transformers.flux import FluxConfig as JaxFluxConfig
from apex_studio_tpu.models.transformers.flux import FluxTransformer2DModel as JaxFlux
from apex_studio_tpu.schedulers.base import compute_dynamic_shift_mu as jax_mu
from apex_studio_tpu.schedulers.flow_match import FlowMatchEulerDiscreteScheduler as JaxEuler
from apex_studio_tpu_torch.engine.fused import build_euler_step
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from apex_studio_tpu_torch.models import layers
from apex_studio_tpu_torch.models.transformers.flux import FluxConfig, FluxTransformer2DModel
from apex_studio_tpu_torch.schedulers import compute_dynamic_shift_mu, create_scheduler
from tests.torch_port_helpers import assert_close, jax_build, jax_params, jitted, port_from_jax

# tests/test_parity_flux_dit.py TINY (patch_size dropped: both packages pack 2x2 outside the DiT)
TINY = dict(in_channels=16, out_channels=16, num_layers=2, num_single_layers=2,
            attention_head_dim=64, num_attention_heads=4, joint_attention_dim=128,
            pooled_projection_dim=64, axes_dims_rope=(16, 24, 24))


def build_pair(guidance_embeds):
    jm = jax_build(lambda: JaxFlux(JaxFluxConfig(**TINY, guidance_embeds=guidance_embeds),
                                   dtype=jnp.float32, param_dtype=jnp.float32, rngs=nnx.Rngs(0)))
    cfg = FluxConfig(**TINY, guidance_embeds=guidance_embeds)
    pm = port_from_jax(lambda: FluxTransformer2DModel(cfg, dtype=torch.float32), jm)
    return jm, pm


class TestFluxDiT:
    @pytest.mark.parametrize("guidance_embeds", [True, False])
    def test_forward_matches_jax(self, guidance_embeds):
        jm, pm = build_pair(guidance_embeds)
        rng = np.random.default_rng(0)
        h, w, lt = 4, 6, 7
        x = rng.normal(size=(2, h * w, 16)).astype(np.float32)
        txt = rng.normal(size=(2, lt, 128)).astype(np.float32)
        pooled = rng.normal(size=(2, 64)).astype(np.float32)
        t = np.array([0.9, 0.3], np.float32)
        g = np.array([3.5, 2.0], np.float32) if guidance_embeds else None
        ref = jitted(jm, lambda m, *a: m(*a[:4], a[4] if a[4:] else None, grid_hw=(h, w)),
                     x, txt, pooled, t, *(() if g is None else (g,)))
        with torch.no_grad():
            out = pm(*(torch.from_numpy(a) for a in (x, txt, pooled, t)),
                     None if g is None else torch.from_numpy(g), grid_hw=(h, w))
        assert_close(out, ref)

    def test_rope_tables_match_jax(self):
        jm, pm = build_pair(True)
        rc, rs = jm.rope_tables(5, 3, 4)
        c, s = pm.rope_tables(5, 3, 4)
        assert tuple(c.shape) == tuple(rc.shape) == (1, 17, 1, 32)
        np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=1e-6)
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=1e-6)

    # Kontext: one conditioning grid at t-index 1; DreamOmni2: two grids at 1
    # and 2, the second's widths offset by the first's
    @pytest.mark.parametrize("cond_grids", [(2, 3), ((2, 3), (3, 2))], ids=["kontext", "dreamomni2"])
    def test_conditioning_tokens_match_jax(self, cond_grids):
        jm, pm = build_pair(True)
        grids = [cond_grids] if isinstance(cond_grids[0], int) else list(cond_grids)
        rng = np.random.default_rng(3)
        h, w, lt = 4, 6, 7
        x = rng.normal(size=(1, h * w, 16)).astype(np.float32)
        cond = rng.normal(size=(1, sum(a * b for a, b in grids), 16)).astype(np.float32)
        txt = rng.normal(size=(1, lt, 128)).astype(np.float32)
        pooled = rng.normal(size=(1, 64)).astype(np.float32)
        t, g = np.array([0.6], np.float32), np.array([3.5], np.float32)
        rc, rs = jm.rope_tables(lt, h, w, cond_grid_hw=cond_grids)
        c, s = pm.rope_tables(lt, h, w, cond_grid_hw=cond_grids)
        assert tuple(c.shape) == tuple(rc.shape) == (1, lt + h * w + cond.shape[1], 1, 32)
        np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=1e-6)
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=1e-6)
        fwd = nnx.jit(lambda m, *a: m(*a[:-1], grid_hw=(h, w), cond_tokens=a[-1], cond_grid_hw=cond_grids))
        ref = fwd(jm, *(jnp.asarray(a) for a in (x, txt, pooled, t, g, cond)))
        with torch.no_grad():
            out = pm(*(torch.from_numpy(a) for a in (x, txt, pooled, t, g)), grid_hw=(h, w),
                     cond_tokens=torch.from_numpy(cond), cond_grid_hw=cond_grids)
        assert tuple(out.shape) == (1, h * w, 16)  # the conditioning tokens are dropped
        assert_close(out, ref)

    def test_carry_is_strict(self):
        jm, pm = build_pair(True)
        flat = jax_params(jm)
        flat.pop("proj_out.kernel")
        with pytest.raises(KeyError, match="missing"):
            load_from_jax(pm, flat)
        flat = jax_params(jm)
        flat["extra.kernel"] = np.zeros((2, 2), np.float32)
        with pytest.raises(KeyError, match="unexpected"):
            load_from_jax(pm, flat)


class TestLayers:
    """The shared layers, with weights carried from their JAX counterparts."""

    @pytest.mark.parametrize("name", ["linear", "gelu_mlp", "timestep_embedder"])
    def test_matches_jax(self, name):
        f32 = dict(dtype=jnp.float32, param_dtype=jnp.float32, rngs=nnx.Rngs(3))
        rng = np.random.default_rng(5)
        if name == "linear":
            jm = jax_layers.Linear(12, 20, **f32)
            build = lambda: layers.Linear(12, 20, dtype=torch.float32)  # noqa: E731
            x = rng.normal(size=(2, 3, 12)).astype(np.float32)
        elif name == "gelu_mlp":
            jm = jax_layers.GELUMLP(12, 48, **f32)
            build = lambda: layers.GELUMLP(12, 48, dtype=torch.float32)  # noqa: E731
            x = rng.normal(size=(2, 3, 12)).astype(np.float32)
        else:
            jm = jax_layers.TimestepEmbedder(24, freq_size=32, **f32)
            build = lambda: layers.TimestepEmbedder(24, freq_size=32, dtype=torch.float32)  # noqa: E731
            x = np.array([0.0, 3.0, 500.0], np.float32)
        pm = port_from_jax(build, jm)
        with torch.no_grad():
            assert_close(pm(torch.from_numpy(x)), jm(jnp.asarray(x)))

    def test_norm_layers_match_jax(self):
        x = np.random.default_rng(6).normal(size=(3, 16)).astype(np.float32)
        for jcls, pcls in ((jax_layers.RMSNorm, layers.RMSNorm), (jax_layers.LayerNorm, layers.LayerNorm)):
            jm = jcls(16, eps=1e-6, rngs=nnx.Rngs(0))
            pm = port_from_jax(lambda: pcls(16, eps=1e-6), jm)
            with torch.no_grad():
                assert_close(pm(torch.from_numpy(x)), jm(jnp.asarray(x)))

    def test_quantized_residency_raises(self):
        """Quantized residency used to raise ``NotImplementedError``. Now a
        Linear made resident in either mode computes within its quantization
        error of the f32 weights (W8A8: weights and activations, under 2%;
        int4: under 15%, one step of 64 normal weights being a tenth of their
        spread), and packing an odd number of rows is what raises."""
        from apex_studio_tpu_torch.engine.base import materialize_random
        from apex_studio_tpu_torch.quantize import residency

        assert not hasattr(layers, "check_residency")
        x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32))
        for apply, limit in ((residency.apply_int8_residency, 2e-2), (residency.apply_int4_residency, 1.5e-1)):
            lin = materialize_random(lambda: layers.Linear(64, 32, dtype=torch.float32),
                                     torch.device("cpu"), seed=0, std=0.1)
            ref = lin(x)
            assert apply(lin, min_numel=1) == 1
            assert torch.linalg.vector_norm(lin(x) - ref) < limit * torch.linalg.vector_norm(ref)
        with pytest.raises(ValueError, match="even number of rows"):
            residency.quantize_kernel_int4(np.ones((3, 8), np.float32))


class TestPacking:
    def test_pack_unpack_match_jax(self):
        x = np.random.default_rng(1).normal(size=(2, 16, 8, 6)).astype(np.float32)
        ref = JaxFlux.pack_latents(jnp.asarray(x))
        out = FluxTransformer2DModel.pack_latents(torch.from_numpy(x))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        back = FluxTransformer2DModel.unpack_latents(out, 8, 6)
        np.testing.assert_array_equal(back.numpy(), x)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(JaxFlux.unpack_latents(ref, 8, 6)))


class TestScheduler:
    @pytest.mark.parametrize("seq_len,steps", [(4096, 4), (1024, 28), (256, 1)])
    def test_sigmas_at_mu_float64(self, seq_len, steps):
        mu = compute_dynamic_shift_mu(seq_len)
        assert mu == jax_mu(seq_len)
        cfg = {"num_train_timesteps": 1000, "use_dynamic_shifting": True}
        ours = create_scheduler("FlowMatchEulerDiscreteScheduler", cfg)
        ref = JaxEuler(**cfg)
        sig = np.linspace(1.0, 1.0 / steps, steps)
        ours.set_timesteps(steps, sigmas=sig, mu=mu)
        ref.set_timesteps(steps, sigmas=sig, mu=mu)
        assert ours.sigmas.dtype == np.float64
        np.testing.assert_allclose(ours.sigmas, ref.sigmas, rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(ours.timesteps, ref.timesteps)

    def test_static_shift(self):
        ours = create_scheduler("diffusers.FlowMatchEulerDiscreteScheduler", {"shift": 3.0})
        ref = JaxEuler(shift=3.0)
        ours.set_timesteps(10)
        ref.set_timesteps(10)
        np.testing.assert_allclose(ours.sigmas, ref.sigmas, rtol=1e-12)


class TestEulerStep:
    def test_step_matches_jax_fused_step(self):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(1, 12, 16)).astype(np.float32)
        w = rng.normal(size=(16, 16)).astype(np.float32)
        sigma, sigma_next = 0.8731, 0.61

        class M(nnx.Module):
            def __init__(self):
                self.w = nnx.Param(jnp.asarray(w))

        m = M()
        graphdef, state = nnx.split(m)
        jax_step = jax_build_euler_step(graphdef, lambda m, x, aux: (x @ m.w.get_value(), aux))
        ref, _ = jax_step(state, jnp.asarray(x), sigma, sigma_next, ())
        step = build_euler_step(lambda x: x @ torch.from_numpy(w))
        xt = torch.from_numpy(x.copy())
        out = step(xt, sigma, sigma_next)
        assert out.data_ptr() == xt.data_ptr()  # updated in place
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
