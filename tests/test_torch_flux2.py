"""The port's FLUX.2 DiT and its control variant against the JAX package's, on
the CPU in f32.

Tiny models (1 dual + 1 single block, two heads of 16 = the sum of the axes
(4, 4, 4, 4), mlp_ratio 2, joint_attention_dim 48) are built by the JAX
package from its seed and carried into the port with ``loaders/from_jax.py``;
both run the same numpy inputs and are held to max|Δ| ≤ 1e-4·max|ref|. The
forwards cover t2i, edit references (one and two grids at RoPE time 10 and
20; their tokens ride the image stream and are dropped before the output)
and the control chain's hints at two scales.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from apex_studio_tpu.models.transformers import flux2 as jax_flux2
from apex_studio_tpu_torch.models.transformers import flux2
from tests.torch_port_helpers import assert_close, jax_build, port_from_jax

TINY = dict(in_channels=16, num_layers=1, num_single_layers=1, attention_head_dim=16, num_attention_heads=2,
            joint_attention_dim=48, mlp_ratio=2.0, axes_dims_rope=(4, 4, 4, 4))
CONTROL = dict(TINY, num_layers=3, control_layers=(0, 2), control_in_dim=36)
F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
H, W, L = 3, 4, 5


@pytest.fixture(scope="module")
def models():
    base = jax_build(lambda: jax_flux2.Flux2Transformer2DModel(jax_flux2.Flux2Config(**TINY), rngs=nnx.Rngs(0),
                                                               **F32))
    ctrl = jax_build(lambda: jax_flux2.Flux2ControlTransformer2DModel(
        jax_flux2.Flux2ControlConfig(**CONTROL), rngs=nnx.Rngs(0), **F32), seed=1)
    return {
        "base": (base, port_from_jax(lambda: flux2.Flux2Transformer2DModel(flux2.Flux2Config(**TINY),
                                                                           dtype=torch.float32), base)),
        "control": (ctrl, port_from_jax(lambda: flux2.Flux2ControlTransformer2DModel(
            flux2.Flux2ControlConfig(**CONTROL), dtype=torch.float32), ctrl)),
    }


def inputs(n_cond=0, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, H * W, 16)).astype(np.float32)
    seq = rng.normal(size=(1, L, 48)).astype(np.float32)
    cond = rng.normal(size=(1, n_cond, 16)).astype(np.float32) if n_cond else None
    cc = rng.normal(size=(1, H * W, 36)).astype(np.float32)
    return x, seq, np.array([0.43], np.float32), np.array([4.0], np.float32), cond, cc


def t(a):
    return None if a is None else torch.from_numpy(a)


def j(a):
    return None if a is None else jnp.asarray(a)


class TestFlux2DiT:
    @pytest.mark.parametrize("guidance", [True, False])
    def test_t2i_forward_matches_jax(self, models, guidance):
        ref_m, port = models["base"]
        x, seq, tt, g, _, _ = inputs()
        g = g if guidance else None
        ref = nnx.jit(lambda m, *a: m(*a, grid_hw=(H, W)))(ref_m, j(x), j(seq), j(tt), j(g))
        with torch.no_grad():
            out = port(t(x), t(seq), t(tt), t(g), grid_hw=(H, W))
        assert tuple(out.shape) == (1, H * W, 16)
        assert_close(out, ref)

    @pytest.mark.parametrize("cond_grids", [((2, 3),), ((2, 3), (3, 2))], ids=["one_reference", "two_references"])
    def test_reference_tokens_match_jax(self, models, cond_grids):
        ref_m, port = models["base"]
        x, seq, tt, g, cond, _ = inputs(sum(a * b for a, b in cond_grids), seed=2)
        ref = nnx.jit(lambda m, *a: m(*a[:-1], grid_hw=(H, W), cond_tokens=a[-1], cond_grids=cond_grids))(
            ref_m, j(x), j(seq), j(tt), j(g), j(cond))
        with torch.no_grad():
            out = port(t(x), t(seq), t(tt), t(g), grid_hw=(H, W), cond_tokens=t(cond), cond_grids=cond_grids)
        assert tuple(out.shape) == (1, H * W, 16)  # the reference tokens are dropped
        assert_close(out, ref)

    def test_rope_tables_match_jax(self, models):
        ref_m, port = models["base"]
        grids = ((2, 3), (1, 2))
        rc, rs = ref_m.rope_tables(L, (H, W), grids)
        c, s = port.rope_tables(L, (H, W), grids)
        assert tuple(c.shape) == tuple(np.shape(rc)) == (1, L + H * W + 8, 1, 8)
        np.testing.assert_array_equal(c.numpy(), np.asarray(rc))  # both float64 on the host, then f32
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))

    def test_pack_unpack_match_jax(self):
        z = np.random.default_rng(4).normal(size=(2, 4, 6, 8)).astype(np.float32)
        packed = flux2.Flux2Transformer2DModel.pack_latents(torch.from_numpy(z))
        np.testing.assert_array_equal(packed.numpy(),
                                      np.asarray(jax_flux2.Flux2Transformer2DModel.pack_latents(jnp.asarray(z))))
        back = flux2.Flux2Transformer2DModel.unpack_latents(packed, 6, 8)
        np.testing.assert_array_equal(back.numpy(), z)


class TestFlux2Control:
    @pytest.mark.parametrize("scale", [1.0, 0.5])
    def test_control_forward_matches_jax(self, models, scale):
        ref_m, port = models["control"]
        x, seq, tt, g, _, cc = inputs(seed=3)
        ref = nnx.jit(lambda m, *a: m(*a[:-1], grid_hw=(H, W), control_context=a[-1],
                                      control_context_scale=scale))(ref_m, j(x), j(seq), j(tt), j(g), j(cc))
        with torch.no_grad():
            out = port(t(x), t(seq), t(tt), t(g), grid_hw=(H, W), control_context=t(cc),
                       control_context_scale=scale)
        assert_close(out, ref)

    def test_without_context_matches_jax(self, models):
        """No control context: no hints, the main stream alone."""
        ref_m, port = models["control"]
        x, seq, tt, g, _, cc = inputs(seed=3)
        ref = nnx.jit(lambda m, *a: m(*a, grid_hw=(H, W)))(ref_m, j(x), j(seq), j(tt), j(g))
        with torch.no_grad():
            out = port(t(x), t(seq), t(tt), t(g), grid_hw=(H, W))
            hinted = port(t(x), t(seq), t(tt), t(g), grid_hw=(H, W), control_context=t(cc))
        assert_close(out, ref)
        assert not torch.allclose(out, hinted)  # the carried hint heads are not zero
