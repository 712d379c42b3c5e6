"""The port's HunyuanVideo 1.5 DiT and its FlowMatchDiscrete scheduler against
the JAX package's, on the CPU in f32.

Weights come from the JAX module (its own seeded init) through
``apex_studio_tpu_torch.loaders.from_jax``; inputs are seeded numpy arrays.
Tolerance: max|Δ| ≤ 1e-4·max|ref| (the attention runs the flash kernel's
plain version here, JAX its XLA path). Sigma grids are float64 numpy on both
sides and must agree to 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.models.transformers.hunyuanvideo15 import HYV15Config as JaxConfig
from apex_studio_tpu.models.transformers.hunyuanvideo15 import HunyuanVideo15Transformer3DModel as JaxDiT
from apex_studio_tpu.models.transformers.hunyuanvideo15 import TokenRefiner as JaxRefiner
from apex_studio_tpu.schedulers.flow_match import FlowMatchDiscreteScheduler as JaxScheduler
from apex_studio_tpu_torch.models.transformers.hunyuanvideo15 import (
    HYV15Config,
    HunyuanVideo15Transformer3DModel,
    TokenRefiner,
)
from apex_studio_tpu_torch.schedulers import create_scheduler
from tests.torch_port_helpers import assert_close, port_from_jax

# tests/test_models_hyv15.py's tiny DiT at 2 blocks, 2 heads of 32, rope axes 8/12/12
TINY = dict(in_channels=9, out_channels=4, num_attention_heads=2, attention_head_dim=32, num_layers=2,
            num_refiner_layers=2, mlp_ratio=2.0, text_embed_dim=32, text_embed_2_dim=16,
            image_embed_dim=16, rope_axes_dim=(8, 12, 12))


def build_pair(**overrides):
    kw = {**TINY, **overrides}
    jm = JaxDiT(JaxConfig(**kw), dtype=jnp.float32, param_dtype=jnp.float32, rngs=nnx.Rngs(0))
    pm = port_from_jax(lambda: HunyuanVideo15Transformer3DModel(HYV15Config(**kw), dtype=torch.float32), jm)
    return jm, pm


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def inputs(cfg, b=2, t=2, h=4, w=6, lt=7, lb=5, li=4, seed=0):
    rng = np.random.default_rng(seed)
    text_mask = np.ones((b, lt), np.int32)
    text_mask[0, 4:] = 0  # the first prompt is padded: the refiner's key mask bites
    text2_mask = np.ones((b, lb), np.int32)
    text2_mask[1, 3:] = 0
    return {
        "x": rng.normal(size=(b, cfg["in_channels"], t, h, w)).astype(np.float32),
        "t": np.array([900.0, 250.0], np.float32)[:b],
        "text": rng.normal(size=(b, lt, cfg["text_embed_dim"])).astype(np.float32),
        "text_mask": text_mask,
        "text_2": rng.normal(size=(b, lb, cfg["text_embed_2_dim"])).astype(np.float32),
        "text_2_mask": text2_mask,
        "image_embeds": rng.normal(size=(b, li, cfg["image_embed_dim"])).astype(np.float32),
    }


# (name, keys passed to the forward, image_stream_zeroed)
CASES = [
    ("i2v_byt5_masked_text", ("text_mask", "text_2", "text_2_mask", "image_embeds"), False),
    ("t2v_zeroed_vision", ("text_mask", "text_2", "text_2_mask", "image_embeds"), True),
    ("no_byt5", ("text_mask", "image_embeds"), False),
    ("text_only_unmasked", (), False),
]


class TestHYV15DiT:
    @pytest.mark.parametrize("name,keys,zeroed", CASES, ids=[c[0] for c in CASES])
    def test_forward_matches_jax(self, pair, name, keys, zeroed):
        jm, pm = pair
        arrs = inputs(TINY)
        kw = {k: arrs[k] for k in keys}
        ref = jm(jnp.asarray(arrs["x"]), jnp.asarray(arrs["t"]), jnp.asarray(arrs["text"]),
                 **{k: jnp.asarray(v) for k, v in kw.items()}, image_stream_zeroed=zeroed)
        with torch.no_grad():
            out = pm(torch.from_numpy(arrs["x"]), torch.from_numpy(arrs["t"]), torch.from_numpy(arrs["text"]),
                     **{k: torch.from_numpy(v) for k, v in kw.items()}, image_stream_zeroed=zeroed)
        assert tuple(out.shape) == (2, 4, 2, 4, 6)
        assert_close(out, ref)

    def test_refiner_mask_matches_jax_and_bites(self, pair):
        """The token refiner alone, with a partly masked [B, Lt] text mask:
        equal to JAX, and the masked keys change nothing but what they should."""
        jm, pm = pair
        arrs = inputs(TINY)
        args = (arrs["text"], arrs["t"], arrs["text_mask"])
        ref = jm.context_embedder(*(jnp.asarray(a) for a in args))
        with torch.no_grad():
            out = pm.context_embedder(*(torch.from_numpy(a) for a in args))
            unmasked = pm.context_embedder(torch.from_numpy(args[0]), torch.from_numpy(args[1]), None)
        assert isinstance(pm.context_embedder, TokenRefiner) and isinstance(jm.context_embedder, JaxRefiner)
        assert_close(out, ref)
        # padding the first prompt changes its valid rows; the second, unpadded, is untouched
        assert (out[0, :4] - unmasked[0, :4]).abs().max() > 1e-4
        assert torch.allclose(out[1], unmasked[1], atol=1e-5)

    @pytest.mark.parametrize("pt,p", [(1, 1), (1, 2), (2, 2)])
    def test_patchify_unpatchify_match_jax_and_round_trip(self, pt, p):
        kw = dict(patch_size=p, patch_size_t=pt, in_channels=4, out_channels=4, num_layers=1)
        jm, pm = build_pair(**kw)
        x = np.random.default_rng(1).normal(size=(2, 4, 4, 4, 6)).astype(np.float32)
        tokens = pm.patchify(torch.from_numpy(x))
        assert_close(tokens, jm.patchify(jnp.asarray(x)), rel=0)
        back = pm.unpatchify(tokens, 4, 4, 6)
        assert_close(back, jm.unpatchify(jm.patchify(jnp.asarray(x)), 4, 4, 6), rel=0)
        # channel-slowest on both sides: patchify's [C, pt, ph, pw] order inverts exactly
        assert torch.equal(back, torch.from_numpy(x))

    def test_rope_tables_match_jax(self, pair):
        jm, pm = pair
        jc, js = jm.rope_tables(3, 4, 5)
        pc, ps = pm.rope_tables(3, 4, 5)
        assert tuple(pc.shape) == (1, 60, 1, 16) and pc.dtype == torch.float32
        assert_close(pc, jc, rel=0)
        assert_close(ps, js, rel=0)


class TestFlowMatchDiscrete:
    @pytest.mark.parametrize("steps,shift", [(2, 9.0), (50, 9.0), (8, 7.0)])
    def test_sigmas_and_timesteps_match_jax(self, steps, shift):
        ref = JaxScheduler(num_train_timesteps=1000, shift=shift)
        ref.set_timesteps(steps)
        sch = create_scheduler("FlowMatchDiscreteScheduler", {"num_train_timesteps": 1000, "shift": shift})
        sch.set_timesteps(steps)
        assert type(sch).__name__ == "FlowMatchDiscreteScheduler"
        np.testing.assert_allclose(sch.sigmas, ref.sigmas, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(sch.timesteps, ref.timesteps)
        assert sch.sigmas[0] == 1.0 and sch.sigmas[-1] == 0.0

    def test_step_matches_jax(self):
        ref = JaxScheduler(shift=9.0)
        sch = create_scheduler("FlowMatchDiscreteScheduler", {"shift": 9.0})
        for s in (ref, sch):
            s.set_timesteps(4)
        rng = np.random.default_rng(2)
        x, v = (rng.normal(size=(1, 4, 2, 3, 3)).astype(np.float32) for _ in range(2))
        for i in range(4):
            want = np.asarray(ref.step_at(jnp.asarray(v), jnp.asarray(x), i))
            got = sch.step_at(torch.from_numpy(v), torch.from_numpy(x), i)
            assert_close(got, want, rel=1e-6)
