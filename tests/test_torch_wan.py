"""The port's Wan DiT against the JAX package's, on the CPU in f32.

Toy widths: 2 blocks, 2 heads of 32 (dim 64, RoPE axes (12, 10, 10)), FFN 96,
text dim 48, freq dim 32. The JAX modules are built from seeded numpy values
(``jax_build``) and carried into the port with ``loaders/from_jax.py``; the
JAX forwards run jitted. Outputs are held to rel L2 ≤ 1e-4; the RoPE tables
to max|Δ| ≤ 1e-6; patchify / unpatchify are exact. Cases: t2v latents with a
5 × 6 token grid over 3 latent frames, and the Wan 2.1 i2v image K/V branch
(``image_dim`` / ``added_kv_proj_dim``); the A14B i2v input (noise, frame
mask and condition latents) goes through the engine tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from apex_studio_tpu.models.transformers import wan as jax_wan
from apex_studio_tpu_torch.models.registry import _load_builtin_families, transformer_registry
from apex_studio_tpu_torch.models.transformers import wan
from apex_studio_tpu_torch.ops.attention import attention_registry
from tests.torch_port_helpers import assert_rel_l2, jax_build, port_from_jax

TINY = dict(num_attention_heads=2, attention_head_dim=32, in_channels=4, out_channels=4, text_dim=48,
            freq_dim=32, ffn_dim=96, num_layers=2)
CASES = {
    "t2v": TINY,
    "image_kv_branch": dict(TINY, image_dim=40, added_kv_proj_dim=64),
}
F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
LATENT = (3, 10, 12)  # T, H, W: 3 × 5 × 6 tokens


def pair(cfg, seed):
    ref = jax_build(lambda: jax_wan.WanTransformer3DModel(jax_wan.WanConfig(**cfg), rngs=nnx.Rngs(0), **F32),
                    seed=seed)
    port = port_from_jax(lambda: wan.WanTransformer3DModel(wan.WanConfig(**cfg), dtype=torch.float32), ref)
    return ref, port


@pytest.fixture(scope="module")
def models():
    return {name: pair(cfg, seed) for seed, (name, cfg) in enumerate(CASES.items())}


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, cfg["in_channels"], *LATENT)).astype(np.float32)
    ctx = rng.normal(size=(1, 7, cfg["text_dim"])).astype(np.float32)
    ctx[:, 5:] = 0.0  # zeroed padding, as the engine hands it over
    img = rng.normal(size=(1, 5, cfg.get("image_dim") or 1)).astype(np.float32)
    return x, np.array([731.0], np.float32), ctx, img


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(models, case):
    ref, port = models[case]
    cfg = CASES[case]
    x, ts, ctx, img = inputs(cfg)
    image = img if cfg.get("image_dim") else None
    want = nnx.jit(lambda m, *a: m(*a))(
        ref, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), None if image is None else jnp.asarray(image))
    with torch.no_grad():
        got = port(t(x), t(ts), t(ctx), None if image is None else t(image))
    assert tuple(got.shape) == (1, cfg["out_channels"], *LATENT)
    assert_rel_l2(got, want, 1e-4)


def test_image_branch_changes_the_output(models):
    _, port = models["image_kv_branch"]
    x, ts, ctx, img = inputs(CASES["image_kv_branch"])
    with torch.no_grad():
        assert not torch.allclose(port(t(x), t(ts), t(ctx), t(img)), port(t(x), t(ts), t(ctx)))


def test_patchify_and_unpatchify_match_jax(models):
    ref, port = models["t2v"]
    x = np.random.default_rng(3).normal(size=(2, 4, 3, 10, 12)).astype(np.float32)
    np.testing.assert_array_equal(port.patchify(t(x)).numpy(), np.asarray(ref.patchify(jnp.asarray(x))))
    tok = np.random.default_rng(4).normal(size=(2, 90, 16)).astype(np.float32)
    np.testing.assert_array_equal(port.unpatchify(t(tok), *LATENT).numpy(),
                                  np.asarray(ref.unpatchify(jnp.asarray(tok), *LATENT)))


def test_rope_tables_match_jax(models):
    ref, port = models["t2v"]
    for g, w in zip(port.rope_tables(3, 5, 7), ref.rope_tables(3, 5, 7)):
        assert tuple(g.shape) == tuple(w.shape) == (1, 105, 1, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_two_unmasked_attention_calls_a_block(models, monkeypatch):
    """Self-attention over the 30 tokens, cross-attention over the 7 text
    rows, no bias: the zeroed padding stays attended, as in JAX."""
    _, port = models["t2v"]
    calls = []
    flash = attention_registry.get("flash")
    monkeypatch.setitem(attention_registry._entries, "flash",
                        lambda q, k, *a, **kw: calls.append((q.shape[1], k.shape[1], q.shape[2],
                                                             kw.get("bias"))) or flash(q, k, *a, **kw))
    x, ts, ctx, _ = inputs(TINY)
    with torch.no_grad():
        port(t(x), t(ts), t(ctx))
    assert calls == [(90, 90, 2, None), (90, 7, 2, None)] * TINY["num_layers"]


def test_registry_and_unported_options():
    _load_builtin_families()
    assert transformer_registry.get("wan.base") is wan.WanTransformer3DModel
    assert transformer_registry.get("wan") is wan.WanTransformer3DModel
    assert wan.WanConfig().rope_axes_dims == (44, 42, 42) and wan.WanConfig().dim == 5120
    # SkyReels' options, ported since: the fps embedding and its projection (held
    # against JAX in tests/test_torch_skyreels.py); the DiT registered as skyreels
    model = wan.WanTransformer3DModel(wan.WanConfig(**TINY, inject_sample_info=True), dtype=torch.float32)
    assert tuple(model.fps_embedding.shape) == (2, 64) and tuple(model.fps_projection_2.weight.shape) == (6 * 64, 64)
    assert transformer_registry.get("skyreels.base") is wan.WanTransformer3DModel
