"""The port's LongCat-Video, Cosmos Predict2 and Kandinsky 5 DiTs against the
JAX package's, on the CPU in f32, at the toy widths of the JAX engine tests
(tests/test_engine_{longcat,cosmos2,kandinsky5}.py), weights built with
seeded numpy values (``jax_build``) and carried with ``loaders/from_jax.py``,
the JAX forwards jitted:

- LongCat plain, with conditioning latents (the isolated conditioning span
  and the noise-vs-all launch), with a padded text mask, and the KV-cache
  continuation (``return_kv`` on the context, then the new frames against
  the cache over the context-plus-new RoPE grid)
- Cosmos with per-frame timesteps, the condition-mask channel and the
  learnable axial position embedding
- Kandinsky 5 with and without ``visual_cond``, with a RoPE scale factor

Tolerance: ‖Δ‖₂ ≤ 1e-5·‖ref‖₂. Also the engines' helpers (CFG-zero*'s
scale, the sentence split, refine's time upsample) against JAX's, and each
converter family's published names round trip.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.models.transformers import cosmos as jax_cosmos
from apex_studio_tpu.models.transformers import kandinsky5 as jax_k5
from apex_studio_tpu.models.transformers import longcat as jax_longcat
from apex_studio_tpu_torch.models.transformers import cosmos, kandinsky5, longcat
from tests.test_engine_cosmos2 import COSMOS_TINY
from tests.test_engine_kandinsky5 import K5_TINY
from tests.test_engine_longcat import LONGCAT_TINY
from tests.torch_port_helpers import assert_published_round_trip, assert_rel_l2, jax_build, port_from_jax

REL = 1e-5


def _tiny(manifest):
    return dict(next(c for c in manifest["spec"]["components"] if c["type"] == "transformer")["config"])


LONGCAT = _tiny(LONGCAT_TINY)
COSMOS = _tiny(COSMOS_TINY)
K5 = _tiny(K5_TINY)
# family → (JAX module, its config, port module, its config, toy config)
MODULES = {
    "longcat": (jax_longcat.LongCatVideoTransformer3DModel, jax_longcat.LongCatConfig,
                longcat.LongCatVideoTransformer3DModel, longcat.LongCatConfig, LONGCAT),
    "cosmos": (jax_cosmos.CosmosTransformer3DModel, jax_cosmos.CosmosConfig,
               cosmos.CosmosTransformer3DModel, cosmos.CosmosConfig, COSMOS),
    # the published Predict2 layout: no learnable position embedding
    "cosmos_predict2": (jax_cosmos.CosmosTransformer3DModel, jax_cosmos.CosmosConfig,
                        cosmos.CosmosTransformer3DModel, cosmos.CosmosConfig,
                        dict(COSMOS, extra_pos_embed_type=None, rope_scale=[1.0, 3.0, 3.0])),
    "kandinsky5": (jax_k5.Kandinsky5Transformer3DModel, jax_k5.Kandinsky5Config,
                   kandinsky5.Kandinsky5Transformer3DModel, kandinsky5.Kandinsky5Config, K5),
    "kandinsky5_i2v": (jax_k5.Kandinsky5Transformer3DModel, jax_k5.Kandinsky5Config,
                       kandinsky5.Kandinsky5Transformer3DModel, kandinsky5.Kandinsky5Config,
                       dict(K5, visual_cond=True)),
}


def normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def builds(name):
    jax_cls, jax_cfg, port_cls, port_cfg, cfg = MODULES[name]
    return (lambda: jax_cls(jax_cfg.from_dict(cfg), dtype=jnp.float32, param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
            lambda: port_cls(port_cfg.from_dict(cfg), dtype=torch.float32))


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(name):
        if name not in made:
            jax_fn, port_fn = builds(name)
            jm = jax_build(jax_fn, seed=len(made))
            made[name] = (jm, port_from_jax(port_fn, jm))
        return made[name]

    return get


# -- LongCat -------------------------------------------------------------------------------

# one jitted forward a static keyword set, shared across cases
_LONGCAT_FWD = {}


def longcat_jax(jm, x, tt, txt, mask=None, cache=None, **static):
    key = tuple(sorted(static.items()))
    if key not in _LONGCAT_FWD:
        _LONGCAT_FWD[key] = nnx.jit(lambda m, x_, t_, c_, k_, kv: m(x_, t_, c_, k_, kv_cache=kv, **static))
    return _LONGCAT_FWD[key](jm, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(txt),
                             None if mask is None else jnp.asarray(mask), cache)


@pytest.mark.parametrize("case", ["plain", "cond_latents", "text_mask"])
def test_longcat_matches_jax(pairs, case):
    """Per-frame timesteps (0 on the conditioning frame); one conditioning
    latent frame attended alone with the cross-attention zeroed there; a
    padded UMT5 mask as the kernel's key-padding row."""
    jm, pm = pairs("longcat")
    x, txt = normal(1, 4, 3, 8, 8, seed=1), normal(1, 5, 24, seed=2)
    tt = np.array([[0.0, 640.0, 640.0]] if case == "cond_latents" else [640.0], np.float32)
    mask = np.array([[1, 1, 1, 0, 0]], np.int32) if case == "text_mask" else None
    static = dict(num_cond_latents=1) if case == "cond_latents" else {}
    ref = longcat_jax(jm, x, tt, txt, mask, **static)
    with torch.inference_mode():
        out = pm(t(x), t(tt), t(txt), t(mask), **static)
    assert_rel_l2(out, np.asarray(ref), REL)
    if case == "text_mask":  # the padded rows do not reach the output
        moved = txt.copy()
        moved[:, 3:] = 40.0
        with torch.inference_mode():
            assert_rel_l2(pm(t(x), t(tt), t(moved), t(mask)), np.asarray(ref), REL)


def test_longcat_kv_cache_matches_jax(pairs):
    """``return_kv`` over two clean context frames (t = 0, the
    cross-attention skipped): the output and each block's pre-RoPE K/V; then
    three new frames against that cache (RoPE over the 5-frame grid), with
    JAX's and the port's own caches."""
    jm, pm = pairs("longcat")
    ctx, empty = normal(1, 4, 2, 8, 8, seed=3), np.zeros((1, 5, 24), np.float32)
    zeros = np.zeros((1, 2), np.float32)
    ref_out, ref_kv = longcat_jax(jm, ctx, zeros, empty, return_kv=True, skip_crs_attn=True)
    with torch.inference_mode():
        out, kv = pm(t(ctx), t(zeros), t(empty), return_kv=True, skip_crs_attn=True)
    assert_rel_l2(out, np.asarray(ref_out), REL)
    assert len(kv) == len(ref_kv) == LONGCAT["depth"]
    for (k, v), (rk, rv) in zip(kv, ref_kv):
        assert tuple(k.shape) == (1, 32, 2, 24)
        assert_rel_l2(k, np.asarray(rk), REL)
        assert_rel_l2(v, np.asarray(rv), REL)

    x, txt = normal(1, 4, 3, 8, 8, seed=4), normal(1, 5, 24, seed=5)
    tt = np.array([500.0], np.float32)
    mask = np.array([[1, 1, 1, 1, 0]], np.int32)
    ref = longcat_jax(jm, x, tt, txt, mask, ref_kv, num_ctx_latents=2)
    with torch.inference_mode():
        got = pm(t(x), t(tt), t(txt), t(mask), kv_cache=kv, num_ctx_latents=2)
        cached_jax = pm(t(x), t(tt), t(txt), t(mask), num_ctx_latents=2,
                        kv_cache=[(t(np.asarray(a)), t(np.asarray(b))) for a, b in ref_kv])
    assert_rel_l2(got, np.asarray(ref), REL)
    assert_rel_l2(cached_jax, np.asarray(ref), REL)


def test_longcat_rope_and_ffn_widths(pairs):
    _, pm = pairs("longcat")
    assert pm.cfg.rope_dims == jax_longcat.LongCatConfig.from_dict(LONGCAT).rope_dims == (8, 8, 8)
    assert longcat.LongCatConfig().rope_dims == (44, 42, 42)  # head dim 128
    # the published block: SwiGLU hidden 256·⌈⅔·4·4096/256⌉ = 11008
    with torch.device("meta"):
        blk = longcat.LongCatBlock(longcat.LongCatConfig(), dtype=torch.bfloat16)
    assert tuple(blk.ffn_w1.weight.shape) == (11008, 4096)


# -- Cosmos --------------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["per_frame_condition", "scalar_t_padding", "predict2_layout"])
def test_cosmos_matches_jax(pairs, case):
    """Per-frame times with the condition-mask channel (the engines' call);
    a scalar time with a padding mask and no condition; the published
    Predict2 layout (no learnable position embedding, another RoPE scale)."""
    jm, pm = pairs("cosmos_predict2" if case == "predict2_layout" else "cosmos")
    x, ctx = normal(1, 4, 3, 8, 8, seed=6), normal(1, 6, 16, seed=7)
    cond = np.zeros((1, 1, 3, 8, 8), np.float32)
    cond[:, :, :1] = 1.0
    if case == "scalar_t_padding":
        x = normal(1, 5, 3, 8, 8, seed=8)
        tt, kw = np.array([0.5], np.float32), dict(padding_mask=(normal(1, 1, 1, 8, 8, seed=9) > 0).astype(np.float32))
    else:
        tt, kw = np.array([[1e-4 / 1.0001, 0.5, 0.5]], np.float32), dict(condition_mask=cond)
    fwd = nnx.jit(lambda m, x_, t_, c_, extra: m(x_, t_, c_, **extra))
    ref = fwd(jm, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(ctx), {k: jnp.asarray(v) for k, v in kw.items()})
    with torch.inference_mode():
        out = pm(t(x), t(tt), t(ctx), **{k: t(v) for k, v in kw.items()})
    assert tuple(out.shape) == (1, 4, 3, 8, 8)
    assert_rel_l2(out, np.asarray(ref), REL)


def test_cosmos_rope_matches_jax(pairs):
    jm, pm = pairs("cosmos")
    for fps in (None, 16.0):
        want = jm._rope(3, 4, 5, fps)
        got = pm.rope_tables(3, 4, 5, fps)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


# -- Kandinsky 5 ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["t2v", "visual_cond", "rope_scale"])
def test_kandinsky5_matches_jax(pairs, case):
    """t2v; i2v's ``visual_cond`` input (noise, the first-frame latent and
    the validity mask: 2·4 + 1 channels); a RoPE scale factor."""
    jm, pm = pairs("kandinsky5_i2v" if case == "visual_cond" else "kandinsky5")
    x = normal(1, 9 if case == "visual_cond" else 4, 2, 8, 8, seed=10)
    ctx, pooled = normal(1, 6, 16, seed=11), normal(1, 12, seed=12)
    tt = np.array([730.0], np.float32)
    scale = (1.0, 2.0, 2.0) if case == "rope_scale" else (1.0, 1.0, 1.0)
    fwd = nnx.jit(lambda m, *a: m(*a, scale_factor=scale))
    ref = fwd(jm, *map(jnp.asarray, (x, tt, ctx, pooled)))
    with torch.inference_mode():
        out = pm(t(x), t(tt), t(ctx), t(pooled), scale_factor=scale)
    assert tuple(out.shape) == (1, 4, 2, 8, 8)
    assert_rel_l2(out, np.asarray(ref), REL)


def test_kandinsky5_rope_tables_match_jax(pairs):
    jm, pm = pairs("kandinsky5")
    want = jm._visual_rope(2, 3, 4, (1.0, 2.0, 2.0))
    got = pm.visual_rope(2, 3, 4, (1.0, 2.0, 2.0))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert kandinsky5.Kandinsky5Config().head_dim == 64  # 28 heads at 1792


# -- the engines' helpers ------------------------------------------------------------------


def test_optimized_scale_matches_jax():
    from apex_studio_tpu.engine.longcat import optimized_scale as jax_optimized_scale

    from apex_studio_tpu_torch.engine.longcat import optimized_scale

    pos, neg = normal(2, 4, 3, 5, 6, seed=13), normal(2, 4, 3, 5, 6, seed=14)
    want = np.asarray(jax_optimized_scale(pos, neg))
    got = optimized_scale(t(pos), t(neg)).numpy()
    assert got.shape == want.shape == (2, 1, 1, 1, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_split_into_sentences_matches_jax():
    from apex_studio_tpu.engine.longcat import split_into_sentences as jax_split

    from apex_studio_tpu_torch.engine.longcat import split_into_sentences

    for text in ("A cat sits. It naps!  Then?\nIt wakes.", "one sentence", "  ", "Dr. Who... ends.Here"):
        assert split_into_sentences(text) == jax_split(text)
    assert split_into_sentences("A cat sits. It naps!") == ["A cat sits.", "It naps!"]


@pytest.mark.parametrize("frames", [1, 3, 5])
def test_refine_time_upsample_matches_jax(frames):
    """Refine's 2× time upsample against ``jax.image.resize(..., "trilinear")``
    at the same H and W: within 1e-6, the first and last frames the input's
    own exactly (both libraries clamp at the edge)."""
    import jax

    from apex_studio_tpu_torch.engine.longcat import upsample_time

    px = normal(1, 3, frames, 6, 10, seed=15 + frames)
    want = np.asarray(jax.image.resize(jnp.asarray(px), (1, 3, 2 * frames, 6, 10), "trilinear"))
    got = upsample_time(t(px), 2 * frames).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, :, 0], px[:, :, 0])
    np.testing.assert_array_equal(got[:, :, -1], px[:, :, -1])


# -- published names -----------------------------------------------------------------------


@pytest.mark.parametrize("family", ["longcat", "cosmos", "kandinsky5"])
def test_published_names_round_trip(family):
    jax_fn, port_fn = builds({"cosmos": "cosmos_predict2", "kandinsky5": "kandinsky5_i2v"}.get(family, family))
    assert_published_round_trip(family, port_fn, nnx.eval_shape(jax_fn))
