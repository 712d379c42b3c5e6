"""The port's other image DiTs and HunyuanImage 2.1's VAE against the JAX
package's, on the CPU in f32: Chroma, Ovis-Image, Bria FIBO, HiDream-I1 (its
MoE feed-forward on its own too) and HunyuanImage 2.1 (base and distilled)
at the toy widths of the JAX engine tests
(tests/test_engine_{chroma,ovis,fibo,hidream,hunyuanimage}.py), weights built
with seeded numpy values (``jax_build``) and carried with
``loaders/from_jax.py``, the JAX forwards jitted; Chroma's key-padding
route against the JAX pair mask; each converter family's published names
round trip.

Tolerance: max|Δ| ≤ 1e-4·max|ref| (the port's usual f32 limit); HiDream's
routing exactly (the same experts and weights within 1e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.models.transformers import chroma as jax_chroma
from apex_studio_tpu.models.transformers import fibo as jax_fibo
from apex_studio_tpu.models.transformers import hidream as jax_hidream
from apex_studio_tpu.models.transformers import hunyuanimage as jax_hyi
from apex_studio_tpu.models.transformers import ovis as jax_ovis
from apex_studio_tpu.models.vaes import hunyuanimage_vae as jax_hyi_vae
from apex_studio_tpu_torch.models.transformers import chroma, fibo, hidream, hunyuanimage, ovis
from apex_studio_tpu_torch.ops.attention import _prep_bias
from apex_studio_tpu_torch.models.vaes import hunyuanimage_vae
from tests.test_engine_chroma import CHROMA_TINY
from tests.test_engine_fibo import FIBO_TINY
from tests.test_engine_hidream import HIDREAM_TINY
from tests.test_engine_hunyuanimage import HYI_TINY
from tests.test_engine_ovis import OVIS_TINY
from tests.torch_port_helpers import assert_close, assert_published_round_trip, jax_build, port_from_jax


def _tiny(manifest, ctype="transformer"):
    return dict(next(c for c in manifest["spec"]["components"] if c["type"] == ctype)["config"])


CHROMA = _tiny(CHROMA_TINY)
OVIS = _tiny(OVIS_TINY)
FIBO = _tiny(FIBO_TINY)
HIDREAM = _tiny(HIDREAM_TINY)
HYI = _tiny(HYI_TINY)
HYI_DISTILLED = dict(HYI, guidance_embeds=True, use_meanflow=True)
HYI_VAE = _tiny(HYI_TINY, "vae")
# family → (JAX module, its config, port module, its config)
MODULES = {
    "chroma": (jax_chroma.ChromaTransformer2DModel, jax_chroma.ChromaConfig,
               chroma.ChromaTransformer2DModel, chroma.ChromaConfig, CHROMA),
    "ovis": (jax_ovis.OvisImageTransformer2DModel, jax_ovis.OvisConfig,
             ovis.OvisImageTransformer2DModel, ovis.OvisConfig, OVIS),
    "fibo": (jax_fibo.BriaFiboTransformer2DModel, jax_fibo.FiboConfig,
             fibo.BriaFiboTransformer2DModel, fibo.FiboConfig, FIBO),
    "hidream": (jax_hidream.HiDreamImageTransformer2DModel, jax_hidream.HiDreamConfig,
                hidream.HiDreamImageTransformer2DModel, hidream.HiDreamConfig, HIDREAM),
    "hunyuanimage": (jax_hyi.HunyuanImageTransformer2DModel, jax_hyi.HunyuanImageConfig,
                     hunyuanimage.HunyuanImageTransformer2DModel, hunyuanimage.HunyuanImageConfig, HYI),
    "hunyuanimage_distilled": (jax_hyi.HunyuanImageTransformer2DModel, jax_hyi.HunyuanImageConfig,
                               hunyuanimage.HunyuanImageTransformer2DModel, hunyuanimage.HunyuanImageConfig,
                               HYI_DISTILLED),
    "hunyuanimage_vae": (jax_hyi_vae.AutoencoderKLHunyuanImage, jax_hyi_vae.HunyuanImageVAEConfig,
                         hunyuanimage_vae.AutoencoderKLHunyuanImage, hunyuanimage_vae.HunyuanImageVAEConfig,
                         HYI_VAE),
}


def normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def builds(name):
    jax_cls, jax_cfg, port_cls, port_cfg, cfg = MODULES[name]
    return (lambda: jax_cls(jax_cfg.from_dict(cfg), dtype=jnp.float32, param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
            lambda: port_cls(port_cfg.from_dict(cfg), dtype=torch.float32))


def decisive_gates(jm, seed=7):
    """Give every HiDream router a gate wide enough that no token's second and
    third scores lie within float rounding of each other (a tie would let
    ``lax.top_k`` and ``torch.topk`` pick different experts)."""
    rng = np.random.default_rng(seed)
    for _, mod in nnx.iter_graph(jm):
        if isinstance(mod, jax_hidream._MoESwiGLU):
            shape = mod.gate_weight.value.shape
            mod.gate_weight.value = jnp.asarray(rng.normal(size=shape).astype(np.float32) * 2.0 / np.sqrt(shape[1]))
    return jm


def pair(name, seed=0):
    jax_fn, port_fn = builds(name)
    jm = jax_build(jax_fn, seed=seed)
    if name == "hidream":
        decisive_gates(jm)
    return jm, port_from_jax(port_fn, jm)


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(name):
        if name not in made:
            made[name] = pair(name)
        return made[name]

    return get


# -- the DiTs -------------------------------------------------------------------------------


def test_chroma_matches_jax(pairs):
    jm, pm = pairs("chroma")
    x, txt = normal(1, 16, 16, seed=1), normal(1, 6, 16, seed=2)
    tt = np.array([0.4], np.float32)
    fwd = nnx.jit(lambda m, x_, c, t_: m(x_, c, t_, grid_hw=(4, 4)))
    ref = fwd(jm, *map(jnp.asarray, (x, txt, tt)))
    with torch.inference_mode():
        out = pm(t(x), t(txt), t(tt), grid_hw=(4, 4))
    assert_close(out, np.asarray(ref))


def test_chroma_input_vec_equals_jax():
    tt = np.array([0.25, 0.9], np.float32)
    want = np.asarray(jax_chroma.chroma_input_vec(jnp.asarray(tt), 16, 344))
    got = chroma.chroma_input_vec(t(tt), 16, 344).numpy()
    assert got.shape == want.shape == (2, 344, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_chroma_key_padding_route_matches_the_pair_mask(pairs):
    """A padded prompt: JAX's [B, 1, S, S] pair mask (its XLA route) against
    the port's key-padding row (the kernel's route). The image output agrees;
    the padded text rows are where the two differ, and they never reach it."""
    jm, pm = pairs("chroma")
    x, txt = normal(1, 16, 16, seed=3), normal(1, 6, 16, seed=4)
    mask = np.array([[1, 1, 1, 1, 0, 0]], np.int32)
    tt = np.array([0.6], np.float32)
    fwd = nnx.jit(lambda m, x_, c, t_, msk: m(x_, c, t_, attention_mask=msk, grid_hw=(4, 4)))
    ref = fwd(jm, *map(jnp.asarray, (x, txt, tt, mask)))
    with torch.inference_mode():
        out = pm(t(x), t(txt), t(tt), attention_mask=t(mask), grid_hw=(4, 4))
        # the padded text tokens' values do not reach the image
        moved = txt.copy()
        moved[:, 4:] = 50.0
        other = pm(t(x), t(moved), t(tt), attention_mask=t(mask), grid_hw=(4, 4))
        unmasked = pm(t(x), t(txt), t(tt), grid_hw=(4, 4))
    assert_close(out, np.asarray(ref))
    assert_close(other, np.asarray(ref))
    assert (out - unmasked).abs().max() > 1e-3

    # inside one single block: the kept rows agree, the padded text rows differ
    blk_j, blk_p = jm.single_transformer_blocks[0], pm.single_transformer_blocks[0]
    xs, mod = normal(1, 22, 16, seed=5), normal(1, 3, 16, seed=6)
    cos, sin = pm.rope_tables(6, 4, 4)
    full = np.concatenate([mask.astype(np.float32), np.ones((1, 16), np.float32)], axis=1)
    pair_bias = ((1.0 - full[:, None, :] * full[:, :, None]) * -1e9)[:, None]
    want = np.asarray(nnx.jit(lambda b, *a: b(*a))(blk_j, jnp.asarray(xs), jnp.asarray(mod), jnp.asarray(cos.numpy()),
                                                   jnp.asarray(sin.numpy()), jnp.asarray(pair_bias)))
    with torch.inference_mode():
        got = blk_p(t(xs), t(mod), cos, sin, _prep_bias(None, t(full).bool())).numpy()
    kept = full[0].astype(bool)
    assert_close(got[:, kept], want[:, kept])
    assert np.abs(got[:, ~kept] - want[:, ~kept]).max() > 1e-3


def test_ovis_matches_jax(pairs):
    jm, pm = pairs("ovis")
    x, txt = normal(1, 16, 16, seed=7), normal(1, 5, 48, seed=8)
    tt = np.array([0.7], np.float32)
    ref = nnx.jit(lambda m, x_, c, t_: m(x_, c, t_, grid_hw=(4, 4)))(jm, *map(jnp.asarray, (x, txt, tt)))
    with torch.inference_mode():
        out = pm(t(x), t(txt), t(tt), grid_hw=(4, 4))
    assert_close(out, np.asarray(ref))
    want = jm.rope_tables(5, 4, 4)
    got = pm.rope_tables(5, 4, 4)
    for w, g in zip(want, got):  # f32 cos / sin of the same angles: within one ulp
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_fibo_matches_jax(pairs, masked):
    """Three text-encoder layers for three blocks, with and without a padded
    prompt (the dual blocks' 0/1 key bias and the single blocks' mask)."""
    jm, pm = pairs("fibo")
    x, txt = normal(1, 16, 8, seed=9), normal(1, 6, 24, seed=10)
    layers = [normal(1, 6, 12, seed=11 + i) for i in range(3)]
    mask = np.array([[1, 1, 1, 1, 1, 0]], np.int32) if masked else None
    tt = np.array([640.0], np.float32)
    fwd = nnx.jit(lambda m, x_, c, ls, t_, msk: m(x_, c, ls, t_, text_mask=msk, grid_hw=(4, 4)))
    ref = fwd(jm, jnp.asarray(x), jnp.asarray(txt), [jnp.asarray(a) for a in layers], jnp.asarray(tt),
              None if mask is None else jnp.asarray(mask))
    with torch.inference_mode():
        out = pm(t(x), t(txt), [t(a) for a in layers], t(tt), text_mask=t(mask), grid_hw=(4, 4))
    assert_close(out, np.asarray(ref))


def test_hidream_matches_jax(pairs):
    jm, pm = pairs("hidream")
    x, t5 = normal(1, 4, 8, 8, seed=12), normal(1, 5, 12, seed=13)
    llama = [normal(1, 4, 12, seed=14 + i) for i in range(2)]
    pooled, tt = normal(1, 16, seed=16), np.array([700.0], np.float32)
    ref = nnx.jit(lambda m, *a: m(*a))(jm, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(t5),
                                       [jnp.asarray(a) for a in llama], jnp.asarray(pooled))
    with torch.inference_mode():
        out = pm(t(x), t(tt), t(t5), [t(a) for a in llama], t(pooled))
    assert_close(out, np.asarray(ref))


def test_hidream_moe_routing_and_output_match_jax(pairs):
    """The MoE feed-forward alone on 64 tokens: the routing weights (top 2 of
    3, not renormalized) and the output."""
    import jax

    jm, pm = pairs("hidream")
    moe_j, moe_p = jm.single_stream_blocks[0].ff_i, pm.single_stream_blocks[0].ff_i
    x = normal(1, 64, 16, seed=17)
    scores = jax.nn.softmax(jnp.asarray(x) @ moe_j.gate_weight.value.T, axis=-1)
    top = np.sort(np.asarray(scores), axis=-1)
    assert (top[..., -2] - top[..., -3]).min() > 1e-4  # no tie at the cut
    topw, topi = jax.lax.top_k(scores, 2)
    want_w = np.asarray((jax.nn.one_hot(topi, 3) * topw[..., None]).sum(-2))
    with torch.inference_mode():
        got_w = moe_p.routing(t(x)).numpy()
        out = moe_p(t(x))
    np.testing.assert_array_equal(got_w > 0, want_w > 0)
    np.testing.assert_allclose(got_w, want_w, rtol=0, atol=1e-6)
    assert np.allclose(got_w.sum(-1) < 1.0, True)  # the kept scores are not renormalized
    assert_close(out, np.asarray(nnx.jit(lambda m, a: m(a))(moe_j, jnp.asarray(x))))


@pytest.mark.parametrize("case", ["base", "distilled", "no_glyphs"])
def test_hunyuanimage_matches_jax(pairs, case):
    """The base DiT with a padded prompt and a byT5 glyph branch; the
    distilled one with guidance and meanflow ``t_r``; the base without glyph
    features."""
    jm, pm = pairs("hunyuanimage_distilled" if case == "distilled" else "hunyuanimage")
    x, text = normal(1, 4, 4, 6, seed=18), normal(1, 7, 32, seed=19)
    text_mask = np.array([[1, 1, 1, 1, 1, 0, 0]], np.int32)
    text_2, text_2_mask = normal(1, 3, 16, seed=20), np.array([[1, 1, 0]], np.int32)
    if case == "no_glyphs":
        text_2 = text_2_mask = None
    tt = np.array([870.0], np.float32)
    g = np.array([3250.0], np.float32) if case == "distilled" else None
    t_r = np.array([500.0], np.float32) if case == "distilled" else None
    args = (x, tt, text, text_mask, text_2, text_2_mask)
    fwd = nnx.jit(lambda m, a, g_, r: m(*a, guidance=g_, t_r=r))
    ref = fwd(jm, tuple(None if a is None else jnp.asarray(a) for a in args),
              None if g is None else jnp.asarray(g), None if t_r is None else jnp.asarray(t_r))
    with torch.inference_mode():
        out = pm(*map(t, args), guidance=t(g), t_r=t(t_r))
    assert_close(out, np.asarray(ref))


# -- the 32× VAE ----------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [HYI_VAE, dict(HYI_VAE, layers_per_block=2, block_out_channels=[8, 16, 32, 32],
                                                 spatial_compression_ratio=8, shift_factor=0.1)],
                         ids=["tiny", "three_resamplers_shift"])
def test_hunyuanimage_vae_matches_jax(cfg):
    jm = jax_build(lambda: jax_hyi_vae.AutoencoderKLHunyuanImage(jax_hyi_vae.HunyuanImageVAEConfig.from_dict(cfg),
                                                                 rngs=nnx.Rngs(0)), seed=21)
    pm = port_from_jax(lambda: hunyuanimage_vae.AutoencoderKLHunyuanImage(
        hunyuanimage_vae.HunyuanImageVAEConfig.from_dict(cfg)), jm)
    scale = cfg["spatial_compression_ratio"]
    px, z = normal(1, 3, 16, 24, seed=22), normal(1, 4, 16 // scale, 24 // scale, seed=23)
    want_z = nnx.jit(lambda m, a: m.encode(a))(jm, jnp.asarray(px))
    want_px = nnx.jit(lambda m, a: m.decode(a))(jm, jnp.asarray(z))
    with torch.inference_mode():
        got_z, got_px = pm.encode(t(px)), pm.decode(t(z))
    assert_close(got_z, np.asarray(want_z))
    assert_close(got_px, np.asarray(want_px))


def test_space_to_depth_equals_jax():
    x = normal(2, 6, 8, 10, seed=24)
    want = np.asarray(jax_hyi_vae._space_to_depth(jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    got = hunyuanimage_vae.space_to_depth(t(x))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(hunyuanimage_vae.depth_to_space(got).numpy(), x)


# -- published names ----------------------------------------------------------------------


@pytest.mark.parametrize("family", ["chroma", "ovis", "fibo", "hidream", "hunyuanimage", "hunyuanimage_vae"])
def test_published_names_round_trip(family):
    jax_fn, port_fn = builds("hunyuanimage_distilled" if family == "hunyuanimage" else family)
    assert_published_round_trip(family, port_fn, nnx.eval_shape(jax_fn))
