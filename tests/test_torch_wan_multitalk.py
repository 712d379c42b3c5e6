"""The port's Wan MultiTalk DiT against the JAX package's, on the CPU in f32,
the weights carried from the JAX module (seeded numpy values, ``jax_build``)
and the JAX forwards jitted, at the toy widths of
tests/test_engine_wan_multitalk.py (2 heads of 12, 2 blocks, a 16-wide CLIP
branch, 4 audio tokens a speaker and frame): one speaker and two (the L-RoPE
routing through ``ref_attn_maps``, there computed in query-row chunks), with
and without the image branch. ``ref_attn_maps`` in chunks of a few rows
against the JAX function's whole score tensor; ``rope_1d_pairs`` and the
audio projection on their own.

Tolerance: max|Δ| ≤ 1e-4·max|ref| (the port's usual f32 limit).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.models.transformers import wan_multitalk as jax_mt
from apex_studio_tpu_torch.models.transformers import wan_multitalk as mt
from tests.test_engine_wan_multitalk import _TF_CFG
from tests.torch_port_helpers import assert_close, assert_published_round_trip, jax_build, port_from_jax


def normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def masks(n_ref=16):
    m = np.zeros((3, n_ref), np.float32)
    m[0, :n_ref // 2] = 1
    m[1, n_ref // 2:] = 1
    m[2, ::5] = 1
    return m


def multitalk_pair(**overrides):
    kw = {**_TF_CFG, **overrides}
    jm = jax_build(lambda: jax_mt.WanMultiTalkTransformer3DModel(jax_mt.WanMultiTalkConfig(**kw), dtype=jnp.float32,
                                                                 param_dtype=jnp.float32, rngs=nnx.Rngs(0)))
    return jm, port_from_jax(lambda: mt.WanMultiTalkTransformer3DModel(mt.WanMultiTalkConfig(**kw),
                                                                       dtype=torch.float32), jm)


@pytest.mark.parametrize("humans,image", [(1, True), (2, True), (2, False)],
                         ids=["one_speaker", "two_speakers", "two_speakers_no_image_branch"])
def test_forward_matches_jax(humans, image, monkeypatch):
    # the port's maps in chunks of 5 query rows (48 tokens: the last chunk ragged)
    monkeypatch.setattr(mt, "REF_ATTN_ROWS", 5)
    jm, pm = multitalk_pair(**({} if image else dict(image_dim=None, added_kv_proj_dim=None)))
    x, text = normal(1, 10, 3, 8, 8, seed=1), normal(1, 5, 32, seed=2)
    img = normal(1, 3, 16, seed=3) if image else None
    audio, m = normal(humans, 5, 5, 2, 16, seed=4), masks()
    t = np.array([500.0], np.float32)
    fn = nnx.jit(lambda mod, x, t, c, i, a, mk: mod(x, t, c, i, a, mk))
    ref = np.asarray(fn(jm, jnp.asarray(x), jnp.asarray(t), jnp.asarray(text),
                        None if img is None else jnp.asarray(img), jnp.asarray(audio), jnp.asarray(m)))
    with torch.inference_mode():
        out = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(text),
                 None if img is None else torch.from_numpy(img), torch.from_numpy(audio), torch.from_numpy(m))
    assert tuple(out.shape) == ref.shape == (1, 4, 3, 8, 8)
    assert_close(out, ref)


@pytest.mark.parametrize("rows", [1, 3, 7, 4096])
def test_ref_attn_maps_in_chunks_match_jax(rows, monkeypatch):
    """Chunks of 1, 3 and 7 query rows (ragged tails) and one whole chunk
    against the JAX function's [B, H, M, R] scores."""
    monkeypatch.setattr(mt, "REF_ATTN_ROWS", rows)
    q, k = normal(1, 40, 4, 12, seed=5), normal(1, 16, 4, 12, seed=6)
    ref = np.asarray(jax_mt.ref_attn_maps(jnp.asarray(q), jnp.asarray(k), jnp.asarray(masks())))
    out = mt.ref_attn_maps(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(masks()))
    assert tuple(out.shape) == ref.shape == (3, 40)
    assert_close(out, ref, rel=1e-5)


def test_rope_1d_pairs_matches_jax():
    x, pos = normal(2, 6, 3, 12, seed=7), np.linspace(0.0, 23.5, 6).astype(np.float32)
    ref = np.asarray(jax_mt.rope_1d_pairs(jnp.asarray(x), jnp.asarray(pos), 12))
    assert_close(mt.rope_1d_pairs(torch.from_numpy(x), torch.from_numpy(pos), 12), ref, rel=1e-5)


def test_audio_proj_matches_jax():
    cfg = {**_TF_CFG}
    jm = jax_build(lambda: jax_mt.AudioProjModel(jax_mt.WanMultiTalkConfig(**cfg), rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: mt.AudioProjModel(mt.WanMultiTalkConfig(**cfg)), jm)
    jmodel = jax_mt.WanMultiTalkTransformer3DModel.windowed_audio
    audio = normal(2, 5, 5, 2, 16, seed=8)
    stub = type("Stub", (), {"cfg": jax_mt.WanMultiTalkConfig(**cfg)})()
    first, latter = jmodel(stub, jnp.asarray(audio))
    ref = np.asarray(nnx.jit(lambda m, a, b: m(a, b))(jm, first, latter))
    port_stub = type("Stub", (), {"cfg": mt.WanMultiTalkConfig(**cfg)})()
    pf, pl = mt.WanMultiTalkTransformer3DModel.windowed_audio(port_stub, torch.from_numpy(audio))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(latter))
    with torch.inference_mode():
        out = pm(pf, pl)
    assert tuple(out.shape) == ref.shape == (2, 3, 4, 20)
    assert_close(out, ref)


def test_speakers_hear_their_own_audio():
    """With two speakers, swapping their audio changes the output (L-RoPE
    routes the queries by speaker)."""
    _, pm = multitalk_pair()
    x, text, img = (torch.from_numpy(a) for a in (normal(1, 10, 3, 8, 8, seed=9), normal(1, 5, 32, seed=10),
                                                    normal(1, 3, 16, seed=11)))
    audio, t = torch.from_numpy(normal(2, 5, 5, 2, 16, seed=12)), torch.tensor([500.0])
    with torch.inference_mode():
        a = pm(x, t, text, img, audio, torch.from_numpy(masks()))
        b = pm(x, t, text, img, audio.flip(0), torch.from_numpy(masks()))
    assert (a - b).abs().max() > 1e-4


def test_published_names_round_trip():
    """The ``wan_multitalk`` converter: the CLIP branch and the audio
    projection and cross-attention included."""
    jm, _ = multitalk_pair()
    assert_published_round_trip(
        "wan_multitalk", lambda: mt.WanMultiTalkTransformer3DModel(mt.WanMultiTalkConfig(**_TF_CFG),
                                                                   dtype=torch.float32), jm)


def test_default_image_key_width_fails_in_both():
    """The JAX config's default ``added_kv_proj_dim`` (1280, CLIP's width)
    meets CLIP features already projected to the DiT's width by ``img_ff2``:
    a config without it fails at the first image cross-attention in both
    packages (the published Wan2.1-I2V-14B-480P config sets 5120, the DiT's
    width). Here: image_dim 16 and added_kv_proj_dim 16 against dim 24."""
    kw = dict(image_dim=16, added_kv_proj_dim=16)
    jm, pm = multitalk_pair(**kw)
    x, text, img = normal(1, 10, 3, 8, 8, seed=13), normal(1, 5, 32, seed=14), normal(1, 3, 16, seed=15)
    audio, t = normal(1, 5, 5, 2, 16, seed=16), np.array([500.0], np.float32)
    with pytest.raises(TypeError):
        nnx.jit(lambda m, *a: m(*a))(jm, jnp.asarray(x), jnp.asarray(t), jnp.asarray(text), jnp.asarray(img),
                                     jnp.asarray(audio))
    with torch.inference_mode(), pytest.raises(RuntimeError):
        pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(text), torch.from_numpy(img),
           torch.from_numpy(audio))
