"""The port's Mochi-1 (the AsymmDiT, its VAE, the t2v engine) against the JAX
package, on the CPU in f32.

The DiT at toy widths within 1e-4 of max|ref|, with a full and a padded text
mask; the pooler masks the padded text rows and the joint attention does not
(both packages); the VAE's decode and encode within 1e-5, at several frame
counts, and its frame-chunked convs, norms and Linears against the whole
ones; the linear-quadratic grid within 1e-12; the t2v engine from the
repository manifest with every component carried from the JAX engine, with
and without CFG: latents within 1e-3 rel L2, frames within one level; the
published names round-trip.
"""

import copy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu.models.transformers import mochi as jax_mochi
from apex_studio_tpu.models.vaes import mochi_vae as jax_vae
from apex_studio_tpu.schedulers import rectified_flow as jax_rf
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine.mochi import MochiT2VEngine
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from apex_studio_tpu_torch.models.transformers import mochi as port_mochi
from apex_studio_tpu_torch.models.vaes import mochi_vae as port_vae
from apex_studio_tpu_torch.schedulers import rectified_flow as port_rf
from tests.test_engine_mochi import MOCHI_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import (assert_close, assert_published_round_trip, assert_rel_l2, fast_jax_engine,
                                      jax_build, jax_params, jitted, port_from_jax)

MANIFEST = Path(__file__).resolve().parents[1] / "manifests" / "video" / "mochi-1-text-to-video.yml"
TINY = {c["type"]: c["config"] for c in MOCHI_TINY["spec"]["components"] if c["type"] != "scheduler"}
MASKS = {"full": [1] * 7, "padded": [1, 1, 1, 1, 0, 0, 0]}


@pytest.fixture(scope="module")
def dit_pair():
    cfg = TINY["transformer"]
    jm = jax_build(lambda: jax_mochi.MochiTransformer3DModel(jax_mochi.MochiConfig.from_dict(cfg), dtype=jnp.float32,
                                                             param_dtype=jnp.float32, rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: port_mochi.MochiTransformer3DModel(port_mochi.MochiConfig.from_dict(cfg),
                                                                  dtype=torch.float32), jm)
    return jm, pm


def dit_inputs(mask):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 4, 3, 8, 12)).astype(np.float32)
    t = np.asarray([617.0], np.float32)
    txt = rng.normal(size=(1, 7, 32)).astype(np.float32)
    return x, t, txt, np.asarray([MASKS[mask]], np.float32)


@pytest.mark.parametrize("mask", list(MASKS))
def test_dit_matches_jax(dit_pair, mask):
    jm, pm = dit_pair
    x, t, txt, m = dit_inputs(mask)
    want = jitted(jm, lambda mod, *a: mod(*a[:3], encoder_attention_mask=a[3]), x, t, txt, m)
    got = pm(*map(torch.from_numpy, (x, t, txt)), encoder_attention_mask=torch.from_numpy(m))
    assert tuple(got.shape) == (1, 4, 3, 8, 12)
    assert_close(got, want, 1e-4)


def test_padded_text_rows_reach_the_joint_attention_not_the_pooler(dit_pair):
    """JAX attends the padded text keys in the joint launch (no mask there)
    and masks them in the pooler; the port does the same: new values in the
    padded rows leave the pooled vector as it was and move the output."""
    jm, pm = dit_pair
    x, t, txt, m = dit_inputs("padded")
    other = txt.copy()
    other[:, 4:] = 3.0
    for a in (txt, other):
        got = pm.pooler(torch.from_numpy(a), torch.from_numpy(m))
        assert_close(got, jitted(jm, lambda mod, u, v: mod.pooler(u, v), a, m), 1e-4)
    pooled = [pm.pooler(torch.from_numpy(a), torch.from_numpy(m)) for a in (txt, other)]
    assert torch.equal(pooled[0], pooled[1])
    outs = [pm(*map(torch.from_numpy, (x, t, a)), encoder_attention_mask=torch.from_numpy(m)) for a in (txt, other)]
    jax_outs = [jitted(jm, lambda mod, *b: mod(*b[:3], encoder_attention_mask=b[3]), x, t, a, m) for a in (txt, other)]
    assert float((outs[0] - outs[1]).abs().max()) > 1e-3
    assert float(np.abs(jax_outs[0] - jax_outs[1]).max()) > 1e-3
    assert_close(outs[1], jax_outs[1], 1e-4)


@pytest.fixture(scope="module")
def vae_pair():
    cfg = TINY["vae"]
    jm = jax_build(lambda: jax_vae.AutoencoderKLMochi(jax_vae.MochiVAEConfig.from_dict(cfg), rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: port_vae.AutoencoderKLMochi(port_vae.MochiVAEConfig.from_dict(cfg)), jm)
    return jm, pm


@pytest.mark.parametrize("latent_t, frames", [(3, 5), (1, 1)])
def test_vae_decode_matches_jax(vae_pair, latent_t, frames):
    jm, pm = vae_pair
    z = np.random.default_rng(2).normal(size=(1, 4, latent_t, 4, 6)).astype(np.float32)
    want = jitted(jm, lambda m, a: m.decode(a), z)
    got = pm.decode(torch.from_numpy(z))
    assert tuple(got.shape) == want.shape == (1, 3, frames, 16, 24)
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("frames, latent_t", [(5, 3), (1, 1)])
def test_vae_encode_matches_jax(vae_pair, frames, latent_t):
    """The encoder with the causal time attention (T > 1) and its to_v /
    to_out short cut (T == 1)."""
    jm, pm = vae_pair
    x = np.random.default_rng(1).uniform(-1, 1, size=(1, 3, frames, 16, 24)).astype(np.float32)
    want = jitted(jm, lambda m, a: m.encode(a), x)
    got = pm.encode(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (1, 4, latent_t, 4, 6)
    assert_close(got, want, 1e-5)


def test_vae_frame_chunks_match_the_whole(vae_pair, monkeypatch):
    """Below the chunk limit every conv (in place too), norm, channel Linear
    and up-block projection runs frame by frame; decode and encode are the
    whole one's."""
    _, pm = vae_pair
    rng = np.random.default_rng(4)
    z = torch.from_numpy(rng.normal(size=(1, 4, 3, 4, 6)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, size=(1, 3, 5, 16, 24)).astype(np.float32))
    whole_dec, whole_enc = pm.decode(z), pm.encode(x)
    calls = []
    conv3d = port_vae.F.conv3d
    monkeypatch.setattr(port_vae.F, "conv3d", lambda *a, **k: calls.append(a[0].shape[2]) or conv3d(*a, **k))
    monkeypatch.setattr(port_vae, "CHUNK_ELEMENTS", 1)
    assert_close(pm.decode(z), whole_dec.numpy(), 1e-6)
    assert_close(pm.encode(x), whole_enc.numpy(), 1e-6)
    assert max(calls) <= 3  # a 3-tap causal conv reads 3 frames for one output frame


def test_linear_quadratic_grid_matches_jax():
    for n, noise, ls in ((1, 0.025, None), (2, 0.025, None), (7, 0.025, None), (64, 0.025, None), (30, 0.1, 9)):
        want = jax_rf.linear_quadratic_schedule(n, noise, ls)
        got = port_rf.linear_quadratic_schedule(n, noise, ls)
        assert len(got) == n  # n entries, no trailing 0
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def manifest(tmp_path):
    """The repository manifest with toy components in fp32 and no weight files."""
    doc = yaml.safe_load(MANIFEST.read_text())
    for comp in doc["spec"]["components"]:
        if comp["type"] == "scheduler":
            continue
        for key in ("config_path", "model_path"):
            comp.pop(key, None)
        comp["precision"] = "fp32"
        comp["config"] = copy.deepcopy(TINY[comp["type"]])
    path = tmp_path / "mochi.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine) over the same carried weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        root = tmp_path_factory.mktemp("mochi")
        path = manifest(root)
        pair = {}
        for side in ("jax", "port"):
            mp.setenv("APEX_HOME_DIR", str(root / f"home_{side}"))
            eng = (fast_jax_engine(JaxUniversalEngine(path, model_type="t2v")) if side == "jax"
                   else UniversalEngine(path, model_type="t2v", device="cpu"))
            eng._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
            eng.load_components()
            pair[side] = eng
        jax_eng, port_eng = pair["jax"], pair["port"]
        load_from_jax(port_eng.text_encoder._ensure_model(), jax_params(jax_eng.text_encoder._ensure_model()))
        for name in ("transformer", "vae"):
            load_from_jax(getattr(port_eng, name), jax_params(getattr(jax_eng, name)))
        yield jax_eng, port_eng, root, mp


REQUEST = dict(prompt="hello world", negative_prompt="a cat", height=32, width=48, num_frames=5,
               num_inference_steps=3, seed=3, return_latents=True)


@pytest.mark.parametrize("guidance_scale", [4.5, 1.0])
def test_latents_match_jax(engines, guidance_scale):
    jax_eng, port_eng, root, mp = engines
    assert type(port_eng) is MochiT2VEngine
    kw = dict(REQUEST, guidance_scale=guidance_scale)
    mp.setenv("APEX_HOME_DIR", str(root / "home_jax"))
    want = np.asarray(jax_eng.run(**kw))
    mp.setenv("APEX_HOME_DIR", str(root / "home_port"))
    got = port_eng.run(**kw)
    assert tuple(got.shape) == want.shape == (1, 4, 3, 8, 12)
    assert_rel_l2(got, want, 1e-3)
    np.testing.assert_array_equal(port_eng.scheduler.sigmas, jax_eng.scheduler.sigmas)


def test_frames_match_jax_and_the_seed_repeats(engines):
    jax_eng, port_eng, root, mp = engines
    kw = dict(REQUEST, guidance_scale=4.5, return_latents=False)
    mp.setenv("APEX_HOME_DIR", str(root / "home_jax"))
    want = np.stack(jax_eng.run(**kw)).astype(np.int16)
    mp.setenv("APEX_HOME_DIR", str(root / "home_port"))
    got = np.stack(port_eng.run(**kw)).astype(np.int16)
    assert got.shape == want.shape == (5, 32, 48, 3)
    assert int(np.abs(got - want).max()) <= 1
    again = port_eng.run(**dict(kw, return_latents=True))
    assert torch.equal(again, port_eng.run(**dict(kw, return_latents=True)))
    assert not torch.equal(again, port_eng.run(**dict(kw, return_latents=True, seed=4)))


def test_published_names_round_trip(dit_pair, vae_pair):
    assert_published_round_trip(
        "mochi", lambda: port_mochi.MochiTransformer3DModel(port_mochi.MochiConfig.from_dict(TINY["transformer"]),
                                                            dtype=torch.float32), dit_pair[0])
    assert_published_round_trip(
        "mochi_vae", lambda: port_vae.AutoencoderKLMochi(port_vae.MochiVAEConfig.from_dict(TINY["vae"])),
        vae_pair[0])


def test_manifest_resolves_in_the_port():
    from apex_studio_tpu_torch.engine.registry import resolve_engine_class
    from apex_studio_tpu_torch.models.registry import _load_builtin_families, transformer_registry, vae_registry
    from apex_studio_tpu_torch.schedulers import scheduler_registry

    doc = yaml.safe_load(MANIFEST.read_text())["spec"]
    assert resolve_engine_class(doc["engine"], doc["model_type"]) is MochiT2VEngine
    _load_builtin_families()
    bases = {c["type"]: c["base"] for c in doc["components"]}
    assert transformer_registry.get(bases["transformer"]) is port_mochi.MochiTransformer3DModel
    assert vae_registry.get(bases["vae"]) is port_vae.AutoencoderKLMochi
    assert scheduler_registry.get(bases["scheduler"]) is not None


@pytest.mark.parametrize("d, masked", [(512, True), (192, False)])
def test_one_query_wide_head_route_is_the_plain_attention(d, masked):
    """One query a head past the kernel's head dims (the pooler's 8 of 512)
    goes through ``attention`` as the kernel's key bias over zero q / k; on
    the CPU that route is the plain attention within f32 rounding."""
    from apex_studio_tpu_torch.ops.attention import attention, naive_attention

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 3, d, generator=g)
    k, v = (torch.randn(2, 33, 3, d, generator=g) for _ in range(2))
    bias = torch.zeros(2, 1, 1, 33)
    if masked:
        bias[0, ..., 20:] = -1e9
    got = attention(q, k, v, bias=bias)
    assert_close(got, naive_attention(q, k, v, bias=bias).numpy(), 1e-6)
