"""The port's CogVideoX (the DiT, the causal VAE, the DDIM scheduler and the five
engine types) against the JAX package, on the CPU in f32.

The DiT at toy widths within 1e-5 rel L2, with and without RoPE and with a
32-channel input; the VAE within 1e-4 of max|ref| at odd, even and single
latent frames, and every chunked branch (convs, upsample, group norm,
spatial norm) forced against the whole decode and encode; the DDIM schedule
and step within 1e-6; the inpainting mask's antialiased trilinear resize
within 1e-6 of ``jax.image.resize``; the five engine types from the
repository manifests (control and inp on twins of the t2v one) with every
component carried from the JAX engine, 2 steps with CFG: latents within
1e-3. The published names round-trip, and the conditioning a DiT cannot
take raises before it runs.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu.models.transformers import cogvideox as jax_cog
from apex_studio_tpu.models.vaes import cogvideox_vae as jax_vae
from apex_studio_tpu.schedulers import ddim as jax_ddim
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine import cogvideox as port_engine
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from apex_studio_tpu_torch.models.transformers import cogvideox as port_cog
from apex_studio_tpu_torch.models.vaes import cogvideox_vae as port_vae
from apex_studio_tpu_torch.schedulers import ddim as port_ddim
from tests.test_engine_cogvideox import COG_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import (assert_close, assert_published_round_trip, assert_rel_l2, fast_jax_engine,
                                      jax_build, jax_params, jitted, port_from_jax)

REPO = Path(__file__).resolve().parents[1]
VIDEO = REPO / "manifests" / "video"
TINY = {c["type"]: c["config"] for c in COG_TINY["spec"]["components"] if c["type"] != "scheduler"}
DIT_CASES = {"rope": {}, "no_rope": {"use_rotary_positional_embeddings": False},
             "in_channels_32": {"in_channels": 32, "out_channels": 16}}
VAE = {"latent_channels": 4, "block_out_channels": [8, 16, 16], "layers_per_block": 1, "norm_num_groups": 4,
       "temporal_compression_ratio": 4}


def dit_pair(overrides):
    cfg = dict(TINY["transformer"], **overrides)
    jm = jax_build(lambda: jax_cog.CogVideoXTransformer3DModel(jax_cog.CogVideoXConfig.from_dict(cfg),
                                                               dtype=jnp.float32, param_dtype=jnp.float32,
                                                               rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: port_cog.CogVideoXTransformer3DModel(port_cog.CogVideoXConfig.from_dict(cfg),
                                                                    dtype=torch.float32), jm)
    return jm, pm


@pytest.mark.parametrize("case", list(DIT_CASES))
def test_dit_matches_jax(case):
    jm, pm = dit_pair(DIT_CASES[case])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, pm.cfg.in_channels, 3, 8, 12)).astype(np.float32)
    t = np.asarray([617.0], np.float32)
    txt = rng.normal(size=(1, 7, 32)).astype(np.float32)
    want = jitted(jm, lambda m, *a: m(*a), x, t, txt)
    got = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(txt))
    assert tuple(got.shape) == (1, pm.cfg.out_channels, 3, 8, 12)
    assert_rel_l2(got, want, 1e-5)


def test_i2v_config_drops_the_learned_positional_embedding():
    """The published CogVideoX-5b-I2V transformer config sets
    ``use_learned_positional_embeddings``; neither config class has the
    field, so both drop it and build no positional embedding."""
    published = {"in_channels": 32, "use_learned_positional_embeddings": True, "num_layers": 1}
    want = jax_cog.CogVideoXConfig.from_dict(published)
    got = port_cog.CogVideoXConfig.from_dict(published)
    assert not hasattr(got, "use_learned_positional_embeddings") and not hasattr(want,
                                                                                 "use_learned_positional_embeddings")
    assert got.in_channels == want.in_channels == 32


@pytest.fixture(scope="module")
def vae_pair():
    jm = jax_build(lambda: jax_vae.AutoencoderKLCogVideoX(jax_vae.CogVideoXVAEConfig.from_dict(VAE),
                                                          dtype=jnp.float32, rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: port_vae.AutoencoderKLCogVideoX(port_vae.CogVideoXVAEConfig.from_dict(VAE),
                                                               dtype=torch.float32), jm)
    return jm, pm


@pytest.mark.parametrize("frames", [9, 1])
def test_vae_encode_matches_jax(vae_pair, frames):
    jm, pm = vae_pair
    x = np.random.default_rng(1).uniform(-1, 1, size=(1, 3, frames, 16, 24)).astype(np.float32)
    want = jitted(jm, lambda m, a: m.encode(a), x)
    got = pm.encode(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (1, 4, (frames - 1) // 4 + 1, 4, 6)
    assert_close(got, want, 1e-4)


@pytest.mark.parametrize("latent_t, frames", [(3, 9), (2, 8), (1, 1)])
def test_vae_decode_matches_jax(vae_pair, latent_t, frames):
    jm, pm = vae_pair
    z = np.random.default_rng(2).normal(size=(1, 4, latent_t, 4, 6)).astype(np.float32)
    want = jitted(jm, lambda m, a: m.decode(a), z)
    got = pm.decode(torch.from_numpy(z))
    assert tuple(got.shape) == want.shape == (1, 3, frames, 16, 24)
    assert_close(got, want, 1e-4)


@pytest.mark.parametrize("branch", ["conv", "norm", "both"])
def test_vae_chunked_branches_match_the_whole(vae_pair, monkeypatch, branch):
    """Past the element limits each conv, upsample, group norm and spatial
    norm runs in frame chunks; the decode and the encode stay the whole
    one's (the limits set so that every such call is chunked)."""
    _, pm = vae_pair
    rng = np.random.default_rng(4)
    z = torch.from_numpy(rng.normal(size=(1, 4, 3, 4, 6)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, size=(1, 3, 9, 16, 24)).astype(np.float32))
    whole_dec, whole_enc = pm.decode(z), pm.encode(x)
    calls = {"conv3d": 0, "conv2d": 0, "norm": 0, "spatial": 0}
    real = {"conv3d": port_vae.F.conv3d, "stats": port_vae.GroupNormCh.stats}

    def conv3d(inp, *a, **k):
        calls["conv3d"] += 1
        return real["conv3d"](inp, *a, **k)

    def stats(self, inp):
        calls["norm"] += 1
        return real["stats"](self, inp)

    monkeypatch.setattr(port_vae.F, "conv3d", conv3d)
    monkeypatch.setattr(port_vae.GroupNormCh, "stats", stats)
    if branch in ("conv", "both"):
        monkeypatch.setattr(port_vae, "CONV_CHUNK_ELEMENTS", 2000)
    if branch in ("norm", "both"):
        monkeypatch.setattr(port_vae, "NORM_CHUNK_ELEMENTS", 1000)
    assert_close(pm.decode(z), whole_dec.numpy(), 1e-5)
    assert_close(pm.encode(x), whole_enc.numpy(), 1e-5)
    assert (calls["norm"] > 0) == (branch != "conv")
    if branch == "conv":
        assert calls["conv3d"] > 300  # many more calls than the whole path's


def test_ddim_matches_jax():
    for kw in ({}, {"rescale_betas_zero_snr": False, "beta_schedule": "linear"}, {"timestep_spacing": "leading"},
               {"timestep_spacing": "linspace", "prediction_type": "epsilon", "rescale_betas_zero_snr": False}):
        jsched, psched = jax_ddim.CogVideoXDDIMScheduler(**kw), port_ddim.CogVideoXDDIMScheduler(**kw)
        np.testing.assert_allclose(psched.alphas_cumprod, jsched.alphas_cumprod, rtol=1e-12, atol=0)
        for n in (2, 7, 50):
            jsched.set_timesteps(n)
            psched.set_timesteps(n)
            np.testing.assert_array_equal(psched.timesteps, jsched.timesteps)
            np.testing.assert_allclose(psched.sigmas, jsched.sigmas, rtol=1e-12)
        rng = np.random.default_rng(5)
        x = rng.normal(size=(1, 4, 2, 3, 3)).astype(np.float32)
        v = rng.normal(size=x.shape).astype(np.float32)
        for t in psched.timesteps[[0, 3, -1]]:
            (want,) = jsched.step(jnp.asarray(v), float(t), jnp.asarray(x))
            (got,) = psched.step(torch.from_numpy(v), float(t), torch.from_numpy(x))
            assert_close(got, np.asarray(want), 1e-6)
            want = jsched.add_noise(jnp.asarray(x), jnp.asarray(v), float(t))
            assert_close(psched.add_noise(torch.from_numpy(x), torch.from_numpy(v), float(t)), np.asarray(want), 1e-6)


@pytest.mark.parametrize("shape, grid", [((9, 40, 56), (3, 5, 7)), ((5, 33, 17), (2, 4, 3)), ((1, 32, 32), (1, 4, 4)),
                                         ((17, 480, 720), (5, 60, 90))])
def test_inpaint_mask_resize_matches_jax(shape, grid):
    """The inverted mask on the latent grid: frame 0 apart, the rest resized
    in time too, antialiased as ``jax.image.resize(..., "trilinear")``."""
    rng = np.random.default_rng(6)
    mask = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    lat_t, lat_h, lat_w = grid
    inv = jnp.asarray((1.0 - mask)[None, None])
    first = jax.image.resize(inv[:, :, :1], (1, 1, 1, lat_h, lat_w), "trilinear")
    if lat_t > 1:
        want = jnp.concatenate([first, jax.image.resize(inv[:, :, 1:], (1, 1, lat_t - 1, lat_h, lat_w),
                                                        "trilinear")], axis=2)
    else:
        want = jnp.broadcast_to(first, (1, 1, lat_t, lat_h, lat_w))
    got = port_engine.mask_latents(mask, lat_t, lat_h, lat_w)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_published_names_round_trip(vae_pair):
    jm, _ = dit_pair({})
    assert_published_round_trip(
        "cogvideo",
        lambda: port_cog.CogVideoXTransformer3DModel(port_cog.CogVideoXConfig.from_dict(TINY["transformer"]),
                                                     dtype=torch.float32), jm)
    assert_published_round_trip(
        "cogvideo_vae",
        lambda: port_vae.AutoencoderKLCogVideoX(port_vae.CogVideoXVAEConfig.from_dict(VAE), dtype=torch.float32),
        vae_pair[0])


# model type → (manifest, the DiT's in_channels)
TYPES = {"t2v": ("cogvideox-5b-text-to-video.yml", 4), "i2v": ("cogvideox-5b-image-to-video.yml", 8),
         "v2v": ("cogvideox-5b-video-to-video.yml", 4), "control": ("cogvideox-5b-text-to-video.yml", 8),
         "inp": ("cogvideox-5b-text-to-video.yml", 9)}
ENGINE_CLASSES = {"t2v": port_engine.CogVideoXT2VEngine, "i2v": port_engine.CogVideoXI2VEngine,
                  "v2v": port_engine.CogVideoXV2VEngine, "control": port_engine.CogVideoXControlEngine,
                  "inp": port_engine.CogVideoXInpEngine}
RNG = np.random.default_rng(0)
IMAGE = RNG.integers(0, 256, size=(40, 36, 3), dtype=np.uint8)
CLIP = [RNG.integers(0, 256, size=(32, 32, 3), dtype=np.uint8) for _ in range(9)]
MASK = [np.where(RNG.uniform(size=(32, 32)) > 0.4, 255, 0).astype(np.uint8) for _ in range(7)]
BASE = dict(prompt="hello world", negative_prompt="a cat", height=32, width=32, num_inference_steps=2,
            guidance_scale=6.0, seed=3, return_latents=True)
REQUESTS = {
    "t2v": dict(BASE, num_frames=9, use_dynamic_cfg=True),
    "i2v": dict(BASE, image=IMAGE, num_frames=9),
    "v2v": dict(BASE, video=CLIP, strength=0.8, num_inference_steps=3),
    "control": dict(BASE, control_video=CLIP, num_frames=9),
    "inp": dict(BASE, video=CLIP, mask_video=MASK, num_frames=9, use_dynamic_cfg=True),
}


def manifest(tmp_path, model_type):
    """The model type's repository manifest (control and inp: a twin of the
    t2v one) with toy components in fp32 and no weight files."""
    name, in_channels = TYPES[model_type]
    doc = yaml.safe_load((VIDEO / name).read_text())
    doc["spec"]["model_type"] = model_type
    for comp in doc["spec"]["components"]:
        if comp["type"] == "scheduler":
            continue
        for key in ("config_path", "model_path"):
            comp.pop(key, None)
        comp["precision"] = "fp32"
        comp["config"] = copy.deepcopy(dict(TINY[comp["type"]], **(
            {"in_channels": in_channels} if comp["type"] == "transformer" else {})))
    path = tmp_path / f"{model_type}.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """model type → (JAX engine, port engine) over the same carried weights;
    the text encoder and the VAE shared across types, the JAX jit cache too."""
    made, shared = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        root = tmp_path_factory.mktemp("cogvideox")

        def get(model_type):
            if model_type in made:
                return made[model_type]
            path = manifest(root, model_type)
            pair = {}
            for side in ("jax", "port"):
                mp.setenv("APEX_HOME_DIR", str(root / f"home_{side}"))
                eng = (fast_jax_engine(JaxUniversalEngine(path, model_type=model_type)) if side == "jax"
                       else UniversalEngine(path, model_type=model_type, device="cpu"))
                eng._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
                for name in ("text_encoder", "vae"):
                    if (side, name) in shared:
                        setattr(eng, name, shared[side, name])
                if side == "jax" and "jit" in shared:
                    eng._jit_cache = shared["jit"]
                eng.load_components()
                for name in ("text_encoder", "vae"):
                    shared.setdefault((side, name), getattr(eng, name))
                shared.setdefault("jit", eng._jit_cache) if side == "jax" else None
                pair[side] = eng
            jax_eng, port_eng = pair["jax"], pair["port"]
            if ("port", "carried") not in shared:
                load_from_jax(port_eng.text_encoder._ensure_model(), jax_params(jax_eng.text_encoder._ensure_model()))
                load_from_jax(port_eng.vae, jax_params(jax_eng.vae))
                shared["port", "carried"] = True
            load_from_jax(port_eng.transformer, jax_params(jax_eng.transformer))
            made[model_type] = (jax_eng, port_eng, root, mp)
            return made[model_type]

        yield get


@pytest.mark.parametrize("model_type", list(TYPES))
def test_latents_match_jax(engines, model_type):
    jax_eng, port_eng, root, mp = engines(model_type)
    assert type(port_eng) is ENGINE_CLASSES[model_type]
    kw = REQUESTS[model_type]
    mp.setenv("APEX_HOME_DIR", str(root / "home_jax"))
    want = np.asarray(jax_eng.run(**kw))
    mp.setenv("APEX_HOME_DIR", str(root / "home_port"))
    got = port_eng.run(**kw)
    assert tuple(got.shape) == want.shape == (1, 4, 5, 16, 16)
    assert_rel_l2(got, want, 1e-3)


def test_frames_and_raises_before_the_dit(engines):
    """A t2v request decodes to 9 frames of 32 × 32; a conditioning the DiT's
    channels cannot take raises before the DiT runs (JAX fails in it or in
    the step after it)."""
    _, t2v, root, mp = engines("t2v")
    mp.setenv("APEX_HOME_DIR", str(root / "home_port"))
    frames = t2v.run(**dict(REQUESTS["t2v"], return_latents=False, guidance_scale=1.0))
    assert len(frames) == 9 and frames[0].shape == (32, 32, 3) and frames[0].dtype == np.uint8
    calls = []
    hook = t2v.transformer.register_forward_pre_hook(lambda *a: calls.append(1))
    try:
        for model_type in ("i2v", "control", "inp"):
            narrow = UniversalEngine(manifest(root, model_type), model_type=model_type, device="cpu")
            for name in ("text_encoder", "transformer", "vae", "scheduler"):
                setattr(narrow, name, getattr(t2v, name))
            with pytest.raises(ValueError, match="do not make the DiT's in_channels 4"):
                narrow.run(**REQUESTS[model_type])
    finally:
        hook.remove()
    assert not calls


def test_manifests_resolve_to_the_ported_engines():
    from apex_studio_tpu_torch.engine.registry import resolve_engine_class

    for model_type, (name, _) in TYPES.items():
        doc = yaml.safe_load((VIDEO / name).read_text())
        assert resolve_engine_class(doc["spec"]["engine"], model_type) is ENGINE_CLASSES[model_type]
