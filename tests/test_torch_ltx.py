"""The port's LTX-Video (the rectified-flow scheduler, the DiT, the causal VAE,
the x2v engine) against the JAX package, on the CPU in f32.

The scheduler's grids within 1e-12 and its steps within 1e-6; the DiT at toy
widths within 1e-4 of max|ref| with per-token timesteps over conditioned
tokens, a padded context mask, both STG skip strategies and the dim % 6 RoPE
pad; the VAE's encode and decode within 1e-5 with the decode timestep and
the injected noise (JAX's key stream drawn on the host), on the published
block layout and on one with the other block kinds; the x2v engine from the
repository manifest with every component carried from the JAX engine: t2v,
i2v, extension by ``initial_latents`` and by a ``conditions`` clip, CFG with
STG, skipped steps: latents within 1e-3 rel L2, frames within one level; the
published names round-trip.
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
from apex_studio_tpu.models.transformers import ltx as jax_ltx
from apex_studio_tpu.models.vaes import ltx_vae as jax_vae
from apex_studio_tpu.schedulers import rectified_flow as jax_rf
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine.ltx import LTXX2VEngine
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from apex_studio_tpu_torch.models.transformers import ltx as port_ltx
from apex_studio_tpu_torch.models.vaes import ltx_vae as port_vae
from apex_studio_tpu_torch.schedulers import rectified_flow as port_rf
from apex_studio_tpu_torch.utils import jax_random
from tests.test_engine_ltx import LTX_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import (assert_close, assert_published_round_trip, assert_rel_l2, fast_jax_engine,
                                      jax_build, jax_params, jitted, port_from_jax)

MANIFEST = Path(__file__).resolve().parents[1] / "manifests" / "video" / "ltx-video-x2v.yml"
TINY = {c["type"]: c["config"] for c in LTX_TINY["spec"]["components"] if c["type"] != "scheduler"}
# the published decoder injects noise in its first three res_x blocks
VAE_NOISE = dict(TINY["vae"], decoder_blocks=[["res_x", {"num_layers": 1, "inject_noise": True}],
                                              ["compress_all", {"residual": True, "multiplier": 2}],
                                              ["res_x", {"num_layers": 2, "inject_noise": True}]])
VAE_VARIANTS = {"latent_channels": 4, "base_channels": 8, "patch_size": 2, "norm_layer": "layer_norm",
                "spatial_padding_mode": "reflect", "causal_decoder": True,
                "encoder_blocks": [["res_x_y", {"multiplier": 2}], ["compress_time", {}],
                                   ["compress_space_res", {"multiplier": 2}]],
                "decoder_blocks": [["res_x", {"num_layers": 1, "inject_noise": True}], ["compress_space", {}],
                                   ["res_x_y", {"multiplier": 2}], ["compress_time", {}]]}
SCHEDULERS = {"linear_quadratic_sd3": dict(LTX_TINY["spec"]["components"][0]["config"]),
              "manifest": {"sampler": "LinearQuadratic", "shifting": "SD3", "target_shift_terminal": 0.1},
              "uniform": {}, "constant": {"sampler": "Constant", "shift": 1.3},
              "simple_diffusion": {"shifting": "SimpleDiffusion", "base_resolution": 64}}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_matches_jax(name):
    kw = SCHEDULERS[name]
    js, ps = jax_rf.RectifiedFlowScheduler(**kw), port_rf.RectifiedFlowScheduler(**kw)
    for n, extra in ((1, {}), (7, {"samples_shape": (1, 8, 3, 4, 6)}), (30, {"samples_shape": (1, 7410, 128)}),
                     (5, {"n_tokens": 4096}), (3, {"timesteps": [0.9, 0.5, 0.2]})):
        js.set_timesteps(n, **extra)
        ps.set_timesteps(n, **extra)
        np.testing.assert_allclose(ps.sigmas, js.sigmas, rtol=1e-12, atol=0)
        np.testing.assert_array_equal(ps.timesteps, js.timesteps)
    rng = np.random.default_rng(5)
    x, v = (rng.normal(size=(1, 12, 4)).astype(np.float32) for _ in range(2))
    (want,) = js.step(jnp.asarray(v), float(js.timesteps[0]), jnp.asarray(x))
    (got,) = ps.step(torch.from_numpy(v), float(ps.timesteps[0]), torch.from_numpy(x))
    assert_close(got, np.asarray(want), 1e-6)
    assert_close(ps.step_at(torch.from_numpy(v), torch.from_numpy(x), 2),
                 np.asarray(js.step_at(jnp.asarray(v), jnp.asarray(x), 2)), 1e-6)
    # per-token: hard-conditioned tokens at 0, soft ones between grid points, the rest on the grid
    t_tok = np.full((1, 12), js.timesteps[1], np.float32)
    t_tok[0, :3], t_tok[0, 3:6] = 0.0, 0.5 * (js.timesteps[1] + js.timesteps[2])
    want = js.step_tokens(jnp.asarray(v), jnp.asarray(t_tok), jnp.asarray(x))
    got = ps.step_tokens(torch.from_numpy(v), torch.from_numpy(t_tok), torch.from_numpy(x))
    assert_close(got, np.asarray(want), 1e-6)
    assert torch.equal(got[0, :3], torch.from_numpy(x)[0, :3])


def dit_pair(head_dim):
    cfg = dict(TINY["transformer"], attention_head_dim=head_dim)
    jm = jax_build(lambda: jax_ltx.LTXVideoTransformer3D(jax_ltx.LTXVideoConfig.from_dict(cfg), dtype=jnp.float32,
                                                         rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: port_ltx.LTXVideoTransformer3D(port_ltx.LTXVideoConfig.from_dict(cfg),
                                                              dtype=torch.float32), jm)
    return jm, pm


DIT_CASES = {"per_token_t_padded_ctx": (12, "tokens", None), "scalar_t_rope_pad": (10, "scalar", None),
             "stg_values": (12, "tokens", "attention_values"), "stg_skip": (12, "scalar", "attention_skip")}


@pytest.mark.parametrize("case", list(DIT_CASES))
def test_dit_matches_jax(case):
    head_dim, t_kind, strategy = DIT_CASES[case]
    jm, pm = dit_pair(head_dim)
    rng = np.random.default_rng(0)
    s = 2 * 3 * 4
    tokens = rng.normal(size=(2, s, 8)).astype(np.float32)
    ctx = rng.normal(size=(2, 6, 16)).astype(np.float32)
    mask = np.asarray([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], np.float32)
    coords = (rng.uniform(size=(2, 3, s)) * np.array([[4.0], [96.0], [128.0]])).astype(np.float32)
    t = (np.where(np.arange(s) < 12, 0.0, 0.8)[None].repeat(2, 0) if t_kind == "tokens"
         else np.full((2, 1), 0.63)).astype(np.float32)
    skips = (1,) if strategy else ()
    kw = dict(skip_blocks=skips, skip_strategy=strategy or "attention_values")
    want = jitted(jm, lambda m, *a: m(*a[:3], encoder_attention_mask=a[3], video_coords=a[4], **kw),
                  tokens, ctx, t, mask, coords)
    got = pm(*map(torch.from_numpy, (tokens, ctx, t)), encoder_attention_mask=torch.from_numpy(mask),
             video_coords=torch.from_numpy(coords), **kw)
    assert tuple(got.shape) == (2, s, 8)
    assert_close(got, want, 1e-4)
    if head_dim == 10:  # 20 % 6: the first two lanes rotate by nothing
        cos, sin = port_ltx.ltx_rope_freqs(torch.from_numpy(coords), 20, 1e4, pm.cfg.max_pos)
        jcos, jsin = jax_ltx.ltx_rope_freqs(jnp.asarray(coords), 20, 1e4, jm.cfg.max_pos)
        assert_close(cos, np.asarray(jcos), 1e-6)
        assert_close(sin, np.asarray(jsin), 1e-6)
        assert bool((cos[..., :2] == 1).all() and (sin[..., :2] == 0).all())


@pytest.fixture(scope="module", params=["noise", "variants"])
def vae_pair(request):
    cfg = VAE_NOISE if request.param == "noise" else VAE_VARIANTS
    jm = jax_build(lambda: jax_vae.AutoencoderKLLTX(jax_vae.LTXVAEConfig.from_dict(cfg), rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: port_vae.AutoencoderKLLTX(port_vae.LTXVAEConfig.from_dict(cfg)), jm)
    return jm, pm, cfg


def test_vae_encode_matches_jax(vae_pair):
    jm, pm, cfg = vae_pair
    x = np.random.default_rng(1).uniform(-1, 1, size=(1, 3, 5, 16, 24)).astype(np.float32)
    want = jitted(jm, lambda m, a: m.encode(a), x)
    got = pm.encode(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (1, cfg["latent_channels"], 3, 4, 6)
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("timestep", [0.05, None])
def test_vae_decode_matches_jax(vae_pair, timestep):
    """With the decode timestep (or the decoder's zero default) and the
    noise from JAX's key 0."""
    jm, pm, cfg = vae_pair
    z = np.random.default_rng(2).normal(size=(1, cfg["latent_channels"], 3, 4, 6)).astype(np.float32)
    t = None if timestep is None else np.asarray([timestep], np.float32)
    graphdef, state = nnx.split(jm)
    want = np.asarray(jax.jit(lambda s, a, tt: nnx.merge(graphdef, s).decode(
        a, timestep=tt, noise_key=jax.random.key(0)))(state, jnp.asarray(z), t))
    got = pm.decode(torch.from_numpy(z), timestep=None if t is None else torch.from_numpy(t),
                    noise_key=jax_random.key(0))
    assert tuple(got.shape) == want.shape == (1, 3, 5, 16, 24)
    assert_close(got, want, 1e-5)
    quiet = pm.decode(torch.from_numpy(z), timestep=None if t is None else torch.from_numpy(t))
    assert float((quiet - got).abs().max()) > 1e-4  # the noise is injected


def test_jax_random_stream_matches_jax():
    """The keys bit for bit; the normals within 1e-5 (XLA's f32 erfinv is a
    polynomial, the port's an f64 erfinv rounded to f32)."""
    key, jkey = jax_random.key(0), jax.random.key(0)
    for d in (3, 0, 1):
        key, jkey = jax_random.fold_in(key, d), jax.random.fold_in(jkey, d)
        np.testing.assert_array_equal(key, np.asarray(jax.random.key_data(jkey)))
    want = np.asarray(jax.random.normal(jkey, (13, 21), jnp.float32))
    assert_close(jax_random.normal(key, (13, 21)), want, 1e-5)


def manifest(tmp_path):
    """The repository manifest with toy components in fp32 and no weight
    files; its VAE injects noise."""
    doc = yaml.safe_load(MANIFEST.read_text())
    configs = dict(TINY, vae=VAE_NOISE)
    for comp in doc["spec"]["components"]:
        if comp["type"] == "scheduler":
            continue
        for key in ("config_path", "model_path"):
            comp.pop(key, None)
        comp["precision"] = "fp32"
        comp["config"] = copy.deepcopy(configs[comp["type"]])
    path = tmp_path / "ltx.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine) over the same carried weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        root = tmp_path_factory.mktemp("ltx")
        path = manifest(root)
        pair = {}
        for side in ("jax", "port"):
            mp.setenv("APEX_HOME_DIR", str(root / f"home_{side}"))
            eng = (fast_jax_engine(JaxUniversalEngine(path, model_type="x2v")) if side == "jax"
                   else UniversalEngine(path, model_type="x2v", device="cpu"))
            eng._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
            for ctype in ("text_encoder", "vae", "transformer", "scheduler"):
                eng.load_component_by_type(ctype)
            pair[side] = eng
        jax_eng, port_eng = pair["jax"], pair["port"]
        load_from_jax(port_eng.text_encoder._ensure_model(), jax_params(jax_eng.text_encoder._ensure_model()))
        for name in ("transformer", "vae"):
            load_from_jax(getattr(port_eng, name), jax_params(getattr(jax_eng, name)))
        yield jax_eng, port_eng, root, mp


RNG = np.random.default_rng(0)
IMAGE = RNG.integers(0, 256, size=(40, 36, 3), dtype=np.uint8)
CLIP = RNG.integers(0, 256, size=(3, 32, 32, 3), dtype=np.uint8)
BASE = dict(prompt="hello world", height=32, width=48, num_frames=9, fps=24, num_inference_steps=3, seed=3,
            guidance_scale=3.0, return_latents=True)
REQUESTS = {
    "t2v_cfg": dict(BASE),
    "t2v_negative_prompt_cfg_star": dict(BASE, negative_prompt="a cat", cfg_star_rescale=True),
    "i2v": dict(BASE, image=IMAGE, image_cond_noise_scale=0.15),
    "extension_initial_latents": dict(BASE, initial_latents=np.random.default_rng(7).normal(
        size=(1, 8, 5, 8, 12)).astype(np.float32), skip_initial_inference_steps=1),
    "extension_conditions": dict(BASE, conditions=[{"video": CLIP, "frame_number": 0, "strength": 0.6}],
                                 skip_final_inference_steps=1),
    "stg": dict(BASE, image=IMAGE, stg_scale=1.0, skip_block_list=[1], rescaling_scale=0.7),
    "no_cfg": dict(BASE, guidance_scale=1.0),
}


def run_pair(engines, kw):
    jax_eng, port_eng, root, mp = engines
    mp.setenv("APEX_HOME_DIR", str(root / "home_jax"))
    want = jax_eng.run(**kw)
    mp.setenv("APEX_HOME_DIR", str(root / "home_port"))
    return port_eng.run(**kw), want


@pytest.mark.parametrize("case", list(REQUESTS))
def test_latents_match_jax(engines, case):
    got, want = run_pair(engines, REQUESTS[case])
    assert type(engines[1]) is LTXX2VEngine
    assert tuple(got.shape) == np.asarray(want).shape == (1, 8, 5, 8, 12)
    assert_rel_l2(got, np.asarray(want), 1e-3)


def test_frames_match_jax_and_the_seed_repeats(engines):
    """The manifest's decode timestep and noise scale with a tone map."""
    kw = dict(REQUESTS["i2v"], return_latents=False, decode_timestep=0.05, decode_noise_scale=0.025,
              tone_map_compression_ratio=0.6)
    got, want = run_pair(engines, kw)
    got, want = np.stack(got).astype(np.int16), np.stack(want).astype(np.int16)
    assert got.shape == want.shape == (9, 32, 48, 3)
    assert int(np.abs(got - want).max()) <= 1
    port = engines[1]
    again = port.run(**REQUESTS["t2v_cfg"])
    assert torch.equal(again, port.run(**REQUESTS["t2v_cfg"]))
    assert not torch.equal(again, port.run(**dict(REQUESTS["t2v_cfg"], seed=4)))


def test_a_later_frame_condition_raises_as_in_jax(engines):
    kw = dict(BASE, conditions=[{"image": IMAGE, "frame_number": 8}])
    for eng in engines[:2]:
        with pytest.raises(NotImplementedError, match="non-first-frame"):
            eng.run(**kw)


def test_published_names_round_trip():
    jm, _ = dit_pair(12)
    assert_published_round_trip(
        "ltx", lambda: port_ltx.LTXVideoTransformer3D(port_ltx.LTXVideoConfig.from_dict(
            dict(TINY["transformer"], attention_head_dim=12)), dtype=torch.float32), jm)
    # the published block layout (neither package's converter names a plain strided encoder conv)
    jv = jax_build(lambda: jax_vae.AutoencoderKLLTX(jax_vae.LTXVAEConfig.from_dict(VAE_NOISE), rngs=nnx.Rngs(0)))
    assert_published_round_trip(
        "ltx_vae", lambda: port_vae.AutoencoderKLLTX(port_vae.LTXVAEConfig.from_dict(VAE_NOISE)), jv)


def test_manifest_resolves_in_the_port():
    from apex_studio_tpu_torch.engine.registry import resolve_engine_class
    from apex_studio_tpu_torch.models.registry import _load_builtin_families, transformer_registry, vae_registry
    from apex_studio_tpu_torch.schedulers import scheduler_registry

    doc = yaml.safe_load(MANIFEST.read_text())["spec"]
    assert resolve_engine_class(doc["engine"], doc["model_type"]) is LTXX2VEngine
    _load_builtin_families()
    bases = {c["type"]: c["base"] for c in doc["components"]}
    assert transformer_registry.get(bases["transformer"]) is port_ltx.LTXVideoTransformer3D
    assert vae_registry.get(bases["vae"]) is port_vae.AutoencoderKLLTX
    assert scheduler_registry.get(bases["scheduler"]) is port_rf.RectifiedFlowScheduler
