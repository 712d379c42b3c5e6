"""The port's FlashVSR 1.1 (the streaming DiT with its rolling K/V cache, the
LQ projector, the ``tiny_wan`` TCDecoder with its LQ condition, the
converters, the upscale engine) against the JAX package, on the CPU in f32.

The DiT over three streaming chunks (6 latent frames, then 2 and 2 against
the cache, trimmed to ``kv_len``·2 frames from the second on): each chunk's
prediction and every block's cache within 1e-4 of max|ref|; ``FVLQProj``
within 1e-4; the TCDecoder's decode with ``cond`` (its head padded to a
multiple of 4) within 1e-4, its encode raising on both sides; the
``wan_flashvsr`` and ``tiny_wan_vae`` converters through a file that
``loaders/export.py`` writes; the full and tiny manifests through the engine
at 41 frames of 32 x 32 (three chunks), x4: latents within 1e-4, frames within
one level.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu.models.transformers import flashvsr as jax_fv
from apex_studio_tpu.models.vaes import tae_vae as jax_tae
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine.flashvsr import FlashVSRUpscaleEngine, largest_8n1_leq
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from apex_studio_tpu_torch.models.transformers import flashvsr as port_fv
from apex_studio_tpu_torch.models.vaes import tae_vae as port_tae
from tests.test_engine_flashvsr import TINY_CFG
from tests.test_torch_magi import file_round_trip
from tests.test_torch_wan_vae import QWEN
from tests.torch_port_helpers import assert_close, fast_jax_engine, jax_build, jax_params, port_from_jax

MANIFESTS = {kind: Path(__file__).resolve().parents[1] / "manifests" / "upscalers" / f"flashvsr-1.1-{kind}.yml"
             for kind in ("full", "tiny")}
TINY_WAN = {"z_dim": 4 + 3 * 4 * 64, "channels": [8, 8, 8, 8]}
# three chunks: 6 latent frames from 0, then 2 from 6 and 2 from 8, 2 x 2 tokens a frame
CHUNKS = ((0, 6, 0), (6, 8, 6), (8, 10, 8))


@pytest.fixture(scope="module")
def dit_pair():
    cfg = jax_fv.FlashVSRConfig(**TINY_CFG)
    jm = jax_build(lambda: jax_fv.FlashVSRTransformer3DModel(cfg, dtype=jnp.float32, param_dtype=jnp.float32,
                                                             rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: port_fv.FlashVSRTransformer3DModel(port_fv.FlashVSRConfig(**TINY_CFG),
                                                                  dtype=torch.float32), jm)
    return jm, pm


def stream_inputs():
    rng = np.random.default_rng(0)
    noise = rng.normal(size=(1, 4, 10, 4, 4)).astype(np.float32)
    video = rng.uniform(-1, 1, size=(1, 3, 41, 32, 32)).astype(np.float32)  # 41 + 3 head frames: 10 latent frames
    context = rng.normal(size=(1, 5, 16)).astype(np.float32)
    return noise, video, context


def stream(model, noise, video, context, tables):
    """The three chunks through ``model`` (``tables``: each chunk's RoPE cos
    and sin): (LQ tokens, [(prediction, caches)])."""
    t, t_mod = model.time_embed(1000.0)
    ctx_kv = model.context_kv(context)
    lq = model.LQ_proj_in(video)
    caches, out = None, []
    for (a, b, _), (cos, sin) in zip(CHUNKS, tables):
        pred, caches = model(noise[:, :, a:b], t, t_mod, cos, sin, ctx_kv,
                             lq_tokens=[x[:, a * 4:b * 4] for x in lq], caches=caches)
        out.append((pred, caches))
    return lq, out


@pytest.fixture(scope="module")
def jax_stream(dit_pair):
    """JAX's three chunks, one jitted program (the RoPE tables from its host helper)."""
    jm, _ = dit_pair
    tables = [tuple(map(jnp.asarray, jax_fv._rope_tables_3d(jm.cfg.head_dim, b - a, 2, 2, start)))
              for a, b, start in CHUNKS]
    graphdef, state = nnx.split(jm)
    run = jax.jit(lambda s, n, v, c: stream(nnx.merge(graphdef, s), n, v, c, tables))
    return jax.tree.map(np.asarray, run(state, *map(jnp.asarray, stream_inputs())))


@pytest.mark.parametrize("chunk", range(3))
def test_streaming_chunks_and_caches_match_jax(dit_pair, jax_stream, chunk):
    _, pm = dit_pair
    noise, video, context = map(torch.from_numpy, stream_inputs())
    _, out = stream(pm, noise, video, context, [pm.rope_for_chunk(b - a, 2, 2, start) for a, b, start in CHUNKS])
    pred, caches = out[chunk]
    want_pred, want_caches = jax_stream[1][chunk]
    a, b, _ = CHUNKS[chunk]
    assert tuple(pred.shape) == want_pred.shape == (1, 4, b - a, 4, 4)
    assert_close(pred, want_pred, 1e-4)
    keep = 3 * 2 * 4  # kv_len chunks of 2 latent frames of 2 x 2 tokens
    for (k, v), (wk, wv) in zip(caches, want_caches):
        assert tuple(k.shape) == wk.shape == (1, keep, 48)
        assert_close(k, wk, 1e-4)
        assert_close(v, wv, 1e-4)


def test_lq_projector_matches_jax(dit_pair, jax_stream):
    _, pm = dit_pair
    _, video, _ = stream_inputs()
    got = pm.LQ_proj_in(torch.from_numpy(video))
    assert len(got) == 1 and tuple(got[0].shape) == jax_stream[0][0].shape == (1, 10 * 4, 48)
    assert_close(got[0], jax_stream[0][0], 1e-4)


def test_rope_tables_bit_equal_to_jax():
    for f, h, w, start in ((6, 2, 3, 0), (2, 40, 80, 10)):
        for got, want in zip(port_fv._rope_tables_3d(128, f, h, w, start), jax_fv._rope_tables_3d(128, f, h, w, start)):
            np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def tae_pair():
    jm = jax_build(lambda: jax_tae.TinyWanVAE(jax_tae.TAEConfig.from_dict(TINY_WAN), rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: port_tae.TinyWanVAE(port_tae.TAEConfig.from_dict(TINY_WAN)), jm)
    return jm, pm


@pytest.mark.parametrize("cond_frames", [9, 12], ids=["head_padded", "whole"])
def test_tiny_wan_decode_with_cond_matches_jax(tae_pair, cond_frames):
    jm, pm = tae_pair
    rng = np.random.default_rng(cond_frames)
    z = rng.normal(size=(1, 4, 3, 4, 4)).astype(np.float32)
    cond = rng.uniform(-1, 1, size=(1, 3, cond_frames, 32, 32)).astype(np.float32)
    graphdef, state = nnx.split(jm)
    want = np.asarray(jax.jit(lambda s, a, c: nnx.merge(graphdef, s).decode(a, cond=c))(
        state, jnp.asarray(z), jnp.asarray(cond)))
    got = pm.decode(torch.from_numpy(z), cond=torch.from_numpy(cond))
    assert tuple(got.shape) == want.shape == (1, 3, 9, 32, 32)
    assert_close(got, want, 1e-4)


def test_tiny_wan_is_deepened_and_cannot_encode(tae_pair):
    jm, pm = tae_pair
    assert len(pm.decoder) == len(jm.decoder) == 23 + 4  # two activations deepened by a conv and an activation
    assert pm.cfg.deepen == 1 and pm.cfg.decoder_only and pm.encoder is None
    video = np.zeros((1, 3, 4, 32, 32), np.float32)
    with pytest.raises(NotImplementedError):
        pm.encode(torch.from_numpy(video))
    with pytest.raises(NotImplementedError):
        jm.encode(jnp.asarray(video))


def test_converters_through_an_exported_file(dit_pair, tae_pair, tmp_path):
    file_round_trip("wan_flashvsr", lambda: port_fv.FlashVSRTransformer3DModel(port_fv.FlashVSRConfig(**TINY_CFG),
                                                                               dtype=torch.float32),
                    nnx.clone(dit_pair[0]), tmp_path / "flashvsr.safetensors")
    file_round_trip("tiny_wan_vae", lambda: port_tae.TinyWanVAE(port_tae.TAEConfig.from_dict(TINY_WAN)),
                    nnx.clone(tae_pair[0]), tmp_path / "tcdecoder.safetensors")


def manifest(tmp_path, kind):
    """The repository manifest with toy components in f32 and no weight files
    (a one-layer DiT: the module tests above hold two layers' caches)."""
    doc = yaml.safe_load(MANIFESTS[kind].read_text())
    vae = TINY_WAN if kind == "tiny" else json.loads(json.dumps(QWEN))
    tiny = {"transformer": dict(TINY_CFG, num_layers=1), "vae": vae}
    for comp in doc["spec"]["components"]:
        if comp["type"] in tiny:
            for key in ("config_path", "model_path"):
                comp.pop(key, None)
            comp["precision"] = "fp32"
            comp["config"] = copy.deepcopy(tiny[comp["type"]])
    path = tmp_path / f"flashvsr-{kind}.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """{(side, kind): engine}; the tiny manifest's engines share the full
    one's DiT; the port's components carried from the JAX side."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        root = tmp_path_factory.mktemp("flashvsr")
        out = {}
        for side in ("jax", "port"):
            mp.setenv("APEX_HOME_DIR", str(root / f"home_{side}"))
            for kind in ("full", "tiny"):
                path = manifest(root, kind)
                eng = (fast_jax_engine(JaxUniversalEngine(path)) if side == "jax"
                       else UniversalEngine(path, device="cpu"))
                if kind == "tiny":
                    eng.transformer = out[side, "full"].transformer
                eng.load_component_by_type("vae")
                if kind == "full":
                    eng.load_component_by_type("transformer")
                out[side, kind] = eng
        for kind in ("full", "tiny"):
            load_from_jax(out["port", kind].vae, jax_params(out["jax", kind].vae))
        load_from_jax(out["port", "full"].transformer, jax_params(out["jax", "full"].transformer))
        yield out


def clip():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8) for _ in range(41)]


@pytest.fixture(scope="module")
def jax_runs(engines):
    """JAX's latents (the full manifest; the tiny one's DiT is the same) and
    both manifests' frames."""
    latents = np.asarray(engines["jax", "full"].run(video=clip(), seed=1, return_latents=True))
    return latents, {kind: np.stack(engines["jax", kind].run(video=clip(), seed=1)).astype(np.int16)
                     for kind in ("full", "tiny")}


def test_latents_match_jax(engines, jax_runs):
    messages = []
    got = engines["port", "full"].run(video=clip(), seed=1, return_latents=True,
                                      progress_callback=lambda p, m, *a: messages.append(m))
    assert tuple(got.shape) == jax_runs[0].shape == (1, 4, 10, 16, 16)
    assert_close(got, jax_runs[0], 1e-4)
    assert [m for m in messages if m.startswith("FlashVSR chunk")] == [f"FlashVSR chunk {c}/3" for c in (1, 2, 3)]


@pytest.mark.parametrize("kind", ["full", "tiny"])
def test_frames_match_jax(engines, jax_runs, kind):
    port = engines["port", kind]
    assert type(port) is FlashVSRUpscaleEngine
    assert isinstance(port.vae, port_tae.TinyWanVAE) == (kind == "tiny")
    got = np.stack(port.run(video=clip(), seed=1)).astype(np.int16)
    want = jax_runs[1][kind]
    assert got.shape == want.shape == (37, 128, 128, 3)
    assert int(np.abs(got - want).max()) <= 1


def test_frame_rules_and_seeded_noise(engines):
    assert [largest_8n1_leq(n) for n in (0, 1, 8, 9, 45, 29)] == [0, 1, 1, 9, 41, 25]
    port = engines["port", "full"]
    short = port.run(image=np.zeros((32, 48, 3), np.uint8), seed=2, return_latents=True)
    assert tuple(short.shape) == (1, 4, 6, 16, 16)  # an image: 25 frames, one chunk; 128 x 192 cut to 128 x 128
    a = port.run(video=clip(), seed=2, return_latents=True)
    assert torch.equal(a, port.run(video=clip(), seed=2, return_latents=True))
    assert not torch.equal(a, port.run(video=clip(), seed=3, return_latents=True))


def test_manifests_resolve_in_the_port():
    from apex_studio_tpu_torch.engine.registry import resolve_engine_class
    from apex_studio_tpu_torch.models.registry import _load_builtin_families, transformer_registry, vae_registry

    _load_builtin_families()
    for kind, path in MANIFESTS.items():
        doc = yaml.safe_load(path.read_text())["spec"]
        assert resolve_engine_class(doc["engine"], doc["model_type"]) is FlashVSRUpscaleEngine
        bases = {c["type"]: c["base"] for c in doc["components"] if "base" in c}  # not the extra weights' entry
        assert transformer_registry.get(bases["transformer"]) is port_fv.FlashVSRTransformer3DModel
        assert (vae_registry.get(bases["vae"]) is port_tae.TinyWanVAE) == (kind == "tiny")
