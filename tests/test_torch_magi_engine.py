"""The port's MAGI-1 engines (t2v, i2v, v2v) against the JAX engines, from the
repository manifest at toy widths in f32 (a one-layer DiT and VAE, as the JAX
package's own engine test builds them; ``tests/test_torch_magi.py`` holds the
modules at two), every component carried from the JAX side and one
``APEX_HOME_DIR`` a side.

Each request: three chunks of 2 latent frames with ``window_size`` 2, so that
a clean context chunk re-enters the forward; one step a stage and
``cfg_number`` 3, so that the text, previous-chunk and unconditional branches
all run; i2v from an image that is resized (``cv2.INTER_AREA``) and pinned as
the first latent frame, v2v from a clip whose first whole chunk is the clean
prefix. Latents (read at the decode) within 1e-4 of max|ref|, frames within
one level. The three types of each package share one engine's components
(and, on the JAX side, its compiled forwards).
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine.magi import MagiI2VEngine, MagiT2VEngine, MagiV2VEngine
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from apex_studio_tpu_torch.models.transformers.magi import MagiTransformer3DModel
from apex_studio_tpu_torch.models.vaes.magi_vae import AutoencoderKLMagi
from tests.test_engine_magi import MAGI_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.test_torch_magi import DIT, VAE
from tests.torch_port_helpers import assert_close, fast_jax_engine, jax_params

MANIFEST = Path(__file__).resolve().parents[1] / "manifests" / "video" / "magi-1-t2v.yml"
TINY = {"transformer": dict(DIT, num_layers=1), "vae": dict(VAE, depth=1),
        "text_encoder": next(c["config"] for c in MAGI_TINY["spec"]["components"] if c["type"] == "text_encoder")}
TYPES = ("t2v", "i2v", "v2v")


def manifest(tmp_path):
    """The repository manifest with toy components in f32 and no weight files
    (its scheduler as published)."""
    doc = yaml.safe_load(MANIFEST.read_text())
    for comp in doc["spec"]["components"]:
        if comp["type"] == "scheduler":
            continue
        for key in ("config_path", "model_path"):
            comp.pop(key, None)
        comp["precision"] = "fp32"
        comp["config"] = copy.deepcopy(TINY[comp["type"]])
    path = tmp_path / "magi.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


def observed(engine):
    """Keep each decode's latents (``engine.decoded``)."""
    engine.decoded = []
    decode = engine.decode_latents

    def keep(z):
        engine.decoded.append(np.asarray(z, np.float32) if not isinstance(z, torch.Tensor) else z.numpy().copy())
        return decode(z)

    engine.decode_latents = keep
    return engine


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """{side: {type: engine}}: the t2v engine of each side loads its components
    (the port's carried from the JAX side); the i2v and v2v engines share them."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        root = tmp_path_factory.mktemp("magi")
        path = manifest(root)
        out = {}
        for side in ("jax", "port"):
            mp.setenv("APEX_HOME_DIR", str(root / f"home_{side}"))
            out[side] = {}
            for mt in TYPES:
                eng = (fast_jax_engine(JaxUniversalEngine(path, model_type=mt)) if side == "jax"
                       else UniversalEngine(path, model_type=mt, device="cpu"))
                if mt == "t2v":
                    eng._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
                    if side == "jax":
                        eng.load_components(False)
                    else:
                        eng.load_components()
                else:
                    first = out[side]["t2v"]
                    for name in ("text_encoder", "transformer", "vae", "scheduler"):
                        setattr(eng, name, getattr(first, name))
                    if side == "jax":
                        eng._jit_cache = first._jit_cache
                out[side][mt] = observed(eng)
        jax_eng, port_eng = out["jax"]["t2v"], out["port"]["t2v"]
        load_from_jax(port_eng.text_encoder._ensure_model(), jax_params(jax_eng.text_encoder._ensure_model()))
        for name in ("transformer", "vae"):
            load_from_jax(getattr(port_eng, name), jax_params(getattr(jax_eng, name)))
        yield out, root, mp


def request(model_type: str, seed: int = 3) -> dict:
    rng = np.random.default_rng(11)
    kw = dict(prompt="a red fox in the snow", negative_prompt="blurry", height=32, width=32, num_frames=24,
              num_inference_steps=2, seed=seed, chunk_width=2, window_size=2, cfg_number=3)
    if model_type == "i2v":
        kw["image"] = rng.integers(0, 256, size=(40, 48, 3), dtype=np.uint8)
    if model_type == "v2v":
        kw["video"] = [rng.integers(0, 256, size=(36, 40, 3), dtype=np.uint8) for _ in range(10)]
    return kw


@pytest.fixture(scope="module")
def runs(engines):
    """Each type through each side once: (latents, frames) a side and type."""
    out, root, mp = engines
    result = {}
    for side in ("jax", "port"):
        mp.setenv("APEX_HOME_DIR", str(root / f"home_{side}"))
        for mt in TYPES:
            eng = out[side][mt]
            eng.decoded.clear()
            frames = eng.run(**request(mt))
            result[side, mt] = (eng.decoded[0], np.stack(frames).astype(np.int16))
    return result


@pytest.mark.parametrize("model_type", TYPES)
def test_latents_and_frames_match_jax(engines, runs, model_type):
    out = engines[0]
    assert type(out["port"][model_type]) is {"t2v": MagiT2VEngine, "i2v": MagiI2VEngine,
                                             "v2v": MagiV2VEngine}[model_type]
    (want_lat, want_frames), (got_lat, got_frames) = runs["jax", model_type], runs["port", model_type]
    assert got_lat.shape == want_lat.shape == (1, 4, 6, 4, 4)
    assert_close(got_lat, want_lat, 1e-4)
    assert got_frames.shape == want_frames.shape == (24, 32, 32, 3)
    assert int(np.abs(got_frames - want_frames).max()) <= 1


def test_prefixes_stay_clean(engines, runs):
    """i2v's first latent frame is the image's encode, v2v's first chunk the
    clip's (cut to whole chunks), after every step."""
    out, root, mp = engines
    port = out["port"]["t2v"]
    mp.setenv("APEX_HOME_DIR", str(root / "home_port"))
    kw = request("i2v")
    import cv2

    image = cv2.resize(kw["image"], (32, 32), interpolation=cv2.INTER_AREA)
    vid = torch.from_numpy(image).float().permute(2, 0, 1)[None, :, None].repeat(1, 1, 4, 1, 1) / 127.5 - 1.0
    np.testing.assert_array_equal(runs["port", "i2v"][0][:, :, :1], port.vae.encode(vid).numpy())
    clip = np.stack([cv2.resize(f, (32, 32), interpolation=cv2.INTER_AREA) for f in request("v2v")["video"]])
    vid = torch.from_numpy(clip).float().permute(3, 0, 1, 2)[None, :, :8] / 127.5 - 1.0
    np.testing.assert_array_equal(runs["port", "v2v"][0][:, :, :2], port.vae.encode(vid).numpy())


def test_seed_repeats_and_the_window_launches(engines):
    """Two requests with one seed give equal latents, another seed others; a
    request runs 4 stages of three branches: the text and previous-chunk
    forwards over 1, 2, 3, 3 chunks (one self-attention call a chunk and
    layer) and the unconditional ones over 1, 2, 2, 1 single chunks."""
    out, root, mp = engines
    port = out["port"]["t2v"]
    mp.setenv("APEX_HOME_DIR", str(root / "home_port"))
    calls = []
    forward = MagiTransformer3DModel.forward

    def counted(self, x, t, *a, **k):
        calls.append((t.shape[0], t.shape[1], k.get("block_causal", True)))
        return forward(self, x, t, *a, **k)

    with pytest.MonkeyPatch.context() as local:
        local.setattr(MagiTransformer3DModel, "forward", counted)
        a = port.run(**dict(request("t2v"), return_latents=True))
    assert calls == [(1, 1, True), (1, 1, True), (1, 1, False), (1, 2, True), (1, 2, True), (2, 1, False),
                     (1, 3, True), (1, 3, True), (2, 1, False), (1, 3, True), (1, 3, True), (1, 1, False)]
    assert torch.equal(a, port.run(**dict(request("t2v"), return_latents=True)))
    assert not torch.equal(a, port.run(**dict(request("t2v", seed=4), return_latents=True)))


def test_manifest_resolves_in_the_port():
    from apex_studio_tpu_torch.engine.registry import resolve_engine_class
    from apex_studio_tpu_torch.models.registry import _load_builtin_families, transformer_registry, vae_registry
    from apex_studio_tpu_torch.schedulers import scheduler_registry
    from apex_studio_tpu_torch.schedulers.magi import MagiScheduler

    doc = yaml.safe_load(MANIFEST.read_text())["spec"]
    assert [resolve_engine_class(doc["engine"], mt) for mt in doc["model_type"]] == [
        MagiT2VEngine, MagiI2VEngine, MagiV2VEngine]
    _load_builtin_families()
    bases = {c["type"]: c["base"] for c in doc["components"]}
    assert transformer_registry.get(bases["transformer"]) is MagiTransformer3DModel
    assert vae_registry.get(bases["vae"]) is AutoencoderKLMagi
    assert scheduler_registry.get(bases["scheduler"]) is MagiScheduler
