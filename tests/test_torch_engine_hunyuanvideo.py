"""The port's HunyuanVideo (original) engines end to end against the JAX
package's, on the CPU, from the tiny manifests of
tests/test_engine_hunyuanvideo.py set to fp32: t2v (with and without true
CFG), i2v in both image-condition modes, and FramePack in both sampling
types.

The JAX engine builds its components with seeded numpy values
(``fast_jax_engine``) and every component's weights are carried from it into
the port (the llava-llama and CLIP encoders, the DiT, the VAE). Both engines
keep their text encoders (``APEX_RELEASE_TEXT_ENCODERS=0``); each has its own
``APEX_HOME_DIR``, since encodes are disk-cached by prompt and config.
Latents: max|Δ| ≤ 1e-3·max|ref|; frames within one uint8 step.

Also: ``_encode_llama``'s crop of the template prefix and its hidden-state
offset (the third state from the top), and where the port deliberately
differs: a configured FramePack image encoder that fails raises.
"""

import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch
import yaml

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from tests.test_engine_hunyuanvideo import HYV_ORIG_TINY, _i2v_manifest
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import assert_close, fast_jax_engine, jax_params

RUN = dict(prompt="a red fox", height=16, width=16, num_frames=5, num_inference_steps=2, guidance_scale=6.0,
           seed=3)
IMAGE = (np.random.default_rng(0).random((20, 24, 3)) * 255).astype(np.uint8)


def fp32(doc, name):
    doc = copy.deepcopy(doc)
    doc["metadata"]["id"] = name
    for comp in doc["spec"]["components"]:
        if comp["type"] != "scheduler":
            comp["precision"] = "fp32"
    return doc


def framepack_manifest():
    doc = fp32(HYV_ORIG_TINY, "hyv-framepack-tiny")
    doc["spec"]["model_type"] = "framepack"
    for comp in doc["spec"]["components"]:
        if comp["type"] == "scheduler":
            comp.update(base="FlowMatchEulerDiscreteScheduler",
                        config={"num_train_timesteps": 1000, "use_dynamic_shifting": True})
        if comp["type"] == "transformer":
            comp["base"] = "hunyuanvideo.framepack"
    return doc


MANIFESTS = {
    "t2v": lambda: fp32(HYV_ORIG_TINY, "hyv-t2v"),
    "token_replace": lambda: fp32(_i2v_manifest("token_replace"), "hyv-i2v-tr"),
    "latent_concat": lambda: fp32(_i2v_manifest("latent_concat"), "hyv-i2v-lc"),
    "framepack": framepack_manifest,
}


def components(engine):
    engine.load_components()
    return {"vae": engine.vae, "transformer": engine.transformer, "llama": engine.text_encoder._ensure_model(),
            "clip": engine.text_encoder_2._ensure_model()}


class Pair:
    """A JAX engine and a port engine on one manifest, the port carrying the
    JAX engine's weights before every run, each in its own environment."""

    def __init__(self, doc, tmp_path):
        self.tmp = tmp_path
        path = tmp_path / "manifest.yml"
        path.write_text(yaml.safe_dump(doc))
        with self.env("jax"):
            self.jax = fast_jax_engine(JaxUniversalEngine(path))
        with self.env("port"):
            self.port = UniversalEngine(path, device="cpu")
        tok = make_tokenizer()
        for engine in (self.jax, self.port):
            for spec in engine.component_specs.values():
                if spec.get("type") == "text_encoder":
                    spec["tokenizer"] = tok

    @contextlib.contextmanager
    def env(self, side):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("APEX_RELEASE_TEXT_ENCODERS", "0")
            mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
            mp.setenv("APEX_HOME_DIR", str(self.tmp / f"home_{side}"))
            yield

    def run_jax(self, **kw):
        with self.env("jax"):
            components(self.jax)
            return self.jax.run(**kw)

    def run_port(self, **kw):
        with self.env("port"):
            ref = components(self.jax)
            for name, module in components(self.port).items():
                load_from_jax(module, jax_params(ref[name]))
            return self.port.run(**kw)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    made = {}

    def get(case):
        if case not in made:
            made[case] = Pair(MANIFESTS[case](), tmp_path_factory.mktemp(f"hyv_{case}"))
        return made[case]

    return get


# (case, manifest, request beyond RUN)
LATENT_CASES = [
    ("t2v", "t2v", {}),
    ("t2v_true_cfg", "t2v", {"true_guidance_scale": 3.0, "negative_prompt": "blurry"}),
    ("i2v_token_replace", "token_replace", {"image": IMAGE}),
    ("i2v_latent_concat", "latent_concat", {"image": IMAGE}),
]


class TestEngines:
    @pytest.mark.parametrize("case,manifest,kw", LATENT_CASES, ids=[c[0] for c in LATENT_CASES])
    def test_latents_match_jax(self, pairs, case, manifest, kw):
        pair = pairs(manifest)
        run = {**RUN, **kw, "return_latents": True}
        ref, lat = np.asarray(pair.run_jax(**run)), pair.run_port(**run)
        assert lat.dtype == torch.float32 and tuple(lat.shape) == ref.shape == (1, 4, 3, 4, 4)
        assert_close(lat, ref, rel=1e-3)
        if manifest == "token_replace":  # the first latent frame stays the image latent
            other = pair.run_port(**{**run, "seed": 99})
            torch.testing.assert_close(other[:, :, 0], lat[:, :, 0], rtol=0, atol=0)

    def test_frames_match_jax(self, pairs):
        pair = pairs("token_replace")
        run = {**RUN, "image": IMAGE}
        ref, frames = pair.run_jax(**run), pair.run_port(**run)
        assert len(frames) == len(ref) == 5
        assert all(f.shape == (16, 16, 3) and f.dtype == np.uint8 for f in frames)
        assert max(np.abs(a.astype(np.int16) - b.astype(np.int16)).max() for a, b in zip(frames, ref)) <= 1

    def test_llama_crop_and_hidden_state_match_jax(self, pairs):
        """The template of 256 + 95 tokens, the first 95 cropped, the hidden
        state after all but the last 2 layers (the tiny encoder's
        ``skip_last_layers``), and the disk-cached repeat."""
        pair = pairs("t2v")
        pair.run_port(**{**RUN, "return_latents": True})  # loads and carries the weights
        with pair.env("jax"):
            ref_h, ref_m = pair.jax._encode_llama("a lighthouse at dusk")
        with pair.env("port"):
            h, m = pair.port._encode_llama("a lighthouse at dusk")
            cached_h, _ = pair.port._encode_llama("a lighthouse at dusk")
            model = pair.port.text_encoder._ensure_model()
            ids, mask = pair.port.text_encoder.tokenize(
                ["<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by detailing the "
                 "following aspects: 1. The main content and theme of the video."
                 "2. The color, shape, size, texture, quantity, text, and spatial relationships of the objects."
                 "3. Actions, events, behaviors temporal relationships, physical movement changes of the objects."
                 "4. background environment, light, style and atmosphere."
                 "5. camera angles, movements, and transitions used in the video:<|eot_id|>"
                 "<|start_header_id|>user<|end_header_id|>\n\na lighthouse at dusk<|eot_id|>"], 351)
            full = model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))
        assert tuple(h.shape) == (1, 256, 32) and tuple(m.shape) == (1, 256)
        np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m))
        assert_close(h, ref_h)
        torch.testing.assert_close(h, full[:, 95:], rtol=0, atol=0)
        assert torch.equal(cached_h, h.float())
        assert int(m.sum()) == int(mask.sum()) - 95  # the crop takes the first 95 real tokens
        # skip_last_layers 2 of 3: the first layer's output alone
        one = copy.deepcopy(model)
        one.cfg = dataclasses.replace(model.cfg, skip_last_layers=0)
        one.layers = one.layers[:1]
        with torch.inference_mode():
            torch.testing.assert_close(one(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask)),
                                       full, rtol=0, atol=0)


class TestFramepack:
    @pytest.mark.parametrize("sampling,kw", [
        ("inverted_anti_drifting", dict(num_frames=9, latent_window_size=3)),
        ("vanilla", dict(num_frames=9, latent_window_size=2, return_latents=True)),
    ], ids=["inverted_frames", "vanilla_latents"])
    def test_matches_jax(self, pairs, sampling, kw):
        pair = pairs("framepack")
        run = dict(image=IMAGE, prompt="long video", height=32, width=32, num_inference_steps=2,
                   guidance_scale=6.0, seed=0, sampling_type=sampling, **kw)
        ref, out = pair.run_jax(**run), pair.run_port(**run)
        if kw.get("return_latents"):
            assert tuple(out.shape) == np.asarray(ref).shape
            assert_close(out, np.asarray(ref), rel=1e-3)
        else:
            assert len(out) == len(ref) >= 9
            assert max(np.abs(a.astype(np.int16) - b.astype(np.int16)).max() for a, b in zip(out, ref)) <= 1

    def test_configured_image_encoder_failure_raises(self, pairs):
        """The JAX engine logs a failing image encoder and uses zeros; the
        port raises."""
        pair = pairs("framepack")
        pair.port.component_specs["image_encoder"] = {"type": "helper", "name": "image_encoder",
                                                      "base": "NoSuchVisionModel"}
        try:
            with pair.env("port"), pytest.raises(KeyError):
                pair.port._image_embeds(IMAGE)
        finally:
            del pair.port.component_specs["image_encoder"]
            pair.port.helpers.clear()
