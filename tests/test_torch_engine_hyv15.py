"""The port's HunyuanVideo 1.5 engines end to end against the JAX package's, on
the CPU, from the tiny manifests of tests/test_engine_hyv15.py set to fp32.

Every component's weights are carried from the JAX engine into the port
(the SigLIP helper too, which each run loads and then releases, so it is
carried before each run). Both engines keep their text encoders
(``APEX_RELEASE_TEXT_ENCODERS=0``): a released encoder is rebuilt from its own
seed, which differs between the packages. Each engine has its own
``APEX_HOME_DIR``, since encodes are disk-cached by prompt and config.
Latents after 2 steps with CFG: max|Δ| ≤ 1e-3·max|ref| (within the 5e-3 the
port holds whole models to); frames within one uint8 step.

Also here: the 720p-class staging at tiny size (the VAE leaves during the
denoise, previews ride the light TAE, few-step runs never preview, no light
VAE turns previews off rather than failing the run), and where the port
deliberately differs: a ``light_vae_config`` without a ``light_vae_path``
raises instead of previewing through a random TAE.
"""

import copy

import numpy as np
import pytest
import torch
import yaml

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.loaders.export import published_state_dict
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from apex_studio_tpu_torch.loaders.safetensors_io import save_safetensors
from tests.test_engine_hyv15 import HYV_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import assert_close, jax_params

SIGLIP = {"type": "helper", "name": "image_encoder", "base": "SiglipVisionModel", "precision": "fp32",
          "config": {"hidden_size": 16, "intermediate_size": 32, "num_hidden_layers": 1,
                     "num_attention_heads": 2, "image_size": 28, "patch_size": 14}}
LIGHT_VAE = {"latent_channels": 4, "channels": [8, 8, 8, 8], "decoder_time_upscale": [False, True],
             "decoder_space_upscale": [True, True, False]}
RUN = dict(prompt='a shop sign that reads "OPEN"', negative_prompt="blurry", height=16, width=16,
           num_frames=5, num_inference_steps=2, guidance_scale=5.0, seed=3)
IMAGE = (np.random.default_rng(0).random((20, 24, 3)) * 255).astype(np.uint8)


def manifest(tmp_path, model_type="t2v", helper=True, light_vae=None, name="hyv15"):
    doc = copy.deepcopy(HYV_TINY)
    doc["spec"]["model_type"] = model_type
    for comp in doc["spec"]["components"]:
        if comp["type"] != "scheduler":
            comp["precision"] = "fp32"
        if comp["type"] == "vae" and light_vae is not None:
            comp["config"].update(light_vae)
    if model_type == "i2v" and helper:
        doc["spec"]["components"].append(copy.deepcopy(SIGLIP))
    path = tmp_path / f"{name}-{model_type}.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


def inject_tokenizer(engine):
    tok = make_tokenizer()
    for spec in engine.component_specs.values():
        if spec.get("type") == "text_encoder":
            spec["tokenizer"] = tok


def components(engine):
    engine.load_component_by_type("vae")
    engine.load_component_by_type("transformer")
    engine.load_text_encoders()
    parts = {"vae": engine.vae, "transformer": engine.transformer,
             "qwen": engine.text_encoder._ensure_model(), "byt5": engine.text_encoder_2._ensure_model()}
    if any(s.get("type") == "helper" for s in engine.component_specs.values()):
        parts["siglip"] = engine.load_helper("image_encoder")
    return parts


class Pair:
    """A JAX engine and a port engine on one manifest, the port carrying the
    JAX engine's weights before every run."""

    def __init__(self, path, tmp_path, monkeypatch):
        monkeypatch.setenv("APEX_RELEASE_TEXT_ENCODERS", "0")
        monkeypatch.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        self.mp, self.tmp = monkeypatch, tmp_path
        self.mp.setenv("APEX_HOME_DIR", str(tmp_path / "home_jax"))
        self.jax = JaxUniversalEngine(path)
        inject_tokenizer(self.jax)
        self.mp.setenv("APEX_HOME_DIR", str(tmp_path / "home_port"))
        self.port = UniversalEngine(path, device="cpu")
        inject_tokenizer(self.port)

    def run_jax(self, **kw):
        self.mp.setenv("APEX_HOME_DIR", str(self.tmp / "home_jax"))
        components(self.jax)
        return self.jax.run(**kw)

    def run_port(self, **kw):
        self.mp.setenv("APEX_HOME_DIR", str(self.tmp / "home_port"))
        ref = components(self.jax)
        for name, module in components(self.port).items():
            load_from_jax(module, jax_params(ref[name]))
        return self.port.run(**kw)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """(case → (JAX latents, port latents)) for the t2v and i2v engines."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for case, model_type, kw in (("t2v_cfg_glyph", "t2v", {}),
                                     ("i2v_cfg_glyph", "i2v", {"image": IMAGE}),
                                     ("i2v_rescaled_no_glyph", "i2v", {"image": IMAGE, "prompt": "a harbour",
                                                                       "guidance_rescale": 0.7}),
                                     ("t2v_no_cfg", "t2v", {"guidance_scale": 1.0})):
            tmp = tmp_path_factory.mktemp(case)
            pair = Pair(manifest(tmp, model_type), tmp, mp)
            run = {**RUN, **kw, "return_latents": True}
            out[case] = (np.asarray(pair.run_jax(**run)), pair.run_port(**run))
    return out


class TestLatentsMatchJax:
    @pytest.mark.parametrize("case", ["t2v_cfg_glyph", "i2v_cfg_glyph", "i2v_rescaled_no_glyph", "t2v_no_cfg"])
    def test_latents(self, parity, case):
        ref, lat = parity[case]
        assert lat.dtype == torch.float32 and tuple(lat.shape) == ref.shape == (1, 4, 3, 4, 4)
        assert_close(lat, ref, rel=1e-3)

    def test_image_changes_the_latents(self, parity):
        assert not np.allclose(parity["i2v_cfg_glyph"][1].numpy(), parity["t2v_cfg_glyph"][1].numpy())


class TestEngine:
    def test_frames_match_jax(self, tmp_path, monkeypatch):
        pair = Pair(manifest(tmp_path, "i2v"), tmp_path, monkeypatch)
        run = {**RUN, "image": IMAGE}
        ref, frames = pair.run_jax(**run), pair.run_port(**run)
        assert len(frames) == len(ref) == 5
        assert all(f.shape == (16, 16, 3) and f.dtype == np.uint8 for f in frames)
        diff = max(np.abs(a.astype(np.int16) - b.astype(np.int16)).max() for a, b in zip(frames, ref))
        assert diff <= 1

    def test_mllm_encode_matches_jax(self, tmp_path, monkeypatch):
        """Chat template, max length 1000 + 108, the crop and skip 2."""
        pair = Pair(manifest(tmp_path), tmp_path, monkeypatch)
        pair.run_port(**{**RUN, "num_inference_steps": 1, "return_latents": True})
        ref_h, ref_m = pair.jax._encode_mllm(RUN["prompt"])
        monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home_port"))
        h, m = pair.port._encode_mllm(RUN["prompt"])
        assert tuple(h.shape) == (1, 1000, 32) and tuple(m.shape) == (1, 1000)
        np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m))
        assert_close(h, ref_h)
        cached_h, _ = pair.port._encode_mllm(RUN["prompt"])  # from the disk cache
        assert torch.equal(cached_h, h.float())

    def test_seed_determinism_and_glyph_zeros(self, tmp_path, monkeypatch):
        pair = Pair(manifest(tmp_path), tmp_path, monkeypatch)
        run = {**RUN, "return_latents": True}
        a, b = pair.run_port(**run), pair.run_port(**run)
        assert torch.equal(a, b)
        assert not torch.equal(a, pair.run_port(**{**run, "seed": 4}))
        pair.port.load_component_by_type("transformer")
        zeros, mask = pair.port._encode_byt5("no quotes here")
        assert tuple(zeros.shape) == (1, 128, 16) and not zeros.any() and not mask.any()
        glyph, glyph_mask = pair.port._encode_byt5(RUN["prompt"])
        assert glyph.abs().max() > 0 and int(glyph_mask.sum()) >= 1

    def test_i2v_requires_an_image(self, tmp_path, monkeypatch):
        pair = Pair(manifest(tmp_path, "i2v"), tmp_path, monkeypatch)
        with pytest.raises(ValueError, match="requires an input image"):
            pair.port.run(**RUN)

    def test_i2v_without_helper_zeroes_the_vision_stream_as_jax(self, tmp_path, monkeypatch):
        pair = Pair(manifest(tmp_path, "i2v", helper=False), tmp_path, monkeypatch)
        run = {**RUN, "image": IMAGE, "return_latents": True}
        assert_close(pair.run_port(**run), pair.run_jax(**run), rel=1e-3)

    def test_entry_point_defaults_to_the_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            UniversalEngine(manifest(tmp_path))


def write_light_vae(tmp_path):
    """A TAE checkpoint in TAEHV's naming (seeded random weights)."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.vaes.tae_vae import TAEVAE, TAEConfig

    tae = materialize_random(lambda: TAEVAE(TAEConfig.from_dict(LIGHT_VAE)), torch.device("cpu"), seed=9, std=0.2)
    path = tmp_path / "lighttae.safetensors"
    save_safetensors(path, published_state_dict("tae_vae", tae.state_dict()))
    return path, tae


class TestBigRunStaging:
    """At 16 px (a 4×4 latent grid) with ``APEX_VAE_TILE_THRESHOLD=8`` the
    tiny engine takes the 720p-class path (tests/test_engine_hyv15.py
    TestBigRunMemoryStaging)."""

    def engine(self, tmp_path, monkeypatch, light_vae):
        monkeypatch.setenv("APEX_VAE_TILE_THRESHOLD", "8")
        monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
        monkeypatch.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        eng = UniversalEngine(manifest(tmp_path, light_vae=light_vae), device="cpu")
        inject_tokenizer(eng)
        return eng

    def run(self, eng, steps, previews, vae_seen=None):
        def on_preview(frames, i):
            previews.append((i, len(frames), frames[0].shape))
            if vae_seen is not None:
                vae_seen.append(eng.vae)

        return eng.run(prompt="x", height=16, width=16, num_frames=3, num_inference_steps=steps,
                       guidance_scale=1.0, seed=0, render_on_step=True, render_on_step_callback=on_preview,
                       render_on_step_interval=3)

    def test_vae_released_and_previews_ride_the_tae(self, tmp_path, monkeypatch):
        path, tae = write_light_vae(tmp_path)
        eng = self.engine(tmp_path, monkeypatch, {"light_vae_path": str(path), "light_vae_config": LIGHT_VAE})
        previews, vae_seen = [], []
        frames = self.run(eng, 10, previews, vae_seen)
        assert len(frames) == 3 and frames[0].shape == (16, 16, 3)
        assert [p[0] for p in previews] == [2, 5, 8]
        assert previews[0][1:] == (3, (16, 16, 3))  # the TAE's 2× time and 4× space
        assert all(v is None for v in vae_seen), "the full VAE must stay released while previews render"
        loaded = eng._get_preview_vae()
        assert all(torch.equal(loaded.state_dict()[k], v) for k, v in tae.state_dict().items())
        assert eng.vae is not None and eng.transformer is None  # decode reloaded the VAE, the DiT left

    def test_no_light_vae_disables_previews_not_the_run(self, tmp_path, monkeypatch):
        eng = self.engine(tmp_path, monkeypatch, None)
        previews = []
        assert len(self.run(eng, 10, previews)) == 3 and not previews

    def test_absent_light_vae_file_disables_previews(self, tmp_path, monkeypatch):
        eng = self.engine(tmp_path, monkeypatch, {"light_vae_path": "not/downloaded.safetensors"})
        previews = []
        assert len(self.run(eng, 10, previews)) == 3 and not previews

    def test_few_step_run_never_previews(self, tmp_path, monkeypatch):
        path, _ = write_light_vae(tmp_path)
        eng = self.engine(tmp_path, monkeypatch, {"light_vae_path": str(path), "light_vae_config": LIGHT_VAE})
        previews = []
        assert len(self.run(eng, 2, previews)) == 3 and not previews

    def test_light_config_without_path_fails_loud_unlike_jax(self, tmp_path, monkeypatch):
        """The JAX engine previews through a randomly initialised TAE here
        (noise, silently); the port raises. In synthetic-weight mode both
        stand a random TAE in."""
        light = {"light_vae_config": LIGHT_VAE}
        monkeypatch.setenv("APEX_VAE_TILE_THRESHOLD", "8")
        monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home_jax"))
        jeng = JaxUniversalEngine(manifest(tmp_path, light_vae=light, name="jax"))
        inject_tokenizer(jeng)
        jax_previews = []
        self.run(jeng, 10, jax_previews)
        assert jax_previews, "the JAX engine previews through its random TAE"

        eng = self.engine(tmp_path, monkeypatch, light)
        with pytest.raises(ValueError, match="without light_vae_path"):
            self.run(eng, 10, [])

        monkeypatch.setenv("APEX_SYNTHETIC_WEIGHTS", "bf16")
        eng = UniversalEngine(manifest(tmp_path, light_vae=light, name="synthetic"), device="cpu")
        inject_tokenizer(eng)
        previews = []
        assert len(self.run(eng, 10, previews)) == 3 and len(previews) == 3
