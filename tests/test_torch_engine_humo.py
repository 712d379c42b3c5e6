"""The port's HuMo engine end to end against the JAX package's, on the CPU,
from the tiny manifest of tests/test_engine_wan_humo.py set to fp32 (the
toy Wan VAE, UMT5 and FlowUniPC of ``WAN_TINY``, a 2-block HuMo DiT, a 2-layer
wav2vec2): TIA mode (a reference image, the negative branch across
``step_change``) and TA mode (audio alone), every component's weights carried
from the JAX engine into the port, each engine in its own ``APEX_HOME_DIR``.
Latents after 2 steps: max|Δ| ≤ 1e-3·max|ref|; frames within one uint8
step. Also the audio windows and the wav2vec2 stack against JAX's.
"""

import contextlib
import wave

import numpy as np
import pytest
import torch
import yaml

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine.wan import WanHuMoEngine
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from tests.test_engine_wan_humo import _engine
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import assert_close, fast_jax_engine, jax_params

RNG = np.random.default_rng(1)
IMAGE = RNG.integers(0, 255, size=(32, 32, 3), dtype=np.uint8)
WAV = (RNG.standard_normal(8000) * 0.1).astype(np.float32)
BASE = dict(prompt="a person sings", height=32, width=32, num_frames=9, num_inference_steps=2, fps=10, seed=4)
REQUESTS = {
    "tia_cfg": dict(BASE, audio=WAV, image=IMAGE, negative_prompt="blurry", guidance_scale_a=2.0,
                    guidance_scale_t=3.0),
    "ta": dict(BASE, audio=WAV, guidance_scale_a=2.0, guidance_scale_t=1.0),
}


def components(engine):
    engine.load_components(return_latents=False)
    return {"vae": engine.vae, "transformer": engine.transformer, "umt5": engine.text_encoder._ensure_model(),
            "wav2vec2": engine.load_helper("audio_encoder")}


class Pair:
    def __init__(self, tmp_path):
        self.tmp = tmp_path
        _engine(tmp_path)  # writes the JAX test's manifest
        path = tmp_path / "wan-humo.yml"
        doc = yaml.safe_load(path.read_text())
        for comp in doc["spec"]["components"]:
            if comp["type"] != "scheduler":
                comp["precision"] = "fp32"
        path.write_text(yaml.safe_dump(doc))
        with self.env("jax"):
            self.jax = fast_jax_engine(JaxUniversalEngine(path))
        with self.env("port"):
            self.port = UniversalEngine(path, device="cpu")
        for engine in (self.jax, self.port):
            engine._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()

    @contextlib.contextmanager
    def env(self, side):
        with pytest.MonkeyPatch.context() as mp:
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
def pair(tmp_path_factory):
    return Pair(tmp_path_factory.mktemp("humo"))


class TestHuMoEngine:
    @pytest.mark.parametrize("case", ["tia_cfg", "ta"])
    def test_latents_match_jax(self, pair, case):
        run = {**REQUESTS[case], "return_latents": True}
        ref, lat = np.asarray(pair.run_jax(**run)), pair.run_port(**run)
        # TIA drops the trailing reference slot of the 5 latent frames
        assert tuple(lat.shape) == ref.shape == ((1, 4, 4, 16, 16) if case == "tia_cfg" else (1, 4, 5, 16, 16))
        assert_close(lat, ref, rel=1e-3)

    def test_frames_from_a_wav_file_match_jax(self, pair, tmp_path):
        path = tmp_path / "voice.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(WAV, -1, 1) * 32767).astype(np.int16).tobytes())
        run = {**REQUESTS["ta"], "audio": str(path)}
        ref, frames = pair.run_jax(**run), pair.run_port(**run)
        assert len(frames) == len(ref) == 9 and frames[0].shape == (32, 32, 3)
        assert max(np.abs(a.astype(np.int16) - b.astype(np.int16)).max() for a, b in zip(frames, ref)) <= 1

    def test_audio_stack_and_windows_match_jax(self, pair):
        pair.run_port(**{**REQUESTS["ta"], "return_latents": True})  # carries the weights
        with pair.env("jax"):
            ref = pair.jax.encode_audio_stack(WAV, 16000, 10, 9)
        with pair.env("port"):
            stack = pair.port.encode_audio_stack(WAV, 16000, 9)
        assert stack.shape == ref.shape == (9, 2, 16)
        assert_close(torch.from_numpy(stack), ref)
        np.testing.assert_array_equal(WanHuMoEngine.audio_windows(stack, 9, 2),
                                      pair.jax.audio_windows(stack, 9, 2))
        assert WanHuMoEngine.audio_windows(stack, 9, 2).shape == (5, 6, 2, 16)

    def test_encoder_depth_must_match_the_windows(self, pair):
        """The windows stack one wav2vec2 state a layer: a DiT that stacks
        another count raises before the DiT runs (JAX fails inside it)."""
        with pair.env("port"):
            components(pair.port)
            blocks = pair.port.transformer.cfg.audio_blocks
            pair.port.transformer.cfg.audio_blocks = blocks + 1
            try:
                with pytest.raises(ValueError, match="hidden states"):
                    pair.port.encode_audio_stack(WAV, 16000, 9)
            finally:
                pair.port.transformer.cfg.audio_blocks = blocks


def test_audio_encoder_loads_a_published_checkpoint(tmp_path, monkeypatch):
    """A ``Wav2Vec2Model`` helper's file in transformers' naming loads through
    the ``wav2vec2`` converter, strictly and bit-equal (the JAX engine derives
    the family ``wav2vec2model``, which names no converter)."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.loaders.export import published_state_dict
    from apex_studio_tpu_torch.loaders.safetensors_io import save_safetensors
    from apex_studio_tpu_torch.models.audio.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model

    monkeypatch.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
    monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
    _engine(tmp_path)
    path = tmp_path / "wan-humo.yml"
    doc = yaml.safe_load(path.read_text())
    helper = next(c for c in doc["spec"]["components"] if c.get("name") == "audio_encoder")
    source = materialize_random(lambda: Wav2Vec2Model(Wav2Vec2Config.from_dict(helper["config"])),
                                torch.device("cpu"), seed=5)
    save_safetensors(tmp_path / "w2v.safetensors", published_state_dict("wav2vec2", source.state_dict()))
    helper["model_path"] = str(tmp_path / "w2v.safetensors")
    path.write_text(yaml.safe_dump(doc))
    loaded = UniversalEngine(path, device="cpu").load_helper("audio_encoder")
    for name, value in source.state_dict().items():
        assert torch.equal(loaded.state_dict()[name], value), name
