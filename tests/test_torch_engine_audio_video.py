"""The port's audio-driven video engines end to end against the JAX package's,
on the CPU, from the tiny manifests of tests/test_engine_wan_s2v.py,
tests/test_engine_wan_multitalk.py and tests/test_engine_hyv_avatar.py set to
fp32: Wan S2V over two chunks with a pose video and ``init_first_frame``,
and one chunk with its motion dropped and CFG; MultiTalk over two clips
with two speakers (``audio_type="add"``, a negative prompt, colour
correction) and with one, and the HunyuanVideo Avatar over two windows whose
start rolls (``shift_offset`` 3) for 11 steps, across step 10's switch of the
negative prompt.

The JAX engines build their components with seeded numpy values
(``fast_jax_engine``) and every component's weights are carried into the
port; both keep their text encoders (``APEX_RELEASE_TEXT_ENCODERS=0``), each
has its own ``APEX_HOME_DIR``. Frames: within one uint8 level (S2V and
MultiTalk return frames only, as in JAX); Avatar latents: max|Δ| ≤
1e-3·max|ref|. Also: S2V's audio rows and MultiTalk's per-speaker stacks
against JAX's, the colour match, the speaker masks, the manifests resolving
to the ported engines, and where the port departs: an audio encoder whose
widths the DiT does not take raises before the DiT runs (the JAX engine's
defaults do not agree: a reference fault), and the Avatar's Whisper files.
"""

import contextlib
import copy
import wave
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine import wan as port_wan
from apex_studio_tpu_torch.engine.hunyuanvideo_avatar import HunyuanAvatarEngine
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from tests.test_engine_hyv_avatar import _avatar_manifest
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import assert_close, fast_jax_engine, jax_params

REPO = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(2)
IMAGE = RNG.integers(0, 255, size=(36, 40, 3), dtype=np.uint8)
POSE = [RNG.integers(0, 255, size=(32, 32, 3), dtype=np.uint8) for _ in range(5)]
WAV_S2V = (RNG.standard_normal(20000) * 0.1).astype(np.float32)  # 1.25 s
WAV_1, WAV_2 = ((RNG.standard_normal(12800) * 0.1).astype(np.float32) for _ in range(2))  # 0.8 s each


def fp32(doc):
    doc = copy.deepcopy(doc)
    for comp in doc["spec"]["components"]:
        if comp["type"] != "scheduler":
            comp["precision"] = "fp32"
    return doc


def written(writer, tmp_path, name):
    """The manifest a JAX test's ``_engine`` writes, in fp32."""
    writer(tmp_path)
    path = tmp_path / name
    path.write_text(yaml.safe_dump(fp32(yaml.safe_load(path.read_text()))))
    return path


def wan_components(engine):
    engine.load_components(return_latents=False)
    out = {"vae": engine.vae, "transformer": engine.transformer, "umt5": engine.text_encoder._ensure_model(),
           "wav2vec2": engine.load_helper("audio_encoder")}
    if "image_encoder" in engine.component_specs:
        out["clip"] = engine.load_helper("image_encoder")
    return out


def avatar_components(engine):
    engine.load_components()
    return {"vae": engine.vae, "transformer": engine.transformer, "llama": engine.text_encoder._ensure_model(),
            "clip": engine.text_encoder_2._ensure_model()}


class Pair:
    """A JAX engine and a port engine on one manifest, the port carrying the
    JAX engine's weights before every run, each in its own environment."""

    def __init__(self, path, tmp_path, components, **attrs):
        self.tmp, self.components = tmp_path, components
        with self.env("jax"):
            self.jax = fast_jax_engine(JaxUniversalEngine(path))
        with self.env("port"):
            self.port = UniversalEngine(path, device="cpu")
        tok = make_tokenizer()
        for engine in (self.jax, self.port):
            for spec in engine.component_specs.values():
                if spec.get("type") == "text_encoder":
                    spec["tokenizer"] = tok
            for name, value in attrs.items():
                setattr(engine, name, value)

    @contextlib.contextmanager
    def env(self, side):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("APEX_RELEASE_TEXT_ENCODERS", "0")
            mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
            mp.setenv("APEX_HOME_DIR", str(self.tmp / f"home_{side}"))
            yield

    def run_jax(self, **kw):
        with self.env("jax"):
            self.components(self.jax)
            return self.jax.run(**kw)

    def carry(self):
        ref = self.components(self.jax)
        for name, module in self.components(self.port).items():
            load_from_jax(module, jax_params(ref[name]))

    def run_port(self, **kw):
        with self.env("port"):
            self.carry()
            return self.port.run(**kw)


def assert_frames_close(frames, ref, n):
    assert len(frames) == len(ref) == n and frames[0].shape == ref[0].shape == (32, 32, 3)
    assert max(np.abs(a.astype(np.int16) - b.astype(np.int16)).max() for a, b in zip(frames, ref)) <= 1


@pytest.fixture(scope="module")
def s2v(tmp_path_factory):
    from tests.test_engine_wan_s2v import _engine

    tmp = tmp_path_factory.mktemp("s2v")
    # a 9-frame motion buffer (3 latent frames) in place of 73, as the JAX test runs it
    return Pair(written(_engine, tmp, "wan-s2v.yml"), tmp, wan_components, motion_frames=9)


@pytest.fixture(scope="module")
def multitalk(tmp_path_factory):
    from tests.test_engine_wan_multitalk import _engine

    tmp = tmp_path_factory.mktemp("multitalk")
    return Pair(written(_engine, tmp, "wan-multitalk.yml"), tmp, wan_components)


@pytest.fixture(scope="module")
def avatar(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("avatar")
    path = tmp / "avatar.yml"
    path.write_text(yaml.safe_dump(fp32(_avatar_manifest())))
    return Pair(path, tmp, avatar_components)


S2V_BASE = dict(prompt="someone speaking", audio=WAV_S2V, image=IMAGE, height=32, width=32,
                num_frames_per_chunk=8, num_inference_steps=2, fps=16, seed=5, num_chunks=2, pose_video=POSE)
S2V_REQUESTS = {
    "init_first_frame": dict(S2V_BASE, guidance_scale=1.0, init_first_frame=True),
    "drop_first_motion_cfg": dict(S2V_BASE, negative_prompt="static", guidance_scale=4.5, num_chunks=1),
}


class TestS2V:
    @pytest.mark.parametrize("case", list(S2V_REQUESTS))
    def test_frames_match_jax(self, s2v, case):
        ref, frames = s2v.run_jax(**S2V_REQUESTS[case]), s2v.run_port(**S2V_REQUESTS[case])
        # two chunks of 8 frames; one chunk that loses 3 frames when its motion is dropped
        assert_frames_close(frames, ref, 16 if case == "init_first_frame" else 5)

    def test_audio_rows_match_jax(self, s2v):
        with s2v.env("port"):
            s2v.carry()
        with s2v.env("jax"):
            ref, ref_chunks = s2v.jax.encode_audio(WAV_S2V, 16000, 8, 16)
        with s2v.env("port"):
            rows, chunks = s2v.port.encode_audio(WAV_S2V, 16000, 8, 16)
        assert chunks == ref_chunks == 3 and tuple(rows.shape) == ref.shape == (1, 3, 16, 24)
        assert_close(rows, np.asarray(ref))

    def test_default_widths_disagree_and_the_port_raises(self, s2v):
        """Without config files the engine builds the family defaults: a
        Wav2Vec2-base encoder (12 layers of 768: 13 states) against an S2V DiT
        that takes 25 states of 1280. The JAX DiT fails inside its audio
        encoder; the port raises before the DiT runs."""
        from apex_studio_tpu.models.audio.wav2vec2 import Wav2Vec2Config
        from apex_studio_tpu.models.transformers.wan_s2v import WanS2VConfig

        w2v, dit = Wav2Vec2Config(), WanS2VConfig()
        assert (w2v.num_hidden_layers + 1, w2v.hidden_size) == (13, 768)
        assert (dit.num_wav2vec_layers, dit.audio_dim) == (25, 1280)
        with s2v.env("port"):
            s2v.carry()
            cfg = s2v.port.transformer.cfg
            saved = cfg.audio_dim
            cfg.audio_dim = saved + 1
            try:
                with pytest.raises(ValueError, match="hidden states"):
                    s2v.port.encode_audio(WAV_S2V, 16000, 8, 16)
            finally:
                cfg.audio_dim = saved


MT_BASE = dict(prompt="two people talk", image=IMAGE, height=32, width=32, num_frames=5, motion_frames=3,
               num_inference_steps=2, fps=10, seed=4)
MT_REQUESTS = {
    "two_speakers_add_cfg": dict(MT_BASE, person_1_audio=WAV_1, person_2_audio=WAV_2, audio_type="add",
                                 negative_prompt="static", guidance_scale=2.0, audio_guidance_scale=2.5,
                                 color_correction_strength=0.5),
    "two_speakers_para": dict(MT_BASE, person_1_audio=WAV_1, person_2_audio=WAV_2, guidance_scale=1.0,
                              audio_guidance_scale=2.0, color_correction_strength=0.0, num_inference_steps=1),
    "one_speaker": dict(MT_BASE, audio=WAV_1, guidance_scale=1.0, audio_guidance_scale=2.0, num_inference_steps=1),
}


class TestMultiTalk:
    @pytest.mark.parametrize("case", list(MT_REQUESTS))
    def test_frames_match_jax(self, multitalk, case, monkeypatch):
        from apex_studio_tpu_torch.models.transformers import wan_multitalk

        monkeypatch.setattr(wan_multitalk, "REF_ATTN_ROWS", 7)  # ref_attn_maps in ragged chunks
        ref, frames = multitalk.run_jax(**MT_REQUESTS[case]), multitalk.run_port(**MT_REQUESTS[case])
        # 8 audio frames: a clip of 5, then one of 5 whose first 3 are the motion frames
        assert_frames_close(frames, ref, 7)

    def test_audio_stack_matches_jax(self, multitalk):
        with multitalk.env("port"):
            multitalk.carry()
        with multitalk.env("jax"):
            ref = np.asarray(multitalk.jax.encode_person_audio(WAV_1, 16000, 10))
        with multitalk.env("port"):
            stack = multitalk.port.encode_person_audio(WAV_1, 16000, 10)
        assert stack.shape == ref.shape == (8, 2, 16)
        assert_close(torch.from_numpy(stack), ref)

    @pytest.mark.parametrize("humans", [1, 2])
    def test_human_masks_and_colour_match_are_jax(self, multitalk, humans):
        np.testing.assert_array_equal(port_wan.WanMultiTalkEngine.human_masks(humans, 48, 64),
                                      multitalk.jax.human_masks(humans, 48, 64))
        from apex_studio_tpu.engine.wan import match_and_blend_colors as jax_match

        video, reference = RNG.uniform(-1, 1, (1, 3, 4, 6, 6)), RNG.uniform(-0.5, 0.8, (1, 3, 1, 6, 6))
        for strength in (0.0, 0.4, 1.0):
            np.testing.assert_allclose(port_wan.match_and_blend_colors(video, reference, strength),
                                       jax_match(video, reference, strength))


AVATAR_RUN = dict(image=IMAGE, audio=(WAV_1, 16000), prompt="talking head", negative_prompt="blurry", height=32,
                  width=32, num_frames=9, fps=25.0, num_inference_steps=11, guidance_scale=2.0,
                  frame_per_batch=17, shift_offset=3, seed=0, return_latents=True)


class TestAvatar:
    def test_latents_match_jax_across_step_10(self, avatar):
        ref, lat = np.asarray(avatar.run_jax(**AVATAR_RUN)), avatar.run_port(**AVATAR_RUN)
        # 9 frames → 5 latent frames kept of the 33 denoised as two rolling windows of 17
        assert tuple(lat.shape) == ref.shape == (1, 4, 5, 8, 8)
        assert_close(lat, ref, rel=1e-3)

    def test_frames_match_jax(self, avatar):
        run = dict(AVATAR_RUN, num_inference_steps=2, return_latents=False, shift_offset=1)
        ref, frames = avatar.run_jax(**run), avatar.run_port(**run)
        assert_frames_close(frames, ref, 9)

    def test_whisper_files_raise_and_none_give_zeros(self, avatar, tmp_path):
        """Without the manifest's ``audio_encoder`` files the features are
        zeros, as JAX computes them there; with files on disk the port
        raises (it has no Whisper encoder)."""
        with avatar.env("port"):
            avatar.carry()
            engine = avatar.port
            engine.component_specs["audio_encoder"] = {"type": "helper", "name": "audio_encoder",
                                                       "base": "whisper", "model_path": str(tmp_path / "whisper")}
            try:
                zeros = engine.audio_features((WAV_1, 16000), 9)
                assert zeros.shape == (9, 4, 2, 6) and not zeros.any()
                (tmp_path / "whisper").mkdir()
                with pytest.raises(NotImplementedError, match="Whisper"):
                    engine.audio_features((WAV_1, 16000), 9)
                feats = RNG.standard_normal((5, 4, 2, 6)).astype(np.float32)
                padded = engine.audio_features(feats, 9)
                assert padded.shape == (9, 4, 2, 6) and np.array_equal(padded[:5], feats) and not padded[5:].any()
                with pytest.raises(ValueError, match="DiT takes"):
                    engine.audio_features(np.zeros((9, 10, 5, 384), np.float32), 9)
            finally:
                del engine.component_specs["audio_encoder"]


@pytest.mark.parametrize("manifest,cls", [
    ("wan2.2-s2v-14b.yml", port_wan.WanS2VEngine), ("wan-2.1-14b-multitalk.yml", port_wan.WanMultiTalkEngine),
    ("wan-2.1-14b-infinitetalk.yml", port_wan.WanMultiTalkEngine), ("hunyuanvideo-avatar.yml", HunyuanAvatarEngine)])
def test_repository_manifests_resolve_to_the_ported_engines(manifest, cls, tmp_path, monkeypatch):
    monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path))
    engine = UniversalEngine(REPO / "manifests" / "video" / manifest, device="cpu")
    assert type(engine) is cls


def test_wav_file_audio(s2v, tmp_path):
    """A WAV file path reads as the same samples (16-bit PCM) on both sides."""
    path = tmp_path / "voice.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(WAV_S2V, -1, 1) * 32767).astype(np.int16).tobytes())
    run = dict(S2V_REQUESTS["init_first_frame"], audio=str(path), num_chunks=1, pose_video=None)
    ref, frames = s2v.run_jax(**run), s2v.run_port(**run)
    assert_frames_close(frames, ref, 8)
