"""The port's LTX-2 engines against the JAX package's, on the CPU in f32.

``LTX2_TINY`` (tests/test_engine_ltx2.py) made whole: Gemma-3 as the text
encoder with the connectors helper, the audio VAE and the vocoder, and a
``latent_upsampler`` for stage 2, every component carried from the JAX
engine. The four registered types share one build of each side (their
components and, on the JAX side, its compiled programs): ti2v (t2v with CFG
and no negative prompt, i2v at two image strengths), multimodal guidance
(STG on one block, the isolated-modality pass and the std rescale),
IC-LoRA (two keyframe images and a conditioning video) and keyframe
interpolation (four keyframes): latents and audio latents within 1e-4 rel
L2; a request with a negative prompt, the rescale and ``upsample`` through
stage 2, decoded: frames within one level and the waveform within 1e-3 of
max|ref|, at the vocoder's rate. The seed repeats bit for bit.
"""

import copy
import functools

import numpy as np
import pytest
import torch
import yaml

import apex_studio_tpu.models.ltx2_connectors  # noqa: F401  (the JAX registry does not import it)
from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu.models.registry import helper_registry as jax_helpers
from apex_studio_tpu.models.registry import vae_registry as jax_vaes
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine import ltx2 as port_engine
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from tests.test_engine_ltx2 import LTX2_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import assert_close, assert_rel_l2, fast_jax_engine, jax_params

GEMMA = {"text_config": dict(vocab_size=64, hidden_size=16, intermediate_size=24, num_hidden_layers=2,
                             num_attention_heads=2, num_key_value_heads=1, head_dim=8, sliding_window=4,
                             sliding_window_pattern=2, query_pre_attn_scalar=8, rope_scaling={"factor": 8.0})}
EXTRA = [
    {"type": "helper", "name": "connectors", "base": "ltx2.connectors",
     "config": dict(caption_channels=16, text_proj_in_factor=3, video_connector_num_attention_heads=2,
                    video_connector_attention_head_dim=8, video_connector_num_layers=1,
                    video_connector_num_learnable_registers=32, audio_connector_num_attention_heads=2,
                    audio_connector_attention_head_dim=8, audio_connector_num_layers=1,
                    audio_connector_num_learnable_registers=32)},
    {"type": "vae", "name": "audio_vae", "base": "ltx2audio",
     "config": {"base_channels": 8, "ch_mult": [1, 2, 4], "num_res_blocks": 1, "latent_channels": 4,
                "mel_bins": 16}},
    {"type": "helper", "name": "vocoder", "base": "ltx2.vocoder",
     "config": {"in_channels": 32, "hidden_channels": 16, "out_channels": 2, "upsample_kernel_sizes": [4, 4],
                "upsample_factors": [2, 2], "resnet_kernel_sizes": [3], "resnet_dilations": [[1, 3]]}},
    {"type": "helper", "name": "latent_upsampler", "base": "ltx2.upsampler",
     "config": {"in_channels": 4, "mid_channels": 32, "num_blocks_per_stage": 1}},
]
TYPES = {"ti2v": port_engine.LTX2TI2VEngine, "multimodal_guidance": port_engine.LTX2MultimodalGuidanceEngine,
         "ic_lora": port_engine.LTX2ICLoraEngine, "keyframe_interpolation": port_engine.LTX2KeyframeInterpolationEngine}
TEXT_LENGTH = 128
SHARED = ("text_encoder", "vae", "transformer", "scheduler", "helpers")


def manifest():
    """LTX2_TINY with Gemma-3, the connectors, the audio path and the upsampler, in f32."""
    doc = copy.deepcopy(LTX2_TINY)
    comps = doc["spec"]["components"]
    for comp in comps:
        if comp["type"] == "transformer":  # the audio VAE's tokens (z 4 × mel' 4) and Gemma's width
            comp["config"].update(audio_in_channels=16, audio_out_channels=16, caption_channels=16)
        if comp["type"] == "text_encoder":
            comp.update(base="Gemma3ForConditionalGeneration", config=GEMMA)
    comps += copy.deepcopy(EXTRA)
    for comp in comps:
        comp["precision"] = "fp32"
    return doc


def carry(jax_eng, port_eng):
    """Build the helpers on both sides and carry every JAX component into the port."""
    specs = jax_eng.component_specs
    jax_eng._get_connectors()
    jax_eng._get_upsampler()
    jax_eng.helpers["audio_vae"] = jax_eng._instantiate_family(jax_vaes, specs["audio_vae"], "ltx2_audio_vae")
    jax_eng.helpers["vocoder"] = jax_eng._instantiate_family(jax_helpers, specs["vocoder"], "ltx2_vocoder")
    port_eng._get_connectors()
    port_eng._get_upsampler()
    port_eng._helper("audio_vae", specs["audio_vae"], "ltx2_audio_vae", kind="vae")
    port_eng._helper("vocoder", specs["vocoder"], "ltx2_vocoder")
    load_from_jax(port_eng.text_encoder._ensure_model(), jax_params(jax_eng.text_encoder._ensure_model()))
    for name in ("transformer", "vae"):
        load_from_jax(getattr(port_eng, name), jax_params(getattr(jax_eng, name)))
    for name, helper in jax_eng.helpers.items():
        load_from_jax(port_eng.helpers[name], jax_params(helper))


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """{model type: (JAX engine, port engine)}, every type on the ti2v pair's components."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        root = tmp_path_factory.mktemp("ltx2")
        path = root / "ltx2.yml"
        path.write_text(yaml.safe_dump(manifest()))
        mp.setenv("APEX_HOME_DIR", str(root / "home_jax"))
        out = {}
        for model_type in TYPES:
            jax_eng = fast_jax_engine(JaxUniversalEngine(path, model_type=model_type))
            port_eng = UniversalEngine(path, model_type=model_type, device="cpu")
            if not out:
                for eng in (jax_eng, port_eng):
                    eng._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
                    for ctype in ("text_encoder", "vae", "transformer", "scheduler"):
                        eng.load_component_by_type(ctype)
                carry(jax_eng, port_eng)
            else:
                first_jax, first_port = out["ti2v"]
                for name in SHARED:
                    setattr(jax_eng, name, getattr(first_jax, name))
                    setattr(port_eng, name, getattr(first_port, name))
                jax_eng._jit_cache = first_jax._jit_cache
            for eng in (jax_eng, port_eng):  # prompts at 128 tokens (four register tiles), not 1024
                eng._encode_prompt = functools.partial(type(eng)._encode_prompt, eng, max_length=TEXT_LENGTH)
            out[model_type] = (jax_eng, port_eng)
        yield out, root, mp


RNG = np.random.default_rng(0)
IMAGE = RNG.integers(0, 256, size=(48, 40, 3), dtype=np.uint8)
KEY_0 = RNG.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
KEY_1 = RNG.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
CLIP = [RNG.integers(0, 256, size=(64, 64, 3), dtype=np.uint8) for _ in range(9)]
BASE = dict(prompt="sound of rain", height=64, width=64, num_frames=9, fps=24, num_inference_steps=2,
            guidance_scale=2.0, seed=0, return_latents=True)
REQUESTS = {
    "t2v_no_negative_prompt": ("ti2v", dict(BASE, return_audio_latents=True)),
    "i2v_pinned": ("ti2v", dict(BASE, image=IMAGE, seed=3, return_audio_latents=True)),
    "i2v_strength": ("ti2v", dict(BASE, image=IMAGE, image_strength=0.6, seed=3)),
    "multimodal_guidance": ("multimodal_guidance", dict(BASE, stg_blocks=[0], modality_scale=1.5,
                                                        guidance_rescale=0.5, return_audio_latents=True)),
    "ic_lora": ("ic_lora", dict(BASE, image=[KEY_0, KEY_1], image_pixel_frame_indices=[0, 8],
                                image_strengths=[1.0, 0.7], conditioning_video=CLIP,
                                conditioning_video_strength=0.8, seed=1)),
    # four keyframes: as many appended tokens as IC-LoRA's request, so the JAX side reuses its compiled step
    "keyframe_interpolation": ("keyframe_interpolation", dict(BASE, image=[KEY_0, KEY_1, KEY_0[::-1], KEY_1[:, ::-1]],
                                                              image_pixel_frame_indices=[0, 3, 5, 8],
                                                              image_strengths=[1.0, 0.9, 0.8, 1.0], seed=2)),
}


def run_pair(engines, model_type, kw):
    pairs, root, mp = engines
    jax_eng, port_eng = pairs[model_type]
    mp.setenv("APEX_HOME_DIR", str(root / "home_jax"))
    want = jax_eng.run(**kw)
    mp.setenv("APEX_HOME_DIR", str(root / "home_port"))
    return port_eng.run(**kw), want


@pytest.mark.parametrize("case", list(REQUESTS))
def test_latents_match_jax(engines, case):
    model_type, kw = REQUESTS[case]
    got, want = run_pair(engines, model_type, kw)
    assert type(engines[0][model_type][1]) is TYPES[model_type]
    got, want = (got, want) if kw.get("return_audio_latents") else ((got,), (want,))
    assert tuple(got[0].shape) == np.asarray(want[0]).shape == (1, 4, 2, 2, 2)
    for g, w in zip(got, want):
        assert_rel_l2(g, np.asarray(w), 1e-4)
    if case == "i2v_pinned":  # the first latent frame is the image's, whatever the seed
        again = engines[0][model_type][1].run(**dict(kw, seed=99))
        assert torch.equal(again[0][:, :, 0], got[0][:, :, 0])


def test_stage_two_frames_and_waveform_match_jax(engines):
    """A negative prompt, the rescale, then the upsampler and three distilled
    stage-2 steps at 128²; decoded to frames and a 24 kHz waveform."""
    kw = dict(BASE, negative_prompt="noise", guidance_rescale=0.5, upsample=True, return_latents=False)
    got, want = run_pair(engines, "ti2v", kw)
    assert len(got) == len(want) == 3
    frames, wave, rate = got
    assert rate == want[2] == 24000
    got_f, want_f = np.stack(frames).astype(np.int16), np.stack(want[0]).astype(np.int16)
    assert got_f.shape == want_f.shape == (9, 128, 128, 3)
    assert int(np.abs(got_f - want_f).max()) <= 1
    assert wave.shape == np.asarray(want[1]).shape and wave.shape[0] == 2
    assert_close(wave, np.asarray(want[1]), 1e-3)


def test_the_seed_repeats(engines):
    port = engines[0]["ti2v"][1]
    kw = dict(BASE, guidance_scale=1.0)
    first = port.run(**kw)
    assert torch.equal(first, port.run(**kw))
    assert not torch.equal(first, port.run(**dict(kw, seed=1)))
