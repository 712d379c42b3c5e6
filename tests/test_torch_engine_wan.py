"""The port's Wan engines end to end against the JAX package's, on the CPU.

The three Wan 2.2 A14B manifests (``image/wan-2.2-a14b-text-to-image.yml``,
``video/wan-2.2-a14b-text-to-video.yml``, ``video/wan2.2-a14b-image-to-video.yml``)
run through both ``UniversalEngine``s with their own schedulers (FlowUniPC,
shift 5 or 12) and both experts, every other component cut to the toy widths
of tests/test_engine_wan.py's ``WAN_TINY`` (a 1-block DiT, 2 heads of 24; a
1-layer UMT5 with a per-layer bias; a Wan VAE with ``base_dim`` 8, 4 latent
channels, 2× in space and time) in fp32. Every component's weights are carried
from the JAX engine into the port; each engine has its own ``APEX_HOME_DIR``
(prompt encodes are disk-cached) and the encoders stay resident between runs.
32 × 32 pixels and 5 frames give 3 latent frames of 16 × 16 and 192 tokens.
Latents after the steps: rel L2 ≤ 1e-3; frames in [0, 1]: max|Δ| ≤ one uint8
level and mean|Δ| ≤ 1e-3.

Cases: t2v with CFG and the expert switch at the manifest's boundary (3 steps
at shift 12: two high-noise, one low-noise), t2i (4 steps at shift 5: two and
two), i2v with a seeded image, EasyCache step skipping, the Euler and the
host-stepped schedulers, the tiled decode, frame-count snapping and the seed
contract. Also:
the UMT5 encode with zeroed padding, the steps each expert takes, the kernel
calls a step, the encoder's release, and the i2v engine's refusal of a
CLIP-vision transformer whose manifest has no image encoder.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine.wan import WanI2VEngine, WanT2IEngine, WanT2VEngine
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from apex_studio_tpu_torch.ops.attention import attention_registry
from tests.test_engine_wan import WAN_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import assert_rel_l2, fast_jax_engine, jax_params

REPO = Path(__file__).resolve().parents[1]
MANIFESTS = {"t2i": "image/wan-2.2-a14b-text-to-image.yml", "t2v": "video/wan-2.2-a14b-text-to-video.yml",
             "i2v": "video/wan2.2-a14b-image-to-video.yml"}
TINY = {c["type"]: c["config"] for c in WAN_TINY["spec"]["components"] if c["type"] != "scheduler"}
# the manifests' run defaults: CFG 4.0 on the high-noise expert, 3.0 on the low
A14B = dict(guidance_scale=4.0, guidance_scale_2=3.0, boundary_ratio=0.875)
T2V = dict(A14B, prompt="hello world", negative_prompt="a cat", height=32, width=32, num_frames=5,
           num_inference_steps=3, seed=3)
T2I = dict(A14B, prompt="hello world", negative_prompt="a cat", height=32, width=32, num_inference_steps=4,
           seed=1)
IMAGE = np.random.default_rng(0).integers(0, 256, size=(40, 36, 3), dtype=np.uint8)
I2V = dict(T2V, image=IMAGE)
PLAIN = dict(prompt="hello", height=32, width=32, num_frames=5, num_inference_steps=4, guidance_scale=1.0,
             seed=5)
LAT = (1, 4, 3, 16, 16)


def manifest(tmp_path, model_type, transformer=None):
    """The A14B manifest of ``model_type`` with toy components in fp32 and no
    weight files. The i2v DiT takes 4 noise + 2 mask + 4 condition channels
    (the toy VAE packs 2 frames a latent frame)."""
    doc = yaml.safe_load((REPO / "manifests" / MANIFESTS[model_type]).read_text())
    tf = dict(TINY["transformer"], in_channels=10 if model_type == "i2v" else 4, **(transformer or {}))
    for comp in doc["spec"]["components"]:
        if comp["type"] == "scheduler":
            continue
        comp.pop("config_path", None)
        comp.pop("model_path", None)
        comp["precision"] = "fp32"
        comp["config"] = copy.deepcopy(tf if comp["type"] == "transformer" else TINY[comp["type"]])
    path = tmp_path / f"wan-{model_type}.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


def components(engine):
    for ctype in ("vae", "scheduler", "text_encoder"):
        if getattr(engine, ctype) is None:
            engine.load_component_by_type(ctype)
    engine.load_components(return_latents=True)
    engine._load_transformer_2()
    engine._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
    return {"vae": engine.vae, "transformer": engine.transformer, "transformer_2": engine.transformer_2,
            "umt5": engine.text_encoder._ensure_model()}


class Pair:
    """A JAX engine and a port engine on one manifest, the port carrying the
    JAX engine's weights."""

    def __init__(self, path, tmp_path, mp):
        mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        # a released encoder would be rebuilt from its own random weights, not
        # the carried ones; the release itself is tested below
        mp.setenv("APEX_RELEASE_TEXT_ENCODERS", "0")
        self.mp, self.tmp = mp, tmp_path
        self.mp.setenv("APEX_HOME_DIR", str(tmp_path / "home_jax"))
        self.jax = fast_jax_engine(JaxUniversalEngine(path))
        ref = components(self.jax)
        self.mp.setenv("APEX_HOME_DIR", str(tmp_path / "home_port"))
        self.port = UniversalEngine(path, device="cpu")
        for name, module in components(self.port).items():
            load_from_jax(module, jax_params(ref[name]))

    def run_jax(self, **kw):
        self.mp.setenv("APEX_HOME_DIR", str(self.tmp / "home_jax"))
        return self.jax.run(**kw)

    def run_port(self, **kw):
        self.mp.setenv("APEX_HOME_DIR", str(self.tmp / "home_port"))
        return self.port.run(**kw)


def pair_fixture(model_type):
    @pytest.fixture(scope="module")
    def fixture(tmp_path_factory):
        tmp = tmp_path_factory.mktemp(f"wan_{model_type}")
        with pytest.MonkeyPatch.context() as mp:
            yield Pair(manifest(tmp, model_type), tmp, mp)

    return fixture


t2v = pair_fixture("t2v")
t2i = pair_fixture("t2i")
i2v = pair_fixture("i2v")


def latents(pair, **kw):
    run = {**kw, "return_latents": True}
    return np.asarray(pair.run_jax(**run)), pair.run_port(**run)


def assert_frames_close(frames, ref):
    assert len(frames) == len(ref)
    got = np.stack(frames).astype(np.float64) / 255.0
    want = np.stack(ref).astype(np.float64) / 255.0
    assert got.shape == want.shape and frames[0].dtype == np.uint8
    assert np.abs(got - want).max() <= 1 / 255 + 1e-9 and np.abs(got - want).mean() <= 1e-3


def expert_forwards(monkeypatch, engine):
    """Forward calls of each expert, in order ("high" / "low")."""
    calls = []
    for name, tag in (("transformer", "high"), ("transformer_2", "low")):
        module = getattr(engine, name)
        forward = module.forward
        monkeypatch.setattr(module, "forward", lambda *a, _f=forward, _t=tag, **k: calls.append(_t) or _f(*a, **k))
    return calls


def test_resolves_the_engine_classes(t2v, t2i, i2v):
    assert type(t2v.port) is WanT2VEngine and type(t2i.port) is WanT2IEngine and type(i2v.port) is WanI2VEngine


def test_umt5_encode_zeroes_the_padding(t2v):
    t2v.mp.setenv("APEX_HOME_DIR", str(t2v.tmp / "home_jax"))
    ref = np.asarray(t2v.jax.encode_prompt("hello world"))
    t2v.mp.setenv("APEX_HOME_DIR", str(t2v.tmp / "home_port"))
    got = t2v.port.encode_prompt("hello world")
    assert tuple(got.shape) == ref.shape == (1, 512, 32)
    assert_rel_l2(got, ref, 1e-4)
    assert not got[0, 2:].any() and got[0, :2].abs().min() > 0  # two tokens, then zeros


def test_t2v_with_cfg_and_the_expert_switch_matches_jax(t2v, monkeypatch):
    ref, lat = latents(t2v, **T2V)
    assert tuple(lat.shape) == ref.shape == LAT
    assert_rel_l2(lat, ref, 1e-3)
    calls = expert_forwards(monkeypatch, t2v.port)
    frames = t2v.run_port(**T2V)
    # t = 999, 959, 856 at shift 12: two steps above 875, one below; CFG doubles each
    assert calls == ["high"] * 4 + ["low"] * 2
    assert_frames_close(frames, t2v.run_jax(**T2V))
    assert len(frames) == 5 and frames[0].shape == (32, 32, 3)


def test_t2i_two_and_two_steps_matches_jax(t2i, monkeypatch):
    ref, lat = latents(t2i, **T2I)
    assert tuple(lat.shape) == ref.shape == (1, 4, 1, 16, 16)
    assert_rel_l2(lat, ref, 1e-3)
    calls = expert_forwards(monkeypatch, t2i.port)
    frames = t2i.run_port(**T2I)
    assert calls == ["high"] * 4 + ["low"] * 4  # t = 999, 937 | 833, 624 at shift 5
    # one frame (the Wan VAE's T = 1 decode is held against JAX in test_torch_wan_vae.py)
    assert len(frames) == 1 and frames[0].shape == (32, 32, 3) and frames[0].dtype == np.uint8


def test_i2v_matches_jax(i2v):
    ref, lat = latents(i2v, **I2V)
    assert tuple(lat.shape) == ref.shape == LAT
    assert_rel_l2(lat, ref, 1e-3)
    assert_frames_close(i2v.run_port(**I2V), i2v.run_jax(**I2V))


def test_i2v_condition_matches_jax(i2v):
    want = np.asarray(i2v.jax.build_condition(IMAGE, 5, 32, 32))
    got = i2v.port.build_condition(IMAGE, 5, 32, 32)
    assert tuple(got.shape) == want.shape == (1, 6, 3, 16, 16)
    np.testing.assert_array_equal(got[:, :2].numpy(), want[:, :2])  # the frame mask
    assert_rel_l2(got[:, 2:], want[:, 2:], 1e-4)


def test_easycache_matches_jax(t2v, monkeypatch):
    run = dict(PLAIN, easy_cache_thresh=0.05, easy_cache_ret_steps=1)
    ref, lat = latents(t2v, **run)
    assert_rel_l2(lat, ref, 1e-3)
    calls = expert_forwards(monkeypatch, t2v.port)
    t2v.run_port(**run, return_latents=True)
    assert 2 <= len(calls) < 4  # the first and last steps always compute


class HostStepped:
    """The scheduler without ``fused_plan``: the engines step it on the host."""

    def __init__(self, scheduler):
        self.__dict__["_s"] = scheduler

    def __getattr__(self, name):
        if name == "fused_plan":
            raise AttributeError(name)
        return getattr(self.__dict__["_s"], name)


@pytest.mark.parametrize("kind", ["euler", "host"])
def test_other_step_kinds_match_jax(t2v, kind):
    from apex_studio_tpu.schedulers import create_scheduler as jax_scheduler
    from apex_studio_tpu_torch.schedulers import create_scheduler

    saved = t2v.jax.scheduler, t2v.port.scheduler
    if kind == "euler":
        cfg = {"num_train_timesteps": 1000, "shift": 3.0}
        t2v.jax.scheduler = jax_scheduler("FlowMatchEulerDiscreteScheduler", cfg)
        t2v.port.scheduler = create_scheduler("FlowMatchEulerDiscreteScheduler", cfg)
    else:
        t2v.jax.scheduler, t2v.port.scheduler = HostStepped(saved[0]), HostStepped(saved[1])
    try:
        ref, lat = latents(t2v, **dict(PLAIN, negative_prompt="a cat", guidance_scale=3.0))
    finally:
        t2v.jax.scheduler, t2v.port.scheduler = saved
    assert_rel_l2(lat, ref, 1e-3)


def test_tiled_decode_matches_jax(t2v, monkeypatch):
    """The decode in tiles, as the engines take it above 48 × 48 latent
    pixels (60 × 104 at 480×832): here the 16 × 16 latent over a threshold of
    100 pixels, in tiles of 8 with 2 of overlap, both packages reading the
    same environment."""
    monkeypatch.setenv("APEX_VAE_TILE_THRESHOLD", "100")
    monkeypatch.setenv("APEX_VAE_TILE", "8")
    run = dict(PLAIN, num_inference_steps=1)
    assert_frames_close(t2v.run_port(**run), t2v.run_jax(**run))


def test_frame_snapping_and_seed_contract(t2v):
    frames = t2v.run_port(**dict(PLAIN, num_frames=6, num_inference_steps=1))
    assert len(frames) == 5  # 6 frames snap to 2k + 1 = 5 with the toy VAE's 2× time
    a = t2v.run_port(**PLAIN, return_latents=True)
    b = t2v.run_port(**PLAIN, return_latents=True)
    c = t2v.run_port(**{**PLAIN, "seed": 6}, return_latents=True)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("guidance,forwards", [(1.0, 1), (4.0, 2)], ids=["no_cfg", "cfg"])
def test_attention_calls_a_step(t2v, monkeypatch, guidance, forwards):
    """Two unmasked launches a block and forward: self-attention over the 192
    tokens, cross-attention over the 512 text rows."""
    run = dict(PLAIN, negative_prompt="a cat", guidance_scale=guidance, num_inference_steps=2,
               return_latents=True)
    t2v.run_port(**run)  # the prompts are cached after this run
    calls = []
    flash = attention_registry.get("flash")
    monkeypatch.setitem(attention_registry._entries, "flash",
                        lambda q, k, *a, **kw: calls.append((q.shape[1], k.shape[1], kw.get("bias")))
                        or flash(q, k, *a, **kw))
    t2v.run_port(**run)
    assert calls == [(192, 192, None), (192, 512, None)] * (forwards * 2)


def test_text_encoder_released_before_the_dit_loads(t2v, monkeypatch):
    te = t2v.port.text_encoder
    model = te.model
    monkeypatch.delenv("APEX_RELEASE_TEXT_ENCODERS")
    seen = []
    t2v.run_port(**PLAIN, return_latents=True,
                 progress_callback=lambda p, m, *a: seen.append((m, te.model is None)))
    assert ("Prompts ready", True) in seen and te.model is None
    te.model = model


def test_i2v_refuses_a_clip_vision_transformer(tmp_path, monkeypatch):
    """A DiT with a CLIP-vision branch needs the manifest's image encoder:
    the A14B manifest has none (the Wan 2.1 i2v path, with one, is held in
    tests/test_torch_engine_wan_edit.py)."""
    monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
    monkeypatch.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
    engine = UniversalEngine(manifest(tmp_path, "i2v", {"image_dim": 16, "added_kv_proj_dim": 48}),
                             device="cpu")
    engine._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
    with pytest.raises(KeyError, match="no helper component named 'image_encoder'"):
        engine.run(**I2V)
