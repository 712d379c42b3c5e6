"""The port's QwenImage engines end to end against the JAX package's, on the CPU.

The tiny manifest of tests/test_engine_qwenimage.py (a 2-block DiT 48 wide, a
2-layer Qwen2.5-VL, a Wan VAE with ``base_dim`` 8 and 2× space) set to fp32
runs through both ``UniversalEngine``s with the same seed; every component's
weights are carried from the JAX engine into the port, and each engine has
its own ``APEX_HOME_DIR`` (prompt encodes are disk-cached), and the encoders
stay resident between runs. 40 × 48 pixels
give a 20 × 24 latent and 10 × 12 = 120 packed tokens. Latents after the
steps: rel L2 ≤ 1e-4; frames within one uint8 level.

Cases: ``t2i`` without and with true CFG, ``edit`` with one image,
``edit_plus`` with two, and ``controlnet`` with true CFG and a
``control_guidance`` window that drops the branch from the last step. Also:
the seed contract, ``edit`` without an image, the attention calls a step, and
the encoder's release before the DiT runs.
"""

import copy

import numpy as np
import pytest
import torch
import yaml

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine.qwenimage import (
    QwenImageControlNetEngine,
    QwenImageEditEngine,
    QwenImageT2IEngine,
)
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from apex_studio_tpu_torch.ops.attention import attention_registry
from tests.test_engine_qwenimage import QWEN_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import assert_rel_l2, fast_jax_engine, jax_params

RUN = dict(prompt="hello world", height=40, width=48, num_inference_steps=2, true_cfg_scale=1.0, seed=7)
CFG_RUN = dict(RUN, negative_prompt="a cat", true_cfg_scale=3.0)
RNG = np.random.default_rng(0)
IMAGE = RNG.integers(0, 256, size=(50, 60, 3), dtype=np.uint8)
IMAGE_2 = RNG.integers(0, 256, size=(40, 40, 3), dtype=np.uint8)
EDIT_RUN = dict(RUN, prompt="make the sky purple", image=IMAGE)
CONTROL_RUN = dict(CFG_RUN, control_image=IMAGE, controlnet_conditioning_scale=0.8,
                   control_guidance_start=0.0, control_guidance_end=0.6, num_inference_steps=3)


def manifest(tmp_path, model_type):
    doc = copy.deepcopy(QWEN_TINY)
    doc["spec"]["model_type"] = model_type
    for comp in doc["spec"]["components"]:
        if comp["type"] != "scheduler":
            comp["precision"] = "fp32"
    if model_type == "controlnet":
        tf = next(c for c in doc["spec"]["components"] if c["type"] == "transformer")
        doc["spec"]["components"].append({"type": "transformer", "name": "controlnet", "precision": "fp32",
                                          "base": "qwenimage.controlnet", "config": {**tf["config"]}})
    path = tmp_path / f"qwenimage-{model_type}.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


def components(engine):
    for ctype in ("vae", "transformer", "text_encoder"):
        if getattr(engine, ctype) is None:
            engine.load_component_by_type(ctype)
    engine._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
    out = {"vae": engine.vae, "transformer": engine.transformer, "qwen2": engine.text_encoder._ensure_model()}
    if hasattr(engine, "_load_controlnet"):
        out["controlnet"] = engine._load_controlnet()
    return out


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
        tmp = tmp_path_factory.mktemp(f"qwenimage_{model_type}")
        with pytest.MonkeyPatch.context() as mp:
            yield Pair(manifest(tmp, model_type), tmp, mp)

    return fixture


t2i = pair_fixture("t2i")
edit = pair_fixture("edit")
controlnet = pair_fixture("controlnet")


def latents(pair, **kw):
    run = {**kw, "return_latents": True}
    return np.asarray(pair.run_jax(**run)), pair.run_port(**run)


def count_attention(monkeypatch):
    calls = []
    flash = attention_registry.get("flash")
    monkeypatch.setitem(attention_registry._entries, "flash",
                        lambda q, *a, **kw: calls.append((q.shape[1], kw.get("bias"))) or flash(q, *a, **kw))
    return calls


def test_resolves_the_engine_classes(t2i, edit, controlnet, tmp_path):
    assert type(t2i.port) is QwenImageT2IEngine and type(edit.port) is QwenImageEditEngine
    assert type(controlnet.port) is QwenImageControlNetEngine
    assert type(UniversalEngine(manifest(tmp_path, "edit_plus"), device="cpu")) is QwenImageEditEngine


@pytest.mark.parametrize("run", [RUN, CFG_RUN], ids=["no_cfg", "true_cfg"])
def test_t2i_latents_match_jax(t2i, run):
    ref, lat = latents(t2i, **run)
    assert lat.dtype == torch.float32 and tuple(lat.shape) == ref.shape == (1, 120, 16)
    assert_rel_l2(lat, ref, 1e-4)


def test_t2i_frames_within_one_level_and_cfg_changes_the_latents(t2i):
    ref, frames = t2i.run_jax(**CFG_RUN), t2i.run_port(**CFG_RUN)
    assert len(frames) == len(ref) == 1
    assert frames[0].shape == (40, 48, 3) and frames[0].dtype == np.uint8
    assert np.abs(frames[0].astype(int) - ref[0].astype(int)).max() <= 1
    plain, guided = (t2i.run_port(**run, return_latents=True) for run in (RUN, CFG_RUN))
    assert (guided - plain).abs().max() > 1e-3 * plain.abs().max()


@pytest.mark.parametrize("images", [IMAGE, [IMAGE, IMAGE_2]], ids=["edit", "edit_plus"])
def test_edit_latents_and_frames_match_jax(edit, images):
    run = dict(EDIT_RUN, image=images)
    ref, lat = latents(edit, **run)
    assert tuple(lat.shape) == ref.shape == (1, 120, 16)  # the condition tokens are sliced off
    assert_rel_l2(lat, ref, 1e-4)
    ref_frames, frames = edit.run_jax(**run), edit.run_port(**run)
    assert np.abs(frames[0].astype(int) - ref_frames[0].astype(int)).max() <= 1


def test_controlnet_with_window_and_cfg_matches_jax(controlnet):
    ref, lat = latents(controlnet, **CONTROL_RUN)
    assert_rel_l2(lat, ref, 1e-4)
    for change in ({"controlnet_conditioning_scale": 0.0}, {"control_guidance_end": 1.0}):
        other = controlnet.run_port(**{**CONTROL_RUN, **change, "return_latents": True})
        assert (other - lat).abs().max() > 1e-4 * lat.abs().max(), change


def test_edit_image_as_path_or_data_uri(edit, tmp_path):
    """A PNG path and a PNG data URI give the latents of the array."""
    import base64

    import cv2

    ok, png = cv2.imencode(".png", cv2.cvtColor(IMAGE, cv2.COLOR_RGB2BGR))
    (tmp_path / "source.png").write_bytes(png.tobytes())
    uri = "data:image/png;base64," + base64.b64encode(png.tobytes()).decode()
    run = dict(EDIT_RUN, num_inference_steps=1, return_latents=True)
    want = edit.run_port(**run)
    for image in (str(tmp_path / "source.png"), uri):
        assert torch.equal(edit.run_port(**{**run, "image": image}), want)


def test_seed_contract_and_missing_image(t2i, edit):
    a = t2i.run_port(**RUN, return_latents=True)
    b = t2i.run_port(**RUN, return_latents=True)
    c = t2i.run_port(**{**RUN, "seed": 8}, return_latents=True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="image"):
        edit.run_port(prompt="x", height=40, width=48, num_inference_steps=1)


@pytest.mark.parametrize("case,forwards,joint", [
    ("t2i", 1, [32 + 120]), ("t2i_cfg", 2, [32 + 120]), ("edit_plus", 1, [64 + 360]),
    ("controlnet", 2, [32 + 120])])
def test_attention_calls_a_step(t2i, edit, controlnet, monkeypatch, case, forwards, joint):
    """One unmasked joint launch a block: 2 DiT blocks, plus the ControlNet's
    2 under ``controlnet``. The t2i prompts fill one 32-token bucket, the
    edit prompt (its longer system message) a 64-token one."""
    pair, run, blocks = {
        "t2i": (t2i, RUN, 2), "t2i_cfg": (t2i, CFG_RUN, 2),
        "edit_plus": (edit, dict(EDIT_RUN, image=[IMAGE, IMAGE_2]), 2),
        "controlnet": (controlnet, dict(CONTROL_RUN, num_inference_steps=2), 4)}[case]
    pair.run_port(**run, return_latents=True)  # the prompts are cached after this run
    calls = count_attention(monkeypatch)
    pair.run_port(**run, return_latents=True)
    assert calls == [(joint[0], None)] * (blocks * forwards * run["num_inference_steps"])


def test_text_encoder_released_before_the_denoise(t2i, monkeypatch):
    te = t2i.port.text_encoder
    model = te.model
    monkeypatch.delenv("APEX_RELEASE_TEXT_ENCODERS")
    seen = []
    t2i.run_port(**RUN, return_latents=True,
                 progress_callback=lambda p, m, md: seen.append((m, te.model is None)))
    assert ("Prompts ready", True) in seen and te.model is None
    te.model = model
    t2i.run_port(**RUN, return_latents=True, offload=False)
    assert te.model is model
