"""The port's ZImage engines end to end against the JAX package's, on the CPU.

The tiny manifest of tests/test_engine_zimage.py (a 2-block DiT, a 2-layer
Qwen3, the tiny 4-channel AutoencoderKL) set to fp32 runs through both
``UniversalEngine``s with the same seed; every component's weights are
carried from the JAX engine into the port, and each engine has its own
``APEX_HOME_DIR`` (text encodes are disk-cached by prompt and config).
40×44 pixels give 10×11 = 110 image tokens, not a multiple of 32, so the
``x_pad_token`` path runs. Latents after the steps: max|Δ| ≤ 1e-3·max|ref|;
frames within one uint8 step.

Cases: t2i without CFG; CFG with the norm clamp and the time truncation both
active (each shown to change the latents); the control engine with a control
image, an inpaint image and a mask. Also: the seed contract, resolution
snapping, progress messages, previews only above 8 steps, and the attention
calls a step (one forward without CFG, two with).
"""

import copy

import numpy as np
import pytest
import torch
import yaml

from apex_studio_tpu.engine.base import BaseEngine as JaxBaseEngine
from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine.zimage import ZImageControlEngine, ZImageT2IEngine
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from apex_studio_tpu_torch.ops.attention import attention_registry
from tests.test_engine_zimage import TINY_MANIFEST, make_tokenizer
from tests.torch_port_helpers import assert_close, fast_jax_engine, jax_params

RUN = dict(prompt="hello world", height=40, width=44, num_inference_steps=2, guidance_scale=0.0, seed=7)
CFG_RUN = dict(RUN, negative_prompt="a cat", guidance_scale=4.0, cfg_normalization=1.0,
               cfg_truncation=0.3, num_inference_steps=3)
CONTROL = {"control_layers_places": [0], "control_refiner_layers_places": [0, 1], "control_in_dim": 9}
RNG = np.random.default_rng(0)
CONTROL_IMAGE = RNG.integers(0, 256, size=(50, 60, 3), dtype=np.uint8)
INPAINT_IMAGE = RNG.integers(0, 256, size=(40, 44, 3), dtype=np.uint8)
MASK_IMAGE = np.zeros((30, 30, 3), np.uint8)
MASK_IMAGE[5:20, 10:25] = 255


def manifest(tmp_path, control=False):
    doc = copy.deepcopy(TINY_MANIFEST)
    for comp in doc["spec"]["components"]:
        if comp["type"] != "scheduler":
            comp["precision"] = "fp32"
        if control and comp["type"] == "transformer":
            comp["base"] = "zimage.control"
            comp["config"].update(CONTROL)
    if control:
        doc["spec"]["model_type"] = "control"
    path = tmp_path / ("zimage-control.yml" if control else "zimage.yml")
    path.write_text(yaml.safe_dump(doc))
    return path


def components(engine):
    for ctype in ("vae", "transformer", "text_encoder"):
        if getattr(engine, ctype) is None:
            engine.load_component_by_type(ctype)
    engine._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
    return {"vae": engine.vae, "transformer": engine.transformer, "qwen3": engine.text_encoder._ensure_model()}


class Pair:
    """A JAX engine and a port engine on one manifest, the port carrying the
    JAX engine's weights."""

    def __init__(self, path, tmp_path, mp):
        mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
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


@pytest.fixture(scope="module")
def t2i(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zimage_t2i")
    with pytest.MonkeyPatch.context() as mp:
        yield Pair(manifest(tmp), tmp, mp)


@pytest.fixture(scope="module")
def control(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zimage_control")
    with pytest.MonkeyPatch.context() as mp:
        yield Pair(manifest(tmp, control=True), tmp, mp)


def latents(pair, **kw):
    run = {**kw, "return_latents": True}
    return np.asarray(pair.run_jax(**run)), pair.run_port(**run)


class TestT2I:
    def test_resolves_the_engine_class(self, t2i, control):
        assert type(t2i.port) is ZImageT2IEngine and type(control.port) is ZImageControlEngine

    def test_latents_match_jax(self, t2i):
        ref, lat = latents(t2i, **RUN)
        assert lat.dtype == torch.float32 and tuple(lat.shape) == ref.shape == (1, 4, 20, 22)
        assert_close(lat, ref, rel=1e-3)

    def test_frames_within_one_step(self, t2i):
        ref, frames = t2i.run_jax(**RUN), t2i.run_port(**RUN)
        assert len(frames) == len(ref) == 1
        assert frames[0].shape == (40, 44, 3) and frames[0].dtype == np.uint8
        assert np.abs(frames[0].astype(int) - ref[0].astype(int)).max() <= 1

    def test_cfg_with_clamp_and_truncation_matches_jax(self, t2i):
        ref, lat = latents(t2i, **CFG_RUN)
        assert_close(lat, ref, rel=1e-3)
        # both the clamp and the truncation are active in this run
        for change in ({"cfg_normalization": 0.0}, {"cfg_truncation": 1.0}):
            other = t2i.run_port(**{**CFG_RUN, **change, "return_latents": True})
            assert (other - lat).abs().max() > 1e-4 * lat.abs().max(), change

    def test_resolution_snapped_like_jax(self, t2i):
        kw = dict(prompt="hello", height=70, width=67, num_inference_steps=1, seed=1)
        ref, frames = t2i.run_jax(**kw), t2i.run_port(**kw)
        assert frames[0].shape == ref[0].shape == (68, 64, 3)

    def test_progress_matches_jax(self, t2i):
        seen = {"jax": [], "port": []}
        for name, run in (("jax", t2i.run_jax), ("port", t2i.run_port)):
            run(**RUN, progress_callback=lambda p, m, md, out=seen[name]: out.append((p, m)))
        assert seen["port"] == pytest.approx(seen["jax"])
        assert seen["port"][-1] == (1.0, "Completed text-to-image pipeline")

    def test_seed_contract(self, t2i):
        shape = (1, 4, 20, 22)
        for seed in (0, 7, 2**31 - 1):
            np.testing.assert_array_equal(t2i.port.get_latents(shape, seed=seed).numpy(),
                                          np.asarray(JaxBaseEngine.get_latents(shape, seed=seed)))
        a = t2i.run_port(**RUN, return_latents=True)
        b = t2i.run_port(**RUN, return_latents=True)
        c = t2i.run_port(**{**RUN, "seed": 8}, return_latents=True)
        assert torch.equal(a, b) and not torch.equal(a, c)

    @pytest.mark.parametrize("steps,previews", [(8, 0), (9, 2)])
    def test_previews_only_above_8_steps(self, t2i, steps, previews):
        shown = []
        t2i.run_port(**{**RUN, "num_inference_steps": steps}, render_on_step=True,
                     render_on_step_callback=lambda frames, i: shown.append((i, frames[0].shape)),
                     return_latents=True)
        assert shown == [(i, (40, 44, 3)) for i in (2, 5)][:previews]

    @pytest.mark.parametrize("run,forwards", [(RUN, 1), ({**CFG_RUN, "cfg_truncation": 1.0}, 2)])
    def test_attention_calls_a_step(self, t2i, monkeypatch, run, forwards):
        calls = []
        flash = attention_registry.get("flash")
        monkeypatch.setitem(attention_registry._entries, "flash",
                            lambda *a, **kw: calls.append(kw.get("bias")) or flash(*a, **kw))
        t2i.run_port(**run, return_latents=True)
        # 1 noise refiner + 1 context refiner + 2 layers a forward, unmasked
        assert calls == [None] * (4 * forwards * run["num_inference_steps"])


class TestControl:
    def test_latents_match_jax(self, control):
        kw = dict(RUN, control_image=CONTROL_IMAGE, image=INPAINT_IMAGE, mask_image=MASK_IMAGE,
                  control_context_scale=0.6)
        ref, lat = latents(control, **kw)
        assert tuple(lat.shape) == ref.shape == (1, 4, 20, 22)
        assert_close(lat, ref, rel=1e-3)
        plain = control.run_port(**RUN, return_latents=True)
        assert (plain - lat).abs().max() > 1e-4 * lat.abs().max()

    def test_control_image_alone_matches_jax(self, control):
        ref, lat = latents(control, **RUN, control_image=CONTROL_IMAGE)
        assert_close(lat, ref, rel=1e-3)
