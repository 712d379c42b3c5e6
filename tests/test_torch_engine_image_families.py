"""The port's other image engines end to end against the JAX package's, on
the CPU: Chroma t2i, Ovis-Image t2i, Bria FIBO ti2i and t2i, HiDream-I1 t2i
and edit, and HunyuanImage 2.1 t2i from its base and distilled manifests.

Each engine runs from its repository manifest (scheduler, encoders picked by
base and name, defaults) with every other component cut to the toy widths
of the JAX engine tests (tests/test_engine_{chroma,ovis,fibo,hidream,
hunyuanimage}.py) in fp32, the word-level test tokenizer in every text
encoder; every component's weights are carried from the JAX engine into the
port; each engine has its own ``APEX_HOME_DIR``. 2 steps at 32 × 32 pixels.

Latents after the steps: rel L2 ≤ 1e-3; frames within one uint8 level, mean
≤ 1e-3.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine import chroma as port_chroma
from apex_studio_tpu_torch.engine import fibo as port_fibo
from apex_studio_tpu_torch.engine import hidream as port_hidream
from apex_studio_tpu_torch.engine import hunyuanimage as port_hyi
from apex_studio_tpu_torch.engine import ovis as port_ovis
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from tests.test_engine_chroma import CHROMA_TINY
from tests.test_engine_fibo import FIBO_TINY
from tests.test_engine_hidream import HIDREAM_TINY
from tests.test_engine_hunyuanimage import HYI_TINY
from tests.test_engine_ovis import OVIS_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import assert_rel_l2, fast_jax_engine, jax_params

REPO = Path(__file__).resolve().parents[1]


def _tiny(manifest):
    """{component type or text-encoder name: its toy config}."""
    return {c.get("name") if c["type"] == "text_encoder" and "name" in c else c["type"]: c["config"]
            for c in manifest["spec"]["components"] if c["type"] != "scheduler"}


HIDREAM = _tiny(HIDREAM_TINY)
HYI = _tiny(HYI_TINY)
# case → (manifest, model type, toy configs by component type or text-encoder name)
CASES = {
    "chroma": ("chroma-hd-text-to-image.yml", "t2i", _tiny(CHROMA_TINY)),
    "ovis": ("ovis-image-t2i.yml", "t2i", _tiny(OVIS_TINY)),
    "fibo": ("fibo-ti2i.yml", "ti2i", _tiny(FIBO_TINY)),
    "fibo_t2i": ("fibo-ti2i.yml", "t2i", _tiny(FIBO_TINY)),
    "hidream": ("hidream-i1-full.yml", "t2i", HIDREAM),
    "hidream_edit": ("hidream-i1-full.yml", "edit", HIDREAM),
    "hunyuanimage": ("hunyuanimage-2.1.yml", "t2i", HYI),
    "hunyuanimage_distilled": ("hunyuanimage-2.1-distilled.yml", "t2i",
                               dict(HYI, transformer=dict(HYI["transformer"], guidance_embeds=True,
                                                          use_meanflow=True))),
}
ENGINES = {"chroma": port_chroma.ChromaT2IEngine, "ovis": port_ovis.OvisT2IEngine, "fibo": port_fibo.FiboTI2IEngine,
           "fibo_t2i": port_fibo.FiboTI2IEngine, "hidream": port_hidream.HiDreamT2IEngine,
           "hidream_edit": port_hidream.HiDreamT2IEngine, "hunyuanimage": port_hyi.HunyuanImageT2IEngine,
           "hunyuanimage_distilled": port_hyi.HunyuanImageT2IEngine}
IMAGE = np.random.default_rng(0).integers(0, 256, size=(40, 36, 3), dtype=np.uint8)
JSON_PROMPT = '{"short_description": "hello world", "style_medium": "photograph"}'
BASE = dict(height=32, width=32, num_inference_steps=2, seed=3)
REQUESTS = {
    "chroma": dict(BASE, prompt="hello world", negative_prompt="a cat", guidance_scale=4.0),
    "ovis": dict(BASE, prompt="hello world", negative_prompt="a cat", guidance_scale=5.0),
    "fibo": dict(BASE, prompt=JSON_PROMPT, guidance_scale=5.0),
    "fibo_t2i": dict(BASE, prompt="hello world", negative_prompt="a cat", guidance_scale=3.0),
    "hidream": dict(BASE, prompt="hello world", negative_prompt="a cat", guidance_scale=5.0),
    "hidream_edit": dict(BASE, prompt="hello world", negative_prompt="a cat", image=IMAGE, num_inference_steps=4,
                         image_strength=0.5),
    "hunyuanimage": dict(BASE, prompt='hello "world" a cat', negative_prompt="a cat", guidance_scale=3.5),
    "hunyuanimage_distilled": dict(BASE, prompt='hello "world"', guidance_scale=1.0, distilled_guidance_scale=3.25),
}
LATENTS = {"chroma": (1, 64, 16), "ovis": (1, 64, 16), "fibo": (1, 8, 16, 16), "fibo_t2i": (1, 8, 16, 16),
           "hidream": (1, 4, 16, 16), "hidream_edit": (1, 4, 16, 16), "hunyuanimage": (1, 4, 8, 8),
           "hunyuanimage_distilled": (1, 4, 8, 8)}


def manifest(tmp_path, case):
    """``case``'s repository manifest with toy components in fp32 and no
    weight files."""
    name, model_type, tiny = CASES[case]
    doc = yaml.safe_load((REPO / "manifests" / "image" / name).read_text())
    doc["spec"]["model_type"] = model_type
    for comp in doc["spec"]["components"]:
        if comp["type"] == "scheduler":
            continue
        comp.pop("config_path", None)
        comp.pop("model_path", None)
        comp["precision"] = "fp32"
        key = comp["name"] if comp["type"] == "text_encoder" and comp.get("name") in tiny else comp["type"]
        comp["config"] = copy.deepcopy(tiny[key])
    path = tmp_path / f"{case}.yml"
    path.write_text(yaml.safe_dump(doc))
    return path, model_type


def components(engine):
    """Every module of the engine by name, after loading it as its run does."""
    for spec in engine.component_specs.values():
        if spec.get("type") == "text_encoder":
            spec["tokenizer"] = make_tokenizer()
    if hasattr(engine, "text_encoders"):  # HiDream's four encoders
        engine.load_components(return_latents=True)
        encoders = engine.text_encoders
    else:
        if hasattr(engine, "load_text_encoders"):
            engine.load_text_encoders()
        for ctype in ("text_encoder", "transformer", "vae", "scheduler"):
            if getattr(engine, ctype) is None:
                engine.load_component_by_type(ctype)
        encoders = {"text_encoder": engine.text_encoder, "text_encoder_2": getattr(engine, "text_encoder_2", None)}
    out = {"vae": engine.vae, "transformer": engine.transformer}
    out.update({name: te._ensure_model() for name, te in encoders.items() if te is not None})
    return out


class Pair:
    def __init__(self, path, model_type, tmp_path, mp):
        mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        self.mp, self.tmp = mp, tmp_path
        self.mp.setenv("APEX_HOME_DIR", str(tmp_path / "home_jax"))
        self.jax = fast_jax_engine(JaxUniversalEngine(path, model_type=model_type))
        ref = components(self.jax)
        self.mp.setenv("APEX_HOME_DIR", str(tmp_path / "home_port"))
        self.port = UniversalEngine(path, model_type=model_type, device="cpu")
        got = components(self.port)
        assert sorted(got) == sorted(ref)
        for name, module in got.items():
            load_from_jax(module, jax_params(ref[name]))

    def run_jax(self, **kw):
        self.mp.setenv("APEX_HOME_DIR", str(self.tmp / "home_jax"))
        return self.jax.run(**kw)

    def run_port(self, **kw):
        self.mp.setenv("APEX_HOME_DIR", str(self.tmp / "home_port"))
        return self.port.run(**kw)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    made = {}
    with pytest.MonkeyPatch.context() as mp:
        def get(case):
            if case not in made:
                tmp = tmp_path_factory.mktemp(case)
                made[case] = Pair(*manifest(tmp, case), tmp, mp)
            return made[case]

        yield get


@pytest.mark.parametrize("case", list(LATENTS))
def test_latents_match_jax(pairs, case):
    pair = pairs(case)
    assert type(pair.port) is ENGINES[case]
    run = dict(REQUESTS[case], return_latents=True)
    ref = np.asarray(pair.run_jax(**run))
    got = pair.run_port(**run)
    assert tuple(got.shape) == ref.shape == LATENTS[case]
    assert_rel_l2(got, ref, 1e-3)


@pytest.mark.parametrize("case", ["chroma", "ovis", "fibo", "hidream_edit", "hunyuanimage"])
def test_frames_match_jax(pairs, case):
    pair = pairs(case)
    ref, frames = pair.run_jax(**REQUESTS[case]), pair.run_port(**REQUESTS[case])
    assert len(frames) == len(ref) == 1
    got, want = frames[0].astype(np.float64) / 255.0, np.asarray(ref[0]).astype(np.float64) / 255.0
    assert got.shape == want.shape == (32, 32, 3) and frames[0].dtype == np.uint8
    assert np.abs(got - want).max() <= 1 / 255 + 1e-9 and np.abs(got - want).mean() <= 1e-3


def test_conditioning_matches_jax(pairs):
    """The encoders' outputs the DiTs take: Ovis's cropped, zeroed Qwen3
    states, FIBO's layer split and default negative, HiDream's pooled CLIPs
    and Llama split, HunyuanImage's Qwen2.5-VL crop and byT5 glyph branch."""
    ovis = pairs("ovis")
    ovis.mp.setenv("APEX_HOME_DIR", str(ovis.tmp / "home_port"))
    assert_rel_l2(ovis.port.encode_prompt("hello world", 8), np.asarray(ovis.jax.encode_prompt("hello world", 8)), 1e-5)

    fibo = pairs("fibo")
    got, want = fibo.port.encode_prompt("hello world", 16), fibo.jax.encode_prompt("hello world", 16)
    assert len(got[1]) == len(want[1]) == 3
    for g, w in zip([got[0], *got[1]], [want[0], *want[1]]):
        assert_rel_l2(g, np.asarray(w), 1e-5)
    assert port_fibo.default_negative_prompt({"style_medium": "Photograph"}).startswith("{'style_medium'")

    hidream = pairs("hidream")
    got, want = hidream.port.encode_prompt("hello world"), hidream.jax.encode_prompt("hello world")
    assert len(got[1]) == len(want[1]) == 2 and tuple(got[2].shape) == (1, 16)
    for g, w in zip([got[0], *got[1], got[2]], [want[0], *want[1], want[2]]):
        assert_rel_l2(g, np.asarray(w), 1e-5)

    hyi = pairs("hunyuanimage")
    for prompt in ('hello "world"', "hello world"):
        got = (*hyi.port._encode_mllm(prompt), *hyi.port._encode_byt5(prompt))
        want = (*hyi.jax._encode_mllm(prompt), *hyi.jax._encode_byt5(prompt))
        assert tuple(got[0].shape) == (1, 1000, 32)
        for g, w in zip(got, want):
            assert_rel_l2(g.float(), np.asarray(w, np.float64), 1e-5)
        assert bool(got[3].any()) == ('"' in prompt)


def test_apg_mix_matches_jax():
    from apex_studio_tpu.engine.hunyuanimage import apg_mix as jax_apg_mix

    rng = np.random.default_rng(5)
    cond, uncond = (rng.normal(size=(1, 4, 8, 8)).astype(np.float32) for _ in range(2))
    for eta, threshold in ((0.0, 10.0), (0.3, 1.0), (1.0, 0.0)):
        want = np.asarray(jax_apg_mix(cond, uncond, 3.5, eta, threshold))
        got = port_hyi.apg_mix(torch.from_numpy(cond), torch.from_numpy(uncond), 3.5, eta, threshold)
        assert_rel_l2(got, want, 1e-6)


def test_manifests_resolve_to_the_ported_engines():
    """The six manifests of the slice resolve in the port, HiDream and FIBO
    for both their model types."""
    from apex_studio_tpu_torch.engine.registry import resolve_engine_class

    want = {"chroma-hd-text-to-image.yml": {"t2i": port_chroma.ChromaT2IEngine},
            "ovis-image-t2i.yml": {"t2i": port_ovis.OvisT2IEngine},
            "fibo-ti2i.yml": {"ti2i": port_fibo.FiboTI2IEngine, "t2i": port_fibo.FiboTI2IEngine},
            "hidream-i1-full.yml": {"t2i": port_hidream.HiDreamT2IEngine, "edit": port_hidream.HiDreamT2IEngine},
            "hunyuanimage-2.1.yml": {"t2i": port_hyi.HunyuanImageT2IEngine},
            "hunyuanimage-2.1-distilled.yml": {"t2i": port_hyi.HunyuanImageT2IEngine}}
    for name, types in want.items():
        doc = yaml.safe_load((REPO / "manifests" / "image" / name).read_text())
        for model_type, cls in types.items():
            assert resolve_engine_class(doc["spec"]["engine"], model_type) is cls, (name, model_type)
