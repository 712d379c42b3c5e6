"""The port's LongCat-Video (all seven types), Cosmos Predict2 (i2v, v2v) and
Kandinsky 5 (t2v, i2v) engines end to end against the JAX package's, on the
CPU.

Each family runs from its repository manifest (scheduler, encoders picked by
base, defaults) with every other component cut to the toy widths of the JAX
engine tests (tests/test_engine_{longcat,cosmos2,kandinsky5}.py; Kandinsky's
HunyuanVideo VAE at tests/test_engine_hunyuanvideo.py's) in fp32, the
word-level test tokenizer in every text encoder; every component's weights
are carried from the JAX engine into the port. The engines of one family
share its components, one ``APEX_HOME_DIR`` a side, and on the JAX side one
jit cache. 2 steps at 32 × 32 pixels.

The latents each request hands its decode (every segment's, for long_video
and interactive) or returns: rel L2 ≤ 1e-3. Also the i2v conditioning
pinned, the manifests resolving to the ported engines, and the reference
faults the port raises on before its DiT runs.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine import cosmos2 as port_cosmos2
from apex_studio_tpu_torch.engine import kandinsky5 as port_k5
from apex_studio_tpu_torch.engine import longcat as port_longcat
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from tests.test_engine_cosmos2 import COSMOS_TINY
from tests.test_engine_hunyuanvideo import HYV_ORIG_TINY
from tests.test_engine_kandinsky5 import K5_TINY
from tests.test_engine_longcat import LONGCAT_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import assert_rel_l2, fast_jax_engine, jax_params

REPO = Path(__file__).resolve().parents[1]
VIDEO = REPO / "manifests" / "video"


def _tiny(manifest):
    """{component type or text-encoder name: its toy config}."""
    return {c.get("name") if c["type"] == "text_encoder" and "name" in c else c["type"]: c["config"]
            for c in manifest["spec"]["components"] if c["type"] != "scheduler"}


K5 = dict(_tiny(K5_TINY), vae=_tiny(HYV_ORIG_TINY)["vae"])
# family → (manifest, toy configs by component type or text-encoder name)
FAMILIES = {
    "longcat": ("longcat-video-t2v.yml", _tiny(LONGCAT_TINY)),
    "cosmos2": ("cosmos-predict2-2b-video2world.yml", _tiny(COSMOS_TINY)),
    "kandinsky5": ("kandinsky5-t2v.yml", K5),
    "kandinsky5_visual_cond": ("kandinsky5-t2v.yml", dict(K5, transformer=dict(K5["transformer"], visual_cond=True))),
}
RNG = np.random.default_rng(0)
IMAGE = RNG.integers(0, 256, size=(40, 36, 3), dtype=np.uint8)
CLIP5 = [RNG.integers(0, 256, size=(32, 32, 3), dtype=np.uint8) for _ in range(5)]
CLIP9 = [RNG.integers(0, 256, size=(32, 32, 3), dtype=np.uint8) for _ in range(9)]
SMALL3 = [RNG.integers(0, 256, size=(16, 16, 3), dtype=np.uint8) for _ in range(3)]
BASE = dict(height=32, width=32, num_inference_steps=2, seed=3)
LONG = dict(BASE, num_frames=5, num_cond_frames=3, guidance_scale=4.0, negative_prompt="a cat")
# case → (family, model type, request, latents handed to each decode or returned)
CASES = {
    "longcat_t2v": ("longcat", "t2v", dict(LONG, prompt="hello world"), [(1, 4, 3, 16, 16)]),
    "longcat_i2v": ("longcat", "i2v", dict(LONG, prompt="hello world", image=IMAGE), [(1, 4, 3, 16, 16)]),
    "longcat_vc": ("longcat", "vc", dict(LONG, prompt="hello world", video=CLIP5), [(1, 4, 5, 16, 16)]),
    "longcat_continuation": ("longcat", "continuation", dict(LONG, prompt="hello world", video=CLIP9, source_fps=30,
                                                             use_kv_cache=False), [(1, 4, 5, 16, 16)]),
    "longcat_long_video": ("longcat", "long_video", dict(LONG, prompt="hello world", num_segments=1),
                           [(1, 4, 3, 16, 16), (1, 4, 5, 16, 16)]),
    "longcat_interactive": ("longcat", "interactive", dict(LONG, prompt="hello world. a cat!"),
                            [(1, 4, 3, 16, 16), (1, 4, 5, 16, 16)]),
    "longcat_refine": ("longcat", "refine", dict(BASE, prompt="hello", video=SMALL3), [(1, 4, 4, 16, 16)]),
    "cosmos2_i2v": ("cosmos2", "i2v", dict(BASE, prompt="hello world", negative_prompt="a cat", image=IMAGE,
                                          num_frames=5, guidance_scale=3.0), [(1, 4, 3, 16, 16)]),
    "cosmos2_v2v": ("cosmos2", "v2v", dict(BASE, prompt="hello world", video=CLIP5[:3], num_frames=5,
                                          conditioning_frames=3, guidance_scale=1.0), [(1, 4, 3, 16, 16)]),
    "kandinsky5_t2v": ("kandinsky5", "t2v", dict(BASE, prompt="hello world", negative_prompt="a cat",
                                                num_frames=5, guidance_scale=5.0), [(1, 4, 3, 8, 8)]),
    "kandinsky5_i2v": ("kandinsky5_visual_cond", "i2v", dict(BASE, prompt="hello world", image=IMAGE, num_frames=5,
                                                            guidance_scale=5.0), [(1, 4, 3, 8, 8)]),
}
ENGINES = {"t2v": port_longcat.LongCatT2VEngine, "i2v": port_longcat.LongCatI2VEngine,
           "vc": port_longcat.LongCatVCEngine, "continuation": port_longcat.LongCatContinuationEngine,
           "long_video": port_longcat.LongCatLongVideoEngine, "interactive": port_longcat.LongCatInteractiveEngine,
           "refine": port_longcat.LongCatRefineEngine}
# the latents an engine hands its decode, or returns with return_latents
RETURNS_LATENTS = {"cosmos2", "kandinsky5", "kandinsky5_visual_cond"}


def manifest(tmp_path, family):
    """The family's repository manifest with toy components in fp32 and no
    weight files."""
    name, tiny = FAMILIES[family]
    doc = yaml.safe_load((VIDEO / name).read_text())
    for comp in doc["spec"]["components"]:
        if comp["type"] == "scheduler":
            continue
        comp.pop("config_path", None)
        comp.pop("model_path", None)
        comp["precision"] = "fp32"
        key = comp["name"] if comp["type"] == "text_encoder" and comp.get("name") in tiny else comp["type"]
        comp["config"] = copy.deepcopy(tiny[key])
    path = tmp_path / f"{family}.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


def components(engine):
    """Every module of the engine by name, after loading it as its run does."""
    for spec in engine.component_specs.values():
        if spec.get("type") == "text_encoder":
            spec["tokenizer"] = make_tokenizer()
    if hasattr(engine, "load_text_encoders"):
        engine.load_text_encoders()
    for ctype in ("text_encoder", "transformer", "vae", "scheduler"):
        if getattr(engine, ctype) is None:
            engine.load_component_by_type(ctype)
    out = {"vae": engine.vae, "transformer": engine.transformer, "text_encoder": engine.text_encoder._ensure_model()}
    if getattr(engine, "text_encoder_2", None) is not None:
        out["text_encoder_2"] = engine.text_encoder_2._ensure_model()
    return out


def share(src, dst):
    """``dst`` (another model type's engine) takes ``src``'s components."""
    for name in ("text_encoder", "text_encoder_2", "transformer", "vae", "scheduler"):
        if hasattr(src, name):
            setattr(dst, name, getattr(src, name))
    return dst


class Family:
    """One family's JAX and port engines over the same carried weights."""

    def __init__(self, family, tmp_path, mp):
        mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        self.mp, self.tmp, self.path = mp, tmp_path, manifest(tmp_path, family)
        self.engines = {}
        mt = yaml.safe_load(self.path.read_text())["spec"]["model_type"]
        first = mt[0] if isinstance(mt, list) else mt
        self.mp.setenv("APEX_HOME_DIR", str(tmp_path / "home_jax"))
        self.jax = fast_jax_engine(JaxUniversalEngine(self.path, model_type=first))
        ref = components(self.jax)
        self.mp.setenv("APEX_HOME_DIR", str(tmp_path / "home_port"))
        self.port = UniversalEngine(self.path, model_type=first, device="cpu")
        got = components(self.port)
        assert sorted(got) == sorted(ref)
        for name, module in got.items():
            load_from_jax(module, jax_params(ref[name]))

    def pair(self, model_type):
        """(JAX engine, port engine) of ``model_type``: the family's
        components, the JAX side's jit cache shared, each decode's latents
        recorded in ``decoded``."""
        if model_type not in self.engines:
            jax_eng = share(self.jax, JaxUniversalEngine(self.path, model_type=model_type))
            jax_eng._jit_cache = self.jax._jit_cache
            port_eng = share(self.port, UniversalEngine(self.path, model_type=model_type, device="cpu"))
            for eng in (jax_eng, port_eng):
                if hasattr(eng, "decode_video"):
                    eng.decoded = []
                    decode = eng.decode_video

                    def observed(z, eng=eng, decode=decode):
                        eng.decoded.append(np.asarray(z.float() if isinstance(z, torch.Tensor) else z))
                        return decode(z)

                    eng.decode_video = observed
            self.engines[model_type] = (jax_eng, port_eng)
        return self.engines[model_type]

    def run(self, side, engine, **kw):
        self.mp.setenv("APEX_HOME_DIR", str(self.tmp / f"home_{side}"))
        if hasattr(engine, "decoded"):
            engine.decoded.clear()
        return engine.run(**kw)


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    made = {}
    with pytest.MonkeyPatch.context() as mp:
        def get(family):
            if family not in made:
                made[family] = Family(family, tmp_path_factory.mktemp(family), mp)
            return made[family]

        yield get


def latents_of(family, engine, out):
    return [np.asarray(out)] if family in RETURNS_LATENTS else list(engine.decoded)


@pytest.mark.parametrize("case", list(CASES))
def test_latents_match_jax(families, case):
    family, model_type, kw, shapes = CASES[case]
    fam = families(family)
    jax_eng, port_eng = fam.pair(model_type)
    if family == "longcat":
        assert type(port_eng) is ENGINES[model_type]
        kw = dict(kw)
    else:
        kw = dict(kw, return_latents=True)
    ref = fam.run("jax", jax_eng, **kw)
    got = fam.run("port", port_eng, **kw)
    want, have = latents_of(family, jax_eng, ref), latents_of(family, port_eng, got)
    assert [w.shape for w in want] == [h.shape for h in have] == shapes
    for h, w in zip(have, want):
        assert_rel_l2(torch.from_numpy(h), w, 1e-3)
    if family == "longcat":  # frames of the same count and size
        assert len(got) == len(ref) and got[0].shape == np.asarray(ref[0]).shape and got[0].dtype == np.uint8


def test_conditioning_is_pinned(families):
    """i2v keeps the image's latent frame (LongCat: never updated; Cosmos: put
    back every step) whatever the seed; Kandinsky's i2v latents move with
    the image."""
    fam = families("longcat")
    _, eng = fam.pair("i2v")
    kw = dict(CASES["longcat_i2v"][2], num_inference_steps=1)
    fam.run("port", eng, **dict(kw, seed=1))
    a = eng.decoded[0]
    fam.run("port", eng, **dict(kw, seed=2))
    b = eng.decoded[0]
    assert np.array_equal(a[:, :, 0], b[:, :, 0]) and not np.allclose(a[:, :, 1:], b[:, :, 1:])

    fam = families("cosmos2")
    _, eng = fam.pair("i2v")
    kw = dict(CASES["cosmos2_i2v"][2], num_inference_steps=1, return_latents=True)
    a, b = (fam.run("port", eng, **dict(kw, seed=s)) for s in (1, 2))
    assert torch.equal(a[:, :, 0], b[:, :, 0]) and not torch.allclose(a[:, :, 1:], b[:, :, 1:])

    fam = families("kandinsky5_visual_cond")
    _, eng = fam.pair("i2v")
    kw = dict(CASES["kandinsky5_i2v"][2], num_inference_steps=1, return_latents=True)
    a, b = (fam.run("port", eng, **dict(kw, image=img)) for img in (IMAGE, 255 - IMAGE))
    assert not torch.allclose(a, b)


def test_kandinsky5_prompt_matches_jax(families):
    """The Qwen sequence (its mask dropped) and CLIP's pooled vector."""
    fam = families("kandinsky5")
    fam.mp.setenv("APEX_HOME_DIR", str(fam.tmp / "home_port"))
    seq, pooled = fam.port.encode_prompt("hello world")
    fam.mp.setenv("APEX_HOME_DIR", str(fam.tmp / "home_jax"))
    want_seq, want_pooled = fam.jax.encode_prompt("hello world")
    assert tuple(seq.shape) == (1, 256, 16) and tuple(pooled.shape) == (1, 12)
    assert_rel_l2(seq, np.asarray(want_seq), 1e-5)
    assert_rel_l2(pooled, np.asarray(want_pooled), 1e-5)


def test_reference_faults_raise_before_the_dit(families):
    """Where the JAX engine fails inside its DiT, the port raises a
    ValueError naming the cause first: Kandinsky 5's manifest lists i2v but
    its T2V config has no ``visual_cond`` input; a Cosmos DiT without the
    condition-mask channel."""
    fam = families("kandinsky5")
    jax_eng, port_eng = fam.pair("i2v")
    kw = dict(CASES["kandinsky5_i2v"][2], return_latents=True)
    with pytest.raises(Exception):
        fam.run("jax", jax_eng, **kw)
    calls = []
    port_eng.transformer.register_forward_pre_hook(lambda *a: calls.append(1))
    with pytest.raises(ValueError, match="visual_cond=False"):
        fam.run("port", port_eng, **kw)
    assert not calls

    fam = families("cosmos2")
    _, port_eng = fam.pair("v2v")
    narrow = UniversalEngine(fam.path, model_type="v2v", device="cpu")
    share(port_eng, narrow)
    cfg = copy.copy(port_eng.transformer.cfg)
    cfg.in_channels = 4
    narrow.transformer = type(port_eng.transformer)(cfg, dtype=torch.float32)
    with pytest.raises(ValueError, match="condition mask"):
        fam.run("port", narrow, **dict(CASES["cosmos2_v2v"][2], return_latents=True))


def test_manifests_resolve_to_the_ported_engines():
    from apex_studio_tpu_torch.engine.registry import resolve_engine_class

    for kind, cls in ENGINES.items():
        name = f"longcat-video-{kind.replace('_', '-')}.yml"
        doc = yaml.safe_load((VIDEO / name).read_text())
        assert doc["spec"]["model_type"] == kind
        assert resolve_engine_class(doc["spec"]["engine"], kind) is cls, name
    want = {"cosmos-predict2-2b-video2world.yml": {"i2v": port_cosmos2.Cosmos2I2VEngine,
                                                   "v2v": port_cosmos2.Cosmos2V2VEngine},
            "kandinsky5-t2v.yml": {"t2v": port_k5.Kandinsky5T2VEngine, "i2v": port_k5.Kandinsky5I2VEngine}}
    for name, types in want.items():
        doc = yaml.safe_load((VIDEO / name).read_text())
        assert sorted(doc["spec"]["model_type"]) == sorted(types)
        for model_type, cls in types.items():
            assert resolve_engine_class(doc["spec"]["engine"], model_type) is cls, (name, model_type)
