"""The port's last Wan engines end to end against the JAX package's, on the
CPU: ReCamMaster, HoloCine, ATI, Apex-FramePack, Wan 2.2 Animate (animate
over two segments and replace), Lynx and Lynx-lite, SCAIL, Lucy Edit and
Wan 2.2 TI2V-5B's t2v.

Each engine runs from its repository manifest (scheduler, shift, helpers)
with every other component cut to toy widths in fp32: the 1-layer UMT5, the
Wan VAE of tests/test_engine_wan.py's ``WAN_TINY`` (4 latent channels, 2× in
space and time), a 2-layer CLIP vision tower of width 16 where the manifest
has one, and the DiT at the widths of the JAX engine tests
(tests/test_engine_wan_{recam,framepack,animate,lynx,scail}.py,
tests/test_engine_lucy.py). Every component's weights are carried from the
JAX engine into the port; each engine has its own ``APEX_HOME_DIR``; 32 × 32
pixels, 5 frames (3 latent frames of 16 × 16) unless a case says otherwise.

Latents after the steps: rel L2 ≤ 1e-3; Animate returns frames only: within
one uint8 level, mean ≤ 1e-3. Also: ATI's painted condition, HoloCine's
shot ids, bias and segmented context, and where the repository manifests
cannot run (the reference faults of ROADMAP Queue 3): the JAX engine fails
and the port raises a ``ValueError`` naming the cause before the DiT runs.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine import lucy as port_lucy
from apex_studio_tpu_torch.engine import wan as port_wan
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from tests.test_engine_wan import WAN_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.test_torch_wan_rest import with_blur
from tests.torch_port_helpers import assert_rel_l2, fast_jax_engine, jax_params

REPO = Path(__file__).resolve().parents[1]
TINY = {c["type"]: c["config"] for c in WAN_TINY["spec"]["components"] if c["type"] != "scheduler"}
CLIP = dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2, image_size=28,
            patch_size=14)
ANIMATE = dict(in_channels=10, out_channels=4, num_attention_heads=2, attention_head_dim=12, text_dim=32,
               freq_dim=32, ffn_dim=48, num_layers=2, image_dim=16, motion_encoder_size=32, motion_style_dim=16,
               motion_dim=4, motion_encoder_dim=16, face_encoder_hidden_dim=8, face_encoder_num_heads=2,
               inject_face_latents_blocks=2)
LYNX = dict(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=12, text_dim=32, freq_dim=32,
            ffn_dim=48, num_layers=2, ip_cross_attention_dim=16, ip_registers=2)
RESAMPLER = dict(dim=16, depth=1, dim_head=8, heads=2, num_queries=3, embedding_dim=8, output_dim=16, ff_mult=2)
SCAIL = dict(in_dim=6, dim=24, ffn_dim=48, freq_dim=32, text_dim=32, text_len=8, out_dim=4, num_heads=2,
             num_layers=2, image_dim=16, pose_rope_shift=[0, 64, 64])
FRAMEPACK = dict(TINY["transformer"], num_indices=3, framepack_compressors=[[1, [1, 2, 2]], [2, [2, 4, 4]],
                                                                            [4, [4, 8, 8]]],
                 context_buckets=[["F_1", 1, 1], ["F_2", 2, 2], ["F_4", 16, 4]])
I2V_CLIP = dict(TINY["transformer"], in_channels=10, image_dim=16, added_kv_proj_dim=48)
# case → (manifest, model type, transformer base (None: the manifest's), DiT config, helper configs)
CASES = {
    "recam": ("wan-2.1-14b-recam.yml", "recam", None, TINY["transformer"], {}),
    "holocine": ("wan-holocine.yml", "holocine", "wan.holocine", TINY["transformer"], {"image_encoder": CLIP}),
    "holocine_mask": ("wan-holocine.yml", "holocine", "wan.holocine", dict(TINY["transformer"], in_channels=5),
                      {"image_encoder": CLIP}),
    "ati": ("wan-2.1-14b-ati.yml", "ati", None, I2V_CLIP, {"image_encoder": CLIP}),
    "apex_framepack": ("wan-apex-framepack.yml", "apex_framepack", None, FRAMEPACK, {}),
    "animate": ("wan2.2-animate-14b.yml", "animate", None, ANIMATE, {"image_encoder": CLIP}),
    "lynx": ("wan-lynx-14b.yml", "lynx", None, LYNX, {"resampler": RESAMPLER}),
    "lynx_lite": ("wan-lynx-lite-14b.yml", "lynx_lite", None, dict(LYNX, ip_registers=0), {"resampler": RESAMPLER}),
    "scail": ("wan-2.1-14b-scail.yml", "scail", None, SCAIL, {"image_encoder": CLIP}),
    "lucy": ("lucy-edit-dev.yml", "edit", None, dict(TINY["transformer"], in_channels=8), {}),
    "ti2v_t2v": ("wan2.2-ti2v-5b.yml", "t2v", None, TINY["transformer"], {}),
}
RNG = np.random.default_rng(0)
IMAGE = RNG.integers(0, 256, size=(40, 36, 3), dtype=np.uint8)
VIDEO = [RNG.integers(0, 256, size=(32, 32, 3), dtype=np.uint8) for _ in range(9)]
FACES = [RNG.integers(0, 256, size=(24, 24, 3), dtype=np.uint8) for _ in range(9)]
TRACKS = np.concatenate([RNG.uniform(0, 8 * 32, size=(5, 3, 2)), np.full((5, 3, 1), 8.0)], -1).astype(np.float32)
BASE = dict(prompt="hello world", negative_prompt="a cat", height=32, width=32, num_frames=5, seed=3,
            num_inference_steps=2, guidance_scale=4.0)
SHOTS = dict(BASE, prompt="a quiet harbour", shot_captions=["boats at dawn", "a gull lands on a post"], num_frames=9)
REQUESTS = {
    "recam": dict(BASE, video=VIDEO[:5], camera="orbit"),
    "holocine": SHOTS,
    "holocine_mask": dict(SHOTS, shot_mask_type="normalized"),
    "ati": dict(BASE, image=IMAGE, trajectory=TRACKS),
    "apex_framepack": dict(BASE, num_frames=17, guidance_scale=2.0),
    "lynx": dict(BASE, face_embeds=RNG.normal(size=8).astype(np.float32), ip_scale=0.8),
    "lynx_lite": dict(BASE, face_embeds=RNG.normal(size=8).astype(np.float32)),
    "scail": dict(BASE, image=IMAGE, pose_video=VIDEO[:5]),
    "lucy": dict(BASE, video=VIDEO[:5]),
    "ti2v_t2v": BASE,
}
LATENTS = {"recam": (1, 4, 3, 16, 16), "holocine": (1, 4, 5, 16, 16), "holocine_mask": (1, 4, 5, 16, 16),
           "ati": (1, 4, 3, 16, 16), "apex_framepack": (1, 4, 9, 16, 16), "lynx": (1, 4, 3, 16, 16),
           "lynx_lite": (1, 4, 3, 16, 16), "scail": (1, 4, 3, 16, 16), "lucy": (1, 4, 3, 16, 16),
           "ti2v_t2v": (1, 4, 3, 16, 16)}
ANIMATE_REQUESTS = {
    "animate_two_segments": dict(image=IMAGE, pose_video=VIDEO, face_video=FACES, prompt="a dancer", height=32,
                                 width=32, segment_frame_length=5, prev_segment_conditioning_frames=1,
                                 num_inference_steps=2, guidance_scale=1.0, seed=3),
    "replace": dict(image=IMAGE, pose_video=VIDEO[:5], face_video=FACES[:5], background_video=VIDEO[4:9],
                    mask_video=[np.where(f[..., 0] > 128, 255, 0).astype(np.uint8) for f in VIDEO[:5]],
                    mode="replace", prompt="a dancer", negative_prompt="blur", height=32, width=32,
                    segment_frame_length=5, num_inference_steps=2, guidance_scale=3.0, seed=4),
}
ENGINES = {"recam": port_wan.WanRecamEngine, "holocine": port_wan.WanHolocineEngine,
           "holocine_mask": port_wan.WanHolocineEngine, "ati": port_wan.WanATIEngine,
           "apex_framepack": port_wan.WanApexFramepackEngine, "animate": port_wan.WanAnimateEngine,
           "lynx": port_wan.WanLynxEngine, "lynx_lite": port_wan.WanLynxEngine, "scail": port_wan.WanScailEngine,
           "lucy": port_lucy.LucyEditEngine, "ti2v_t2v": port_wan.WanT2VEngine}


def manifest(tmp_path, case, tf_config=None):
    """``case``'s repository manifest with toy components in fp32 and no
    weight files."""
    name, model_type, base, tf_cfg, helpers = CASES[case]
    doc = yaml.safe_load((REPO / "manifests" / "video" / name).read_text())
    doc["spec"]["model_type"] = model_type
    for comp in doc["spec"]["components"]:
        if comp["type"] == "scheduler":
            continue
        comp.pop("config_path", None)
        comp.pop("model_path", None)
        comp["precision"] = "fp32"
        if comp["type"] == "helper":
            comp["config"] = dict(helpers[comp["name"]])
        elif comp["type"] == "transformer":
            comp["config"] = copy.deepcopy(tf_config or tf_cfg)
            comp["base"] = base or comp["base"]
        else:
            comp["config"] = copy.deepcopy(TINY[comp["type"]])
    path = tmp_path / f"{case}.yml"
    path.write_text(yaml.safe_dump(doc))
    return path, model_type


def components(engine):
    for ctype in ("vae", "scheduler", "text_encoder"):
        if getattr(engine, ctype) is None:
            engine.load_component_by_type(ctype)
    engine.load_components(return_latents=True)
    engine._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
    out = {"vae": engine.vae, "transformer": engine.transformer, "umt5": engine.text_encoder._ensure_model()}
    for name, spec in engine.component_specs.items():
        if spec.get("type") == "helper":
            out[name] = engine.load_helper(name)
    return out


class Pair:
    def __init__(self, path, model_type, tmp_path, mp):
        mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        mp.setenv("APEX_RELEASE_TEXT_ENCODERS", "0")
        self.mp, self.tmp = mp, tmp_path
        self.mp.setenv("APEX_HOME_DIR", str(tmp_path / "home_jax"))
        self.jax = fast_jax_engine(JaxUniversalEngine(path, model_type=model_type))
        ref = components(self.jax)
        with_blur(ref["transformer"])
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


@pytest.mark.parametrize("request_name", list(ANIMATE_REQUESTS))
def test_animate_frames_match_jax(pairs, request_name):
    """Animate over two 5-frame segments chained on one frame (9 frames) and
    replace mode under CFG; the 9 pose / face frames reflect-padded."""
    pair = pairs("animate")
    assert type(pair.port) is ENGINES["animate"]
    kw = ANIMATE_REQUESTS[request_name]
    ref, frames = pair.run_jax(**kw), pair.run_port(**kw)
    assert len(frames) == len(ref) == len(kw["pose_video"])
    got, want = np.stack(frames).astype(np.float64) / 255.0, np.stack(ref).astype(np.float64) / 255.0
    assert got.shape == want.shape == (len(frames), 32, 32, 3)
    assert np.abs(got - want).max() <= 1 / 255 + 1e-9 and np.abs(got - want).mean() <= 1e-3


def test_ati_condition_matches_jax(pairs):
    """The painted i2v condition (mask channels = the splat weight)."""
    pair = pairs("ati")
    for engine in (pair.jax, pair.port):
        engine._pending_trajectory = TRACKS
    try:
        want = np.asarray(pair.jax.build_condition(IMAGE, 5, 32, 32))
        got = pair.port.build_condition(IMAGE, 5, 32, 32)
        pair.port._pending_trajectory = None
        plain = pair.port.build_condition(IMAGE, 5, 32, 32)
    finally:
        pair.jax._pending_trajectory = pair.port._pending_trajectory = None
    assert tuple(got.shape) == want.shape == (1, 6, 3, 16, 16)
    assert_rel_l2(got, want, 1e-5)
    assert (got - plain).abs().max() > 1e-3


def test_holocine_shots_match_jax(pairs):
    """The segmented context, its spans, the shot ids and the bias."""
    pair = pairs("holocine")
    prompt, cuts = pair.port.prepare_multishot_inputs("a quiet harbour", SHOTS["shot_captions"], 9)
    assert (prompt, cuts) == pair.jax.prepare_multishot_inputs("a quiet harbour", SHOTS["shot_captions"], 9)
    ctx, pos = pair.port._encode_segmented(prompt)
    ref_ctx, ref_pos = pair.jax._encode_segmented(prompt)
    assert pos == ref_pos and pos["shots"][1][1] == pos["used"] - 1
    assert_rel_l2(ctx, np.asarray(ref_ctx), 1e-5)
    ids = pair.port._shot_indices(cuts, 9, 2)
    assert np.array_equal(ids, pair.jax._shot_indices(cuts, 9, 2)) and ids.tolist() == [0, 0, 1, 1, 1]
    tok = np.repeat(ids, 64)
    bias = pair.port._ctx_bias(tok, pos, 512)
    assert np.array_equal(bias, np.asarray(pair.jax._ctx_bias(tok, pos, 512)))
    assert bias.shape == (1, 1, 320, 512) and (bias[0, 0, 0, pos["shots"][1][0]] == -1e4)


def test_manifests_resolve_to_the_ported_engines():
    """The ten manifests of the slice resolve in the port; TI2V-5B for both
    its model types."""
    from apex_studio_tpu_torch.engine.registry import resolve_engine_class

    want = {"lucy-edit-dev.yml": {"edit": port_lucy.LucyEditEngine},
            "wan2.2-ti2v-5b.yml": {"t2v": port_wan.WanT2VEngine, "i2v": port_wan.WanI2VEngine},
            "wan-2.1-14b-recam.yml": {"recam": port_wan.WanRecamEngine},
            "wan-2.1-14b-ati.yml": {"ati": port_wan.WanATIEngine},
            "wan-2.1-14b-scail.yml": {"scail": port_wan.WanScailEngine},
            "wan-holocine.yml": {"holocine": port_wan.WanHolocineEngine},
            "wan-apex-framepack.yml": {"apex_framepack": port_wan.WanApexFramepackEngine},
            "wan2.2-animate-14b.yml": {"animate": port_wan.WanAnimateEngine},
            "wan-lynx-14b.yml": {"lynx": port_wan.WanLynxEngine},
            "wan-lynx-lite-14b.yml": {"lynx_lite": port_wan.WanLynxEngine}}
    for name, types in want.items():
        doc = yaml.safe_load((REPO / "manifests" / "video" / name).read_text())
        for model_type, cls in types.items():
            assert resolve_engine_class(doc["spec"]["engine"], model_type) is cls, (name, model_type)


# -- the repository manifests that cannot run (ROADMAP Queue 3) ---------------------------


@pytest.mark.parametrize("fault", ["ti2v_i2v", "lucy_wan21_vae", "holocine_i2v_config"])
def test_reference_faults_raise_before_the_dit(tmp_path, monkeypatch, fault):
    """TI2V-5B i2v: 4 mask + z condition channels beside a DiT that takes z
    alone (the toy DiT takes the VAE's 4). lucy-edit-dev.yml: the Wan 2.1 VAE
    (z 16) under Lucy's 96-in / 48-out DiT (toy: z 4 under 12 in / 6 out).
    wan-holocine.yml: the Wan 2.1 I2V config (36 channels, toy 10) for
    HoloCine's 16 latent channels (toy 4). The JAX engine fails; the port
    raises a ValueError naming the cause before the DiT runs."""
    case, tf_cfg, kw, match = {
        "ti2v_i2v": ("ti2v_t2v", TINY["transformer"], dict(BASE, image=IMAGE), "no more than the 6 condition"),
        "lucy_wan21_vae": ("lucy", dict(TINY["transformer"], in_channels=12, out_channels=6),
                           dict(BASE, video=VIDEO[:5]), "leave 8 for the noise"),
        "holocine_i2v_config": ("holocine", I2V_CLIP, SHOTS, "names an i2v config"),
    }[fault]
    path, model_type = manifest(tmp_path, case, tf_cfg)
    if fault == "ti2v_i2v":
        model_type = "i2v"
        doc = yaml.safe_load(path.read_text())
        doc["spec"]["components"].append({"type": "helper", "name": "image_encoder", "base": "CLIPVisionModel",
                                          "precision": "fp32", "config": dict(CLIP)})
        path.write_text(yaml.safe_dump(doc))
    if fault == "holocine_i2v_config":
        doc = yaml.safe_load(path.read_text())
        next(c for c in doc["spec"]["components"] if c["type"] == "transformer")["base"] = "wan.base"
        path.write_text(yaml.safe_dump(doc))
    pair = Pair(path, model_type, tmp_path, monkeypatch)
    with pytest.raises(Exception):  # noqa: B017 - a shape error from inside JAX
        pair.run_jax(**kw)
    calls = []
    pair.port.transformer.register_forward_pre_hook(lambda *a: calls.append(1))
    with pytest.raises(ValueError, match=match):
        pair.run_port(**kw)
    assert not calls


def test_unknown_helper_base_raises_with_its_name(pairs):
    pair = pairs("lynx")
    pair.port.component_specs["resampler_2"] = {"type": "helper", "name": "resampler_2", "base": "PerceiverX"}
    try:
        with pytest.raises(KeyError, match="PerceiverX"):
            pair.port.load_helper("resampler_2")
    finally:
        del pair.port.component_specs["resampler_2"]
    assert type(pair.port.helpers["resampler"]).__name__ == "LynxResampler"
