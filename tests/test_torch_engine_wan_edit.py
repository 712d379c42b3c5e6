"""The port's Wan editing and long-video engines end to end against the JAX
package's, on the CPU.

Each engine runs from its repository manifest (its scheduler and shift, its
experts, its helper) with every other component cut to the toy widths of
tests/test_engine_wan.py's ``WAN_TINY`` in fp32: a 1-block DiT of 2 heads of
24, a 1-layer UMT5, a Wan VAE with ``base_dim`` 8, 4 latent channels and 2×
in space and time, and for the Wan 2.1 i2v manifests a 2-layer CLIP vision
tower of width 16 at 28 px (5 tokens). The DiT's input channels follow each
engine's packing: 4 noise (+ 2 frame-mask + 4 condition for i2v, fflf, inp
and svi; + 4 control for fun_control; + 4 control + 4 start-image for fun),
VACE's control 4 + 4 + 2×2 mask = 12 channels. Every component's weights are
carried from the JAX engine into the port; each engine has its own
``APEX_HOME_DIR``. 32 × 32 pixels and 5 frames: 3 latent frames of 16 × 16.

Latents after the steps: rel L2 ≤ 1e-3 (SVI returns frames only; its frames
in [0, 1]: max|Δ| ≤ one uint8 level and mean|Δ| ≤ 1e-3, as the t2v frames in
tests/test_torch_engine_wan.py); the causal engine also with a local window
and a sink, an image pre-fill and a video pre-fill. Also: the CLIP features each i2v engine
hands the DiT, VACE's space-to-depth mask and the frame index rule of
``jax.image.resize``, the reference frames dropped before VACE's decode, the
causal engine's cache after the run (exactly the committed blocks, as a
fresh commit of the output rebuilds it) and the attention launches a causal
block makes.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine import wan as port_wan
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from apex_studio_tpu_torch.ops.attention import attention_registry
from tests.test_engine_wan import WAN_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import assert_rel_l2, fast_jax_engine, jax_params

REPO = Path(__file__).resolve().parents[1]
TINY = {c["type"]: c["config"] for c in WAN_TINY["spec"]["components"] if c["type"] != "scheduler"}
CLIP = dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2, image_size=28,
            patch_size=14)
I2V_CH = dict(in_channels=10)
# model type → (manifest, the DiT's config beside the toy widths)
CASES = {
    "i2v": ("wan-2.1-14b-image-to-video-480p.yml", dict(I2V_CH, image_dim=16, added_kv_proj_dim=48)),
    "svi": ("wan2.2-a14b-stable-video-infinity.yml", dict(I2V_CH, image_dim=16, added_kv_proj_dim=48)),
    "fflf": ("wan2.2-a14b-first-frame-last-frame.yml", I2V_CH),
    # first–last frame with the Wan 2.1 image branch (a CLIP helper added to the manifest)
    "fflf_clip": ("wan2.2-a14b-first-frame-last-frame.yml", dict(I2V_CH, image_dim=16, added_kv_proj_dim=48)),
    "inp": ("wan2.2-a14b-video-inpaint.yml", I2V_CH),
    "v2v": ("wan2.2-a14b-video-to-video.yml", {}),
    "vace": ("wan-2.1-14b-vace.yml", dict(vace_layers=[0], vace_in_channels=12)),
    "fun_vace": ("wan2.2-fun-a14b-vace.yml", dict(vace_layers=[0], vace_in_channels=12)),
    "phantom": ("wan-2.1-14b-phantom.yml", {}),
    "fun_control": ("wan-2.2-fun-a14b-control.yml", dict(in_channels=8)),
    "fun": ("wan-2.2-fun-a14b-control.yml", dict(in_channels=12)),
    "causal": ("wan-causal-self-forcing.yml", {}),
}
A14B = dict(guidance_scale=4.0, guidance_scale_2=3.0, boundary_ratio=0.875)
RNG = np.random.default_rng(0)
IMAGE, LAST = (RNG.integers(0, 256, size=(40, 36, 3), dtype=np.uint8) for _ in range(2))
VIDEO = [RNG.integers(0, 256, size=(32, 32, 3), dtype=np.uint8) for _ in range(5)]
YY, XX = np.mgrid[:32, :32]
DISK = (((YY - 14) ** 2 + (XX - 18) ** 2) <= 81).astype(np.uint8) * 255  # 1 = regenerate
BASE = dict(prompt="hello world", negative_prompt="a cat", height=32, width=32, num_frames=5, seed=3)
REQUESTS = {
    "i2v": dict(BASE, image=IMAGE, num_inference_steps=2, guidance_scale=4.0),
    "fflf": dict(BASE, **A14B, image=IMAGE, last_image=LAST, num_inference_steps=3),
    "fflf_clip": dict(BASE, **A14B, image=IMAGE, last_image=LAST, num_inference_steps=2),
    "inp": dict(BASE, **A14B, video=VIDEO, mask=DISK, num_inference_steps=3),
    "v2v": dict(BASE, **A14B, video=VIDEO, strength=0.7, num_inference_steps=4),
    "vace": dict(BASE, video=VIDEO, mask=[np.repeat(DISK[..., None], 3, -1)] * 5, reference_images=[IMAGE],
                 num_inference_steps=2, guidance_scale=5.0),
    "fun_vace": dict(BASE, start_image=IMAGE, end_image=LAST, subject_ref_images=[IMAGE], num_inference_steps=2,
                     guidance_scale=5.0),
    "phantom": dict(BASE, subject_reference_images=[IMAGE, LAST], num_inference_steps=2, guidance_scale=5.0),
    "fun_control": dict(BASE, control_video=VIDEO[:3], ref_image=LAST, num_inference_steps=2, guidance_scale=5.0),
    "fun": dict(BASE, start_image=IMAGE, end_image=LAST, control_video=VIDEO, subject_reference_images=[LAST],
                num_inference_steps=2, guidance_scale=5.0),
    "causal": dict(prompt="a drifting cloud", height=32, width=32, num_frames=13, num_inference_steps=2,
                   num_frame_per_block=3, seed=11),
}
LATENTS = {"i2v": (1, 4, 3, 16, 16), "fflf": (1, 4, 3, 16, 16), "fflf_clip": (1, 4, 3, 16, 16),
           "inp": (1, 4, 3, 16, 16),
           "v2v": (1, 4, 3, 16, 16), "vace": (1, 4, 4, 16, 16), "fun_vace": (1, 4, 4, 16, 16),
           "phantom": (1, 4, 3, 16, 16), "fun_control": (1, 4, 3, 16, 16), "fun": (1, 4, 3, 16, 16),
           "causal": (1, 4, 6, 16, 16)}


def manifest(tmp_path, model_type):
    """The repository manifest of ``model_type`` with toy components in fp32
    and no weight files."""
    name, tf_extra = CASES[model_type]
    doc = yaml.safe_load((REPO / "manifests" / "video" / name).read_text())
    doc["spec"]["model_type"] = model_type.removesuffix("_clip")
    comps = doc["spec"]["components"]
    if "image_dim" in tf_extra and not any(c["type"] == "helper" for c in comps):
        comps.append({"type": "helper", "name": "image_encoder", "base": "CLIPVisionModel"})
    for comp in doc["spec"]["components"]:
        if comp["type"] == "scheduler":
            continue
        comp.pop("config_path", None)
        comp.pop("model_path", None)
        comp["precision"] = "fp32"
        if comp["type"] == "helper":
            comp["config"] = dict(CLIP)
        else:
            comp["config"] = copy.deepcopy(dict(TINY["transformer"], **tf_extra) if comp["type"] == "transformer"
                                           else TINY[comp["type"]])
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
    out = {"vae": engine.vae, "transformer": engine.transformer, "transformer_2": engine.transformer_2,
           "umt5": engine.text_encoder._ensure_model()}
    if engine._spec_for_type("helper") is not None:
        out["clip"] = engine.load_helper("image_encoder")
    return {k: v for k, v in out.items() if v is not None}


class Pair:
    def __init__(self, path, tmp_path, mp, jit_caches):
        mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        mp.setenv("APEX_RELEASE_TEXT_ENCODERS", "0")
        self.mp, self.tmp = mp, tmp_path
        self.mp.setenv("APEX_HOME_DIR", str(tmp_path / "home_jax"))
        self.jax = fast_jax_engine(JaxUniversalEngine(path))
        # JAX engines built from equal components (configs, names, scheduler)
        # trace the same programs under the same (tag, shapes) keys, so those
        # cases share one compile cache, as an engine shares it across runs
        comps = yaml.safe_load(path.read_text())["spec"]["components"]
        self.jax._jit_cache = jit_caches.setdefault(yaml.safe_dump(comps, sort_keys=True), {})
        ref = components(self.jax)
        self.mp.setenv("APEX_HOME_DIR", str(tmp_path / "home_port"))
        self.port = UniversalEngine(path, device="cpu")
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
    made, jit_caches = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        def get(model_type):
            if model_type not in made:
                tmp = tmp_path_factory.mktemp(f"wan_{model_type}")
                made[model_type] = Pair(manifest(tmp, model_type), tmp, mp, jit_caches)
            return made[model_type]

        yield get


def assert_frames_close(frames, ref):
    assert len(frames) == len(ref)
    got = np.stack(frames).astype(np.float64) / 255.0
    want = np.stack(ref).astype(np.float64) / 255.0
    assert got.shape == want.shape and frames[0].dtype == np.uint8
    assert np.abs(got - want).max() <= 1 / 255 + 1e-9 and np.abs(got - want).mean() <= 1e-3


ENGINES = {"i2v": port_wan.WanI2VEngine, "fflf": port_wan.WanFFLFEngine, "fflf_clip": port_wan.WanFFLFEngine,
           "inp": port_wan.WanInpaintEngine,
           "v2v": port_wan.WanV2VEngine, "vace": port_wan.WanVaceEngine, "fun_vace": port_wan.WanFunVaceEngine,
           "phantom": port_wan.WanPhantomEngine, "fun_control": port_wan.WanFunControlEngine,
           "fun": port_wan.WanFunEngine, "causal": port_wan.WanCausalEngine}


@pytest.mark.parametrize("model_type", list(LATENTS))
def test_latents_match_jax(pairs, model_type):
    pair = pairs(model_type)
    assert type(pair.port) is ENGINES[model_type]
    run = dict(REQUESTS[model_type], return_latents=True)
    ref = np.asarray(pair.run_jax(**run))
    got = pair.run_port(**run)
    assert tuple(got.shape) == ref.shape == LATENTS[model_type]
    assert_rel_l2(got, ref, 1e-3)


CAUSAL_VARIANTS = {"local_window_and_sink": dict(local_attn_size=1, sink_size=1),
                   "image_prefill": dict(image=IMAGE, context_noise=0.2),
                   "video_prefill": dict(video=VIDEO)}
# latent frames: the 6 generated after the pre-fill's (an image 1, 5 video frames 3)
CAUSAL_FRAMES = {"local_window_and_sink": 6, "image_prefill": 7, "video_prefill": 9}


@pytest.mark.parametrize("variant", list(CAUSAL_VARIANTS))
def test_causal_variants_match_jax(pairs, variant):
    pair = pairs("causal")
    run = dict(REQUESTS["causal"], **CAUSAL_VARIANTS[variant], return_latents=True)
    ref = np.asarray(pair.run_jax(**run))
    got = pair.run_port(**run)
    assert tuple(got.shape) == ref.shape == (1, 4, CAUSAL_FRAMES[variant], 16, 16)
    assert_rel_l2(got, ref, 1e-3)


def test_causal_cache_holds_the_committed_blocks(pairs, monkeypatch):
    """After the run the cache holds the two committed blocks (6 frames of
    64 tokens) and nothing after them, and equals what committing the
    output's blocks afresh writes; a block's forward launches one attention
    over all 384 cache rows with a [1, 384] bias and one over the 512 text
    rows a layer."""
    pair = pairs("causal")
    calls = []
    flash = attention_registry.get("flash")
    monkeypatch.setitem(attention_registry._entries, "flash",
                        lambda q, k, *a, **kw: calls.append((q.shape[1], k.shape[1], kw.get("bias") is not None))
                        or flash(q, k, *a, **kw))
    out = pair.run_port(**REQUESTS["causal"], return_latents=True)
    # 2 blocks × (2 steps + 1 commit) forwards of one layer
    assert calls == [(192, 384, True), (192, 512, False)] * 6
    kc, vc = pair.port.kv_cache
    assert tuple(kc.shape) == (1, 1, 384, 2, 24)
    assert kc.abs().amax(dim=(0, 1, 3, 4)).gt(0).all()
    tf = pair.port.transformer
    fresh_k, fresh_v = tf.init_cache(1, 384)
    ctx = pair.port.encode_prompt(REQUESTS["causal"]["prompt"])
    with torch.no_grad():
        for blk in range(2):
            rope = tf.causal_rope_tables(3 * blk, 3, 8, 8)
            tf.forward_causal(out[:, :, 3 * blk:3 * blk + 3], torch.zeros(1, 3), ctx, fresh_k, fresh_v, 192 * blk,
                              *rope)
    assert torch.equal(fresh_k, kc) and torch.equal(fresh_v, vc)


@pytest.mark.parametrize("model_type,keys", [("i2v", 5), ("fflf_clip", 10)])
def test_clip_features_match_jax(pairs, model_type, keys):
    """The image cross-attention's keys: the image's 5 CLIP tokens, or for
    first–last frame both endpoints' concatenated."""
    pair = pairs(model_type)
    pair.jax._fflf_last = pair.port._fflf_last = LAST
    try:
        want = np.asarray(pair.jax.encode_image_clip(IMAGE))
        got = pair.port.encode_image_clip(IMAGE)
    finally:
        pair.jax._fflf_last = pair.port._fflf_last = None
    assert tuple(got.shape) == want.shape == (1, keys, 16)
    assert_rel_l2(got, want, 1e-4)


def test_i2v_frames_match_jax(pairs):
    pair = pairs("i2v")
    assert_frames_close(pair.run_port(**REQUESTS["i2v"]), pair.run_jax(**REQUESTS["i2v"]))


def test_svi_frames_match_jax(pairs):
    """Two segments of 5 frames, 2 blended, anchored on the frame 2 from the
    end: 8 frames."""
    pair = pairs("svi")
    run = dict(REQUESTS["i2v"], num_frames=8, num_frames_per_segment=5, num_overlap_frames=2,
               num_motion_frame=2, prompts=["hello world", "a red fox"])
    frames = pair.run_port(**run)
    assert len(frames) == 8 and frames[0].shape == (32, 32, 3)
    assert_frames_close(frames, pair.run_jax(**run))


def test_vace_drops_reference_frames_before_decode(pairs, monkeypatch):
    pair = pairs("vace")
    seen = []
    decode = pair.port.decode_latents
    monkeypatch.setattr(pair.port, "decode_latents", lambda z: seen.append(tuple(z.shape)) or decode(z))
    frames = pair.run_port(**dict(REQUESTS["vace"], num_inference_steps=1))
    assert seen == [(1, 4, 3, 16, 16)] and len(frames) == 5


@pytest.mark.parametrize("frames,lat_f", [(5, 3), (81, 21), (9, 5), (1, 1)])
def test_vace_space_to_depth_mask_matches_jax(pairs, frames, lat_f):
    pair = pairs("vace")
    mask = (np.random.default_rng(frames).random((frames, 32, 32)) > 0.5).astype(np.float32)
    want = np.asarray(pair.jax._space_to_depth_mask(mask, lat_f, 16, 16))
    got = pair.port._space_to_depth_mask(mask, lat_f, 16, 16)
    assert tuple(got.shape) == want.shape == (4, lat_f, 16, 16)
    np.testing.assert_array_equal(got.numpy(), want)
