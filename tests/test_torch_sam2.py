"""The port's SAM2 (``apex_studio_tpu_torch/mask``) against the JAX package's
``mask/sam2.py`` and ``mask/predictor.py`` on the CPU, and the
``jax.image.resize`` port it needs.

Each JAX module is built with its seeded weights (``jax_build``), carried into
the port with ``loaders/from_jax.py`` and run in f32 on the same numpy inputs
at toy widths (the tiny configs of tests/test_sam2.py). Tolerances: f32 logits
and features max|Δ| ≤ 1e-4·max|ref|; binary masks (logits thresholded at 0,
then resized) agree on all but 0.1% of pixels, where a logit within f32
rounding of 0 may flip; contours equal.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.mask import predictor as jax_predictor
from apex_studio_tpu.mask import sam2 as jax_sam2
from apex_studio_tpu_torch.loaders.export import published_state_dict
from apex_studio_tpu_torch.mask import predictor, sam2
from apex_studio_tpu_torch.utils.jax_resize import resize
from tests.torch_port_helpers import assert_close, jax_build, port_from_jax

TINY = dict(embed_dim=8, num_heads=1, stages=(1, 1, 2, 1), window_specs=(4, 4, 4, 4), global_att_blocks=(2,),
            img_size=64, d_model=32, decoder_depth=2, decoder_heads=2, decoder_mlp_dim=64)
# windows that need padding at every stage (24, 12 and 6 tokens a side against
# windows of 5, 5 and 4), a q-pool transition into each stage, a global block
PADDED = dict(TINY, stages=(1, 2, 3, 1), window_specs=(5, 5, 4, 3), global_att_blocks=(5,), img_size=96)
VIDEO = dict(embed_dim=16, stages=(1, 1, 1, 1), num_heads=1, d_model=32, img_size=64)


def pair(cfg, video=False):
    jax_cls, port_cls = (jax_sam2.SAM2VideoModel, sam2.SAM2VideoModel) if video else \
        (jax_sam2.SAM2ImageModel, sam2.SAM2ImageModel)
    jax_model = jax_build(lambda: jax_cls(jax_sam2.SAM2Config(**cfg), rngs=nnx.Rngs(0)))
    return jax_model, port_from_jax(lambda: port_cls(sam2.SAM2Config(**cfg)), jax_model)


@pytest.fixture(scope="module")
def tiny():
    return pair(TINY)


@pytest.fixture(scope="module")
def video():
    return pair(VIDEO, video=True)


def image(size, seed=0):
    return np.random.default_rng(seed).random((1, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("side", [96, 80], ids=["native_grid", "pos_embed_resized"])
def test_hiera_trunk_matches_jax(side):
    """Padded windows, q-pool transitions (global, as in JAX) and a global
    block; at 80² the position embedding is resized (bilinear, antialiased)."""
    jax_model, port = pair(PADDED)
    x = image(side, seed=1)
    want, want_enc = nnx.jit(lambda m, v: (m.trunk(v), m.encode_image(v)))(jax_model, jnp.asarray(x))
    with torch.no_grad():
        got, got_enc = port.trunk(torch.from_numpy(x)), port.encode_image(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip((*got, *got_enc), (*want, *want_enc)):
        assert_close(g, w)


PROMPTS = {
    "points": dict(points=[{"x": 30, "y": 20}, {"x": 60, "y": 40}], point_labels=[1, 0]),
    "box": dict(points=[], box={"x1": 10, "y1": 8, "x2": 50, "y2": 40}),
    "points_and_box_padded_to_8": dict(points=[{"x": 30, "y": 20}, {"x": 5, "y": 5}, {"x": 70, "y": 44}],
                                       point_labels=[1, 0, 1], box={"x1": 10, "y1": 8, "x2": 50, "y2": 40}),
}


def test_model_predict_matches_jax_with_padded_labels(tiny):
    jax_model, port = tiny
    x = image(64, seed=2)
    pts = np.array([[[0.5, 0.5], [0.2, 0.3], [0.1, 0.9], [0.7, 0.2]]], np.float32)
    labels = np.array([[1, 0, 2, -1]], np.int32)
    want = nnx.jit(lambda m, *a: m.predict(*a))(jax_model, jnp.asarray(x), jnp.asarray(pts), jnp.asarray(labels))
    with torch.no_grad():
        got = port.predict(torch.from_numpy(x), torch.from_numpy(pts), torch.from_numpy(labels))
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("prompt", list(PROMPTS))
def test_predictor_matches_jax(tiny, prompt):
    """``SAM2Predictor.predict``: the bucket of 4 (8) prompt slots, the
    best-of-multimask choice by IoU, the cv2 resizes."""
    jax_model, port = tiny
    frame = (np.random.default_rng(3).random((48, 72, 3)) * 255).astype(np.uint8)
    frame[10:30, 20:50] = 220
    want = jax_predictor.SAM2Predictor(jax_model, img_size=64).predict(frame, **PROMPTS[prompt])
    got = predictor.SAM2Predictor(port, img_size=64).predict(frame, **PROMPTS[prompt])
    assert got.shape == want.shape == (48, 72) and got.dtype == np.uint8
    assert (got != want).mean() <= 1e-3


def test_predictor_needs_a_prompt(tiny):
    with pytest.raises(ValueError, match="points or a box"):
        predictor.SAM2Predictor(tiny[1], img_size=64).predict(np.zeros((8, 8, 3), np.uint8), [])


def test_track_step_and_memory_bank_match_jax(video):
    """Two steps: the prompted conditioning frame, then a promptless frame
    conditioned on two memories of different ages."""
    jax_model, port = video
    x = image(64, seed=4)
    pts = np.array([[[0.4, 0.5], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]]], np.float32)
    labels = np.array([[1, -1, -1, -1]], np.int32)
    m0, i0, mem0 = nnx.jit(lambda m, *a: m.track_step(a[0], [], *a[1:]))(
        jax_model, jnp.asarray(x), jnp.asarray(pts), jnp.asarray(labels))
    m1, i1, mem1 = nnx.jit(lambda m, v, mem: m.track_step(v, [(mem, 0), (mem, 3)]))(jax_model, jnp.asarray(x), mem0)
    with torch.no_grad():
        n0, k0, nem0 = port.track_step(torch.from_numpy(x), [], torch.from_numpy(pts), torch.from_numpy(labels))
        n1, k1, nem1 = port.track_step(torch.from_numpy(x), [(nem0, 0), (nem0, 3)])
    for g, w in ((n0, m0), (k0, i0), (nem0, mem0), (n1, m1), (k1, i1), (nem1, mem1)):
        assert_close(g, w)


@pytest.fixture()
def jitted_jax_stages(monkeypatch):
    """The JAX video model's image encoder, mask decoder and memory encoder
    each run as one jitted call (the same functions; eager, every op compiles
    on its own on this CPU). The memory attention, whose shapes change with
    the bank, stays eager."""
    for cls, name in ((jax_sam2.SAM2ImageModel, "encode_image"), (jax_sam2.MaskDecoder, "__call__"),
                      (jax_sam2.MemoryEncoder, "__call__")):
        key = (cls.__name__, name)
        if key not in _JITTED:  # one jit a stage for the whole module, so each compiles once
            _JITTED[key] = nnx.jit(getattr(cls, name))
        monkeypatch.setattr(cls, name, (lambda fn: lambda self, *a, **kw: fn(self, *a, **kw))(_JITTED[key]))


_JITTED = {}


@pytest.mark.parametrize("start,direction", [(0, "forward"), (5, "backward"), (3, "both")])
def test_sam2_track_video_matches_jax(video, jitted_jax_stages, start, direction):
    """Nine frames of 64 x 64: forward from frame 0 the bank rolls past its 6
    recent slots before the last frame reads it."""
    jax_model, port = video
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 255, (64, 64, 3), dtype=np.uint8) for _ in range(9)]
    points, labels = [{"x": 32, "y": 30}, {"x": 5, "y": 60}], [1, 0]
    want = jax_predictor.sam2_track_video(jax_predictor.SAM2Predictor(jax_model, img_size=64), frames, points,
                                          labels, start_frame=start, direction=direction)
    seen = []
    got = predictor.sam2_track_video(predictor.SAM2Predictor(port, img_size=64), frames, points, labels,
                                     start_frame=start, direction=direction,
                                     frame_callback=lambda i, m: seen.append(i))
    assert sorted(got) == sorted(want)
    assert len(got) == (9 if direction == "both" else 9 - start if direction == "forward" else start + 1)
    for i in got:
        assert (got[i] != want[i]).mean() <= 1e-3, i
    assert sorted(seen) == sorted(i for i in got if i != start)


def test_image_model_tracks_by_flow_as_jax(tiny):
    """A predictor without memory weights tracks its first mask by optical
    flow (``track_mask``), as the JAX predictor does."""
    jax_model, port = tiny
    rng = np.random.default_rng(6)
    frames = [rng.integers(0, 255, (48, 72, 3), dtype=np.uint8) for _ in range(3)]
    want = jax_predictor.sam2_track_video(jax_predictor.SAM2Predictor(jax_model, img_size=64), frames,
                                          [{"x": 30, "y": 20}])
    got = predictor.sam2_track_video(predictor.SAM2Predictor(port, img_size=64), frames, [{"x": 30, "y": 20}])
    assert sorted(got) == sorted(want) == [0, 1, 2]
    assert all((got[i] != want[i]).mean() <= 1e-3 for i in got)


# -- converters ---------------------------------------------------------------------


def _split(state):
    image = {k: v for k, v in state.items() if not k.startswith(("memory_", "obj_ptr", "no_mem", "maskmem"))}
    return image, {k: v for k, v in state.items() if k not in image}


def test_converters_round_trip_the_published_names(video):
    """The port's state under the published sam2 names loads back through the
    ``sam2`` (image) and ``sam2_video`` (memory bank) tables, strictly and
    bit-equal. The JAX tables map the same names onto the JAX module's
    parameters except where they are at fault (ROADMAP Queue 3): the patch
    embedding's weight (left as ``patch_embed.proj.kernel``) and the mask
    downsampler's LayerNorm2d weights (renamed ``kernel``)."""
    from apex_studio_tpu.loaders.converters import convert_keys as jax_convert_keys
    from apex_studio_tpu_torch.loaders.converters import convert_keys
    from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict
    from tests.torch_port_helpers import jax_params

    jax_model, port = video
    image_sd, memory_sd = _split(port.state_dict())
    published = {**published_state_dict("sam2", image_sd), **published_state_dict("sam2_video", memory_sd)}
    assert "image_encoder.trunk.blocks.0.attn.qkv.weight" in published
    assert "sam_mask_decoder.transformer.layers.0.mlp.layers.1.bias" in published
    assert "memory_encoder.mask_downsampler.encoder.12.weight" in published
    assert "memory_attention.layers.3.cross_attn_image.k_proj.weight" in published
    pub_image, pub_memory = _split(published)
    dst = sam2.SAM2VideoModel(sam2.SAM2Config(**VIDEO))
    apply_state_dict(dst, {**convert_keys("sam2", pub_image), **convert_keys("sam2_video", pub_memory)},
                     strict=True)
    for name, value in port.state_dict().items():
        assert torch.equal(dst.state_dict()[name], value), name

    as_np = lambda sd: {k: v.numpy() for k, v in sd.items()}  # noqa: E731
    mapped = set(jax_convert_keys("sam2", as_np(pub_image))) | set(jax_convert_keys("sam2_video", as_np(pub_memory)))
    params = set(jax_params(jax_model))
    ln2d = {f"memory_encoder.mask_downsampler.encoder.{i}" for i in (1, 3, 5, 7)}
    assert mapped - params == {"trunk.patch_embed.proj.kernel"} | {f"{m}.kernel" for m in ln2d}
    assert params - mapped == {"trunk.patch_embed.kernel"} | {f"{m}.weight" for m in ln2d}


def test_converter_maps_official_keys():
    """tests/test_sam2.py's key sample through the port's table."""
    from apex_studio_tpu_torch.loaders.converters import convert_keys

    sd = {
        "image_encoder.trunk.blocks.0.attn.qkv.weight": np.zeros((24, 8), np.float32),
        "image_encoder.trunk.patch_embed.proj.weight": np.zeros((8, 3, 7, 7), np.float32),
        "image_encoder.neck.convs.0.conv.weight": np.zeros((32, 8, 1, 1), np.float32),
        "sam_prompt_encoder.point_embeddings.1.weight": np.zeros((1, 32), np.float32),
        "sam_mask_decoder.transformer.layers.0.self_attn.q_proj.weight": np.zeros((32, 32), np.float32),
        "sam_mask_decoder.iou_token.weight": np.zeros((1, 32), np.float32),
        "sam_mask_decoder.output_upscaling.0.weight": np.zeros((32, 8, 2, 2), np.float32),
        "memory_encoder.something.weight": np.zeros((1,), np.float32),
    }
    out = convert_keys("sam2", sd)
    assert {"trunk.blocks.0.qkv.kernel", "trunk.patch_embed.kernel", "neck.convs.0.kernel",
            "prompt_encoder.point_embeddings.1", "mask_decoder.layers.0.self_attn.q_proj.kernel",
            "mask_decoder.iou_token", "mask_decoder.upscale1.kernel"} == set(out)


# -- checkpoint resolution and the server ----------------------------------------------


@pytest.fixture()
def sam2_home(monkeypatch, tmp_path, tiny):
    """A home with a tiny published-layout checkpoint and its config.json,
    named by APEX_SAM2_PATH; the port's predictor reset around the test."""
    monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
    monkeypatch.delenv("APEX_PREPROCESSOR_MODELS_PATH", raising=False)
    ckpt = tmp_path / "sam2" / "sam2.1_hiera_tiny.pt"
    ckpt.parent.mkdir()
    torch.save({"model": published_state_dict("sam2", tiny[1].state_dict())}, ckpt)
    (ckpt.parent / "config.json").write_text(json.dumps(TINY))
    monkeypatch.setenv("APEX_SAM2_PATH", str(ckpt))
    predictor.reset_sam2_predictor()
    yield ckpt
    predictor.reset_sam2_predictor()


def test_predictor_loads_the_published_checkpoint(sam2_home, tiny):
    pred = predictor.get_sam2_predictor("cpu")
    assert isinstance(pred.model, sam2.SAM2ImageModel) and not isinstance(pred.model, sam2.SAM2VideoModel)
    assert pred.img_size == 64 and pred.device.type == "cpu"
    for name, value in tiny[1].state_dict().items():
        assert torch.equal(pred.model.state_dict()[name], value), name
    assert predictor.mask_backend_status() == {"backend": "sam2", "model_type": None,
                                               "checkpoint": str(sam2_home), "error": None}


def test_predictor_without_config_builds_the_default_config(tmp_path):
    """No config.json: ``SAM2Config()`` (embed 96, one head), as the JAX
    predictor builds, whatever MASK_MODEL names; random weights from a
    directory without safetensors."""
    pred = predictor.SAM2Predictor.from_checkpoint(tmp_path, device="cpu")
    assert pred.model.cfg == sam2.SAM2Config() and pred.img_size == 1024
    assert type(pred.model) is sam2.SAM2ImageModel


def test_mask_create_served_on_sam2(sam2_home, tmp_path):
    """/mask/create through the port's app on the CPU: SAM2's mask as
    contours, and /system/memory's ``mask_backend`` reading ``sam2``."""
    from PIL import Image

    from apex_studio_tpu_torch.mask import mask_from_points, mask_to_contours
    from apex_studio_tpu_torch.server.app import create_app
    from tests.test_torch_server import Served

    frame = np.zeros((48, 72, 3), np.uint8)
    frame[10:30, 20:50] = 220
    path = tmp_path / "frame.png"
    Image.fromarray(frame).save(path)
    body = {"input_path": str(path), "points": [{"x": 30, "y": 20}], "point_labels": [1]}
    served = Served(create_app(device="cpu"))
    try:
        status, out = served.call("POST", "/mask/create", json=body)
        memory = served.call("GET", "/system/memory")[1]
    finally:
        served.close()
    assert status == 200 and out["status"] == "success"
    assert out["contours"] == mask_to_contours(mask_from_points(frame, body["points"], [1], device="cpu"))
    assert memory["mask_backend"]["backend"] == "sam2"


# -- jax.image.resize ---------------------------------------------------------------


@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("shapes", [((1, 37, 37, 5), (1, 20, 31, 5)), ((1, 7, 9, 3), (1, 30, 17, 3)),
                                    ((13, 11, 2), (40, 6, 2))], ids=["down", "up", "mixed"])
def test_jax_image_resize(method, antialias, shapes):
    """``utils/jax_resize.resize`` against ``jax.image.resize`` (half-pixel
    centres, Keys cubic a = -0.5, the antialiased downscale): f32, max|Δ| ≤
    1e-4·max|ref|; nearest exact."""
    src, dst = shapes
    x = np.random.default_rng(7).normal(size=src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, method, antialias=antialias))
    got = resize(torch.from_numpy(x), dst, method, antialias).numpy()
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        assert_close(got, want)
