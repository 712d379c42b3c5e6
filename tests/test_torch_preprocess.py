"""The port's preprocessors (``apex_studio_tpu_torch/preprocess``) against the
JAX package's on the CPU.

- The 18 weight-free cv2 / numpy preprocessors (copies of ``basic.py``,
  ``basic2.py``, ``basic3.py``) through ``run_preprocessor`` on both sides:
  outputs equal.
- Depth Anything V2 and OpenPose: the JAX module with its seeded weights
  (``jax_build``) carried into the port (``loaders/from_jax.py``) at the
  tiny configs of tests/test_preprocess_depth.py and
  tests/test_preprocess_pose.py, f32 on the same numpy inputs: forwards
  max|Δ| ≤ 1e-4·max|ref|; the depth map through ``run_preprocessor`` within
  one uint8 level (min-max normalised and truncated, a value on a level's
  edge may fall either way); the pose maps within 1e-4 and the rendered pose
  equal; the converters on the published key names, strictly, both sides.
- A missing checkpoint raises (nothing is fetched); ``/preprocessor/list``
  and ``/preprocessor/run`` through the port's app on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.preprocess import depth_anything as jax_depth
from apex_studio_tpu.preprocess import openpose as jax_pose
from apex_studio_tpu.preprocess.base import run_preprocessor as jax_run
from apex_studio_tpu_torch.loaders.export import published_state_dict
from apex_studio_tpu_torch.preprocess import depth_anything, openpose, preprocessor_registry, run_preprocessor
from tests.torch_port_helpers import assert_close, jax_build, jax_params, port_from_jax

BASIC = ["canny", "blur", "grayscale", "invert", "lineart", "pixel", "threshold", "binary", "color", "shuffle",
         "recolor", "lineart_standard", "pyracanny", "scribble", "scribble_xdog", "tile", "tile_gf", "tile_simple"]
# params that differ from the defaults, so that the branches behind them run
PARAMS = {"shuffle": {"seed": 3}, "binary": {"bin_threshold": 90}, "recolor": {"mode": "intensity"},
          "blur": {"kernel_size": 8}, "tile_gf": {"scale_factor": 1.5}}


def frame(h=96, w=128, seed=0):
    rng = np.random.default_rng(seed)
    f = (rng.random((h, w, 3)) * 40).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    f[(yy - h // 2) ** 2 + (xx - w // 3) ** 2 <= (h // 4) ** 2] = [210, 120, 60]
    f[10:30, 80:120] = [40, 200, 90]
    return f


# the line, edge, normal and LeReS depth preprocessors' manifest names
NETS = ["hed", "scribble_hed", "pidi", "pidinet", "teed", "lineart_realistic", "lineart_anime", "scribble_anime",
        "manga_line", "mlsd", "normalbae", "dsine", "leres"]
# background removal, anime segmentation, optical flow, Metric3D, DensePose
REST = ["rembg", "anime_face_segment", "optical_flow", "unimatch", "ptlflow", "metric3d", "densepose"]


def test_registry_holds_the_ported_names():
    names = set(preprocessor_registry.names())
    assert set(BASIC) | {"depth_anything_v2", "depth", "openpose", "pose"} | (set(NETS) - {"pidi"}) | (
        set(REST) - {"unimatch", "ptlflow"}) == names
    for alias in ("content_shuffle", "open_pose", "OpenposeDetector", "pidi", "softedge", "softedge_hed",
                  "softedge_pidinet", "scribble_pidinet", "softedge_teed", "ted", "lineart_model", "lineart_coarse",
                  "ScribbleAnimeDetector", "LineartAnimeDetector", "LineartMangaDetector", "lineart_manga",
                  "MLSDdetector", "NormalBaeDetector", "DsineDetector", "LeresDetector", "background_removal",
                  "u2net", "AnimeFaceSegmentor", "unimatch", "UnimatchDetector", "flow", "ptlflow", "PTLFlowDetector",
                  "Metric3DDetector", "metric3d_normal", "DenseposeDetector"):
        assert alias in preprocessor_registry


@pytest.mark.parametrize("name", NETS + REST)
def test_registry_names_and_aliases_are_the_jax_ones(name):
    """Each manifest name reaches one preprocessor under the same set of
    registry keys as in the JAX package, and the registry lists its names in
    the JAX registry's order."""
    from apex_studio_tpu.preprocess.base import preprocessor_registry as jax_registry

    def keys(registry):
        cls = registry.get(name)
        return {k for k, v in registry._entries.items() if getattr(v, "obj", v) is cls}

    assert keys(preprocessor_registry) == keys(jax_registry)
    assert preprocessor_registry.get(name).name == jax_registry.get(name).name
    assert preprocessor_registry.get(name).params_schema == jax_registry.get(name).params_schema
    assert [k for k in jax_registry.names() if k in preprocessor_registry] == preprocessor_registry.names()


@pytest.mark.parametrize("name", BASIC)
def test_basic_preprocessor_matches_jax(name):
    frames = [frame(seed=1), frame(seed=2)]
    want = jax_run(name, frames, dict(PARAMS.get(name, {})))
    got = run_preprocessor(name, frames, dict(PARAMS.get(name, {})), device="cpu")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# -- Depth Anything V2 ---------------------------------------------------------------


@pytest.fixture(scope="module")
def depth_pair():
    jax_model = jax_build(lambda: jax_depth.DepthAnythingV2(jax_depth.DAv2Config.tiny(), rngs=nnx.Rngs(0)))
    return jax_model, port_from_jax(lambda: depth_anything.DepthAnythingV2(depth_anything.DAv2Config.tiny()),
                                    jax_model)


@pytest.mark.parametrize("hw", [(56, 56), (84, 70)], ids=["pos_grid", "pos_embed_resized"])
def test_depth_anything_forward_matches_jax(depth_pair, hw):
    """At the position grid, and off it (the bicubic position-embedding
    resize, no antialias)."""
    jax_model, port = depth_pair
    x = np.random.default_rng(3).normal(size=(1, *hw, 3)).astype(np.float32)
    want = nnx.jit(lambda m, v: m(v))(jax_model, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (1, *hw)
    assert_close(got, want)


def test_depth_anything_preprocessor_matches_jax(depth_pair):
    """``run_preprocessor`` on a frame: the antialiased bicubic input resize,
    the align-corners resize back, the normalisation."""
    jax_model, port = depth_pair
    f = frame(60, 90, seed=4)
    want = jax_depth.DepthAnythingV2Preprocessor(model=jax_model)(f, detect_resolution=56)[0]
    got = depth_anything.DepthAnythingV2Preprocessor(model=port)(f, detect_resolution=56, device="cpu")[0]
    assert got.shape == want.shape == (60, 90, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_depth_anything_checkpoint_loads_through_the_converter(tmp_path, monkeypatch, depth_pair):
    """A checkpoint in the published names (``depth_anything_v2_vits.pth``
    with the tiny widths) loads strictly through ``convert_dav2_keys`` on both
    sides, and a missing one raises, naming the file and the directory."""
    from apex_studio_tpu.loaders.state_mapping import apply_state_dict as jax_apply

    jax_model, port = depth_pair
    published = published_state_dict("depth_anything_v2", port.state_dict())
    assert "depth_head.scratch.output_conv2.0.weight" in published
    assert "pretrained.patch_embed.proj.weight" in published
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    monkeypatch.setattr(depth_anything.DAv2Config, "from_name", classmethod(
        lambda cls, name: depth_anything.DAv2Config(**{**vars(cls.tiny()), "encoder": name})))
    with pytest.raises(FileNotFoundError, match="depth_anything_v2_vits.pth"):
        run_preprocessor("depth_anything_v2", frame(), {"encoder": "vits"}, device="cpu")
    torch.save(published, tmp_path / "depth_anything_v2_vits.pth")
    f = frame(42, 56, seed=5)
    got = run_preprocessor("depth", f, {"encoder": "vits", "detect_resolution": 42}, device="cpu")[0]
    want = depth_anything.DepthAnythingV2Preprocessor(model=port)(f, detect_resolution=42, device="cpu")[0]
    np.testing.assert_array_equal(got, want)
    ref = jax_build(lambda: jax_depth.DepthAnythingV2(jax_depth.DAv2Config.tiny(), rngs=nnx.Rngs(1)))
    jax_apply(ref, jax_depth.convert_dav2_keys({k: v.numpy() for k, v in published.items()}), strict=True)
    for key, value in jax_params(ref).items():
        np.testing.assert_array_equal(value, jax_params(jax_model)[key])


# -- OpenPose --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pose_pair():
    jax_model = jax_build(lambda: jax_pose.OpenPoseBody(jax_pose.OpenPoseConfig.tiny(), rngs=nnx.Rngs(0)))
    return jax_model, port_from_jax(lambda: openpose.OpenPoseBody(openpose.OpenPoseConfig.tiny()), jax_model)


def test_openpose_forward_matches_jax(pose_pair):
    jax_model, port = pose_pair
    x = np.random.default_rng(6).normal(size=(1, 64, 48, 3)).astype(np.float32)
    want = nnx.jit(lambda m, v: m(v))(jax_model, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w, c in zip(got, want, (openpose.N_PAF, openpose.N_HEAT)):
        assert g.shape == (1, 8, 6, c)
        assert_close(g, w)


def test_openpose_preprocessor_matches_jax(pose_pair):
    """The maps the decoder reads (the bilinear input resize, stride 8, the
    align-corners resize back) against the JAX steps of ``process_frame``,
    and the rendered frame through ``run_preprocessor``'s path."""
    jax_model, port = pose_pair
    f = frame(60, 90, seed=7)
    h, w = f.shape[:2]
    x = jax.image.resize(jnp.asarray(f, jnp.float32), (64, 96, 3), "bilinear") / 256.0 - 0.5
    paf, heat = (np.asarray(jax_depth.resize_bilinear_ac(m, h, w)[0]) for m in jax_model(x[None]))
    proc = openpose.OpenPosePreprocessor(model=port)
    with torch.no_grad():
        got_paf, got_heat = proc.maps(f, 64)
    assert_close(got_paf, paf)
    assert_close(got_heat, heat)
    want = jax_pose.OpenPosePreprocessor(model=jax_model)(f, detect_resolution=64)[0]
    np.testing.assert_array_equal(proc(f, detect_resolution=64, device="cpu")[0], want)


def test_openpose_decoding_matches_jax():
    """Peaks, limb assembly and the renderer (host numpy, copied) on maps
    with two people painted in, against the JAX functions."""
    h, w = 120, 160
    heat = np.zeros((h, w, openpose.N_HEAT), np.float32)
    paf = np.zeros((h, w, openpose.N_PAF), np.float32)
    yy, xx = np.mgrid[:h, :w]
    for dx in (0, 70):
        joints = {0: (30 + dx, 20), 1: (30 + dx, 40), 2: (15 + dx, 42), 5: (45 + dx, 42), 8: (22 + dx, 80),
                  11: (38 + dx, 80)}
        for part, (x, y) in joints.items():
            heat[..., part] += np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 8.0)
        for (a, b), (cx, cy) in zip(openpose.LIMB_SEQ, openpose.PAF_IDX):
            if a in joints and b in joints:
                (ax, ay), (bx, by) = joints[a], joints[b]
                n = np.hypot(bx - ax, by - ay)
                for s in np.linspace(0, 1, 40):
                    px, py = int(round(ax + s * (bx - ax))), int(round(ay + s * (by - ay)))
                    paf[py, px, cx], paf[py, px, cy] = (bx - ax) / n, (by - ay) / n
    peaks = openpose.find_peaks(heat)
    assert peaks == jax_pose.find_peaks(heat)
    people = openpose.assemble_people(peaks, paf)
    assert people == jax_pose.assemble_people(peaks, paf) and len(people) == 2
    np.testing.assert_array_equal(openpose.render_pose(people, h, w), jax_pose.render_pose(people, h, w))


def test_openpose_converter_full_key_map(tmp_path, monkeypatch):
    """The published ``body_pose_model.pth`` names at full width map onto
    every port parameter (strict), as they map onto the JAX module's; the
    preprocessor loads the file from the models dir."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict

    src = materialize_random(lambda: openpose.OpenPoseBody(), torch.device("cpu"), seed=8)
    published = published_state_dict("openpose", src.state_dict())
    assert {"model0.conv4_4_CPM.weight", "model1_2.conv5_5_CPM_L2.bias", "model6_1.Mconv7_stage6_L1.weight"} \
        <= set(published)
    with torch.device("meta"):
        dst = openpose.OpenPoseBody()
    apply_state_dict(dst, openpose.convert_openpose_keys(published), device="cpu", strict=True)
    for name, value in src.state_dict().items():
        assert torch.equal(dst.state_dict()[name], value), name
    assert set(jax_pose.convert_openpose_keys(published)) == set(openpose.convert_openpose_keys(published))
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="body_pose_model.pth"):
        run_preprocessor("openpose", frame(), device="cpu")


# -- the server --------------------------------------------------------------------------


def test_preprocessor_routes_on_the_cpu(tmp_path, monkeypatch):
    """``/preprocessor/list`` answers the ported names (and the repository's
    manifest ids that resolve to them); ``/preprocessor/run``
    runs canny on a two-frame clip and depth on an image with the server's
    device, the results equal to ``run_preprocessor``'s."""
    from PIL import Image

    from apex_studio_tpu_torch.manifest.resolver import ManifestResolver
    from apex_studio_tpu_torch.server.app import create_app
    from apex_studio_tpu_torch.utils.media import save_video
    from tests.test_torch_server import Served

    monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path / "models"))
    monkeypatch.setattr(depth_anything.DAv2Config, "from_name", classmethod(
        lambda cls, name: depth_anything.DAv2Config(**{**vars(cls.tiny()), "encoder": name})))
    from apex_studio_tpu_torch.engine.base import materialize_random

    port = materialize_random(lambda: depth_anything.DepthAnythingV2(depth_anything.DAv2Config.tiny()),
                              torch.device("cpu"), seed=9)
    (tmp_path / "models").mkdir()
    torch.save(published_state_dict("depth_anything_v2", port.state_dict()),
               tmp_path / "models" / "depth_anything_v2_vits.pth")
    image = frame(48, 64, seed=10)
    Image.fromarray(image).save(tmp_path / "image.png")
    clip = save_video([frame(48, 64, seed=11), frame(48, 64, seed=12)], tmp_path / "clip.mp4", fps=8)
    served = Served(create_app(resolver=ManifestResolver(search_paths=[tmp_path / "manifests"]), device="cpu"))
    try:
        names = [e["name"] for e in served.call("GET", "/preprocessor/list")[1]]
        jobs = {}
        for name, path, params in (("canny", clip, {}), ("depth_anything_v2", tmp_path / "image.png",
                                                          {"detect_resolution": 28})):
            status, out = served.call("POST", "/preprocessor/run", json={
                "preprocessor_name": name, "input_path": str(path), "params": params})
            assert status == 200, out
            jobs[name] = served.wait(out["job_id"])
    finally:
        served.close()
    # the registered names, then manifest ids that resolve to them (open_pose)
    assert names[:len(preprocessor_registry.names())] == preprocessor_registry.names()
    assert all(name in preprocessor_registry for name in names)
    assert all(st["status"] == "complete" for st in jobs.values()), jobs
    assert jobs["canny"]["result_path"].endswith("canny.mp4")
    depth = np.asarray(Image.open(jobs["depth_anything_v2"]["result_path"]))
    np.testing.assert_array_equal(depth, run_preprocessor("depth_anything_v2", image, {"detect_resolution": 28},
                                                          device="cpu")[0])
