"""The port's pose stack against the JAX package's, on the CPU: NLF (the 3-D
body net behind ``dwpose_nlf``) and the DWPose host code of ``dwpose``,
``pose2d``, ``face2d``, ``animalpose`` and ``dwpose_nlf``.

NLF at ``NLFConfig.tiny()`` (the EfficientNetV2 topology, 1-2 blocks a
stage, a 64-pixel crop, 36 canonical points), built from seeded numpy values
(``jax_build``) and carried into the port: the trunk, ``GPSField``,
``decode``, ``_decode_heatmap_3d``, ``reconstruct_absolute``, ``warp_crop``,
each within rel L2 1e-4 in f32, and the crop model whole (its absolute
joints as exact as JAX's, see ``test_crop_model_matches_jax``);
``NLFEstimator.estimate`` on a 240 × 320 image with two boxes, and its host
path (rotation, plausibility filter, pose NMS) on a scripted crop model,
bit-equal; the published ``nlf_l_multi`` names written by
``nlf_published_state_dict`` load strictly through the port's ``load_nlf``
and through the JAX converter onto the same parameters.

The DWPose runner's ONNX pair cannot run here (no file, no ``onnx`` to write
one): the host code past it runs on stand-ins, the JAX tests'
``FakeRunner`` (tests/test_preprocess_pose2d.py) and scripted ``cv2.dnn``
nets behind the real ``DWPoseRunner`` (YOLOX decode, NMS, the crop affine,
the SimCC decode). Both packages' outputs are bit-equal, ``dwpose_nlf``'s
capsule render included (on the scripted crop model); without an NLF
checkpoint it draws the 2-D skeleton alone, as JAX does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from apex_studio_tpu.preprocess import dwpose as jax_dwpose
from apex_studio_tpu.preprocess import nlf as jax_nlf
from apex_studio_tpu.preprocess import nlf_render as jax_render
from apex_studio_tpu.preprocess import pose2d as jax_pose2d
from apex_studio_tpu_torch.preprocess import dwpose, nlf, nlf_render, pose2d
from tests.test_preprocess_pose2d import FakeRunner
from tests.torch_port_helpers import assert_rel_l2, jax_build, port_from_jax

TINY = nlf.NLFConfig.tiny()
IMG = np.random.default_rng(3).integers(0, 256, (240, 320, 3), dtype=np.uint8)
BOXES = np.array([[60, 40, 120, 180, 0.9], [170, 30, 110, 190, 0.8]], np.float32)
_jit = nnx.jit(lambda m, *a: m(*a))


def t(a):
    return torch.from_numpy(np.asarray(a))


def jax_tiny():
    return jax_nlf.NLFCropModel(jax_nlf.NLFConfig.tiny(), nnx.Rngs(0))


@pytest.fixture(scope="module")
def models():
    ref = jax_build(jax_tiny, seed=5)
    rng = np.random.default_rng(6)
    ref.canonical[...] = jnp.asarray(rng.normal(size=(TINY.n_points, 3)).astype(np.float32))
    return ref, port_from_jax(lambda: nlf.NLFCropModel(TINY), ref)


def crops(seed=0, n=2):
    return np.random.default_rng(seed).uniform(0, 1, (n, TINY.proc_side, TINY.proc_side, 3)).astype(np.float32)


def test_trunk_matches_jax(models):
    ref, port = models
    x = crops()
    want = nnx.jit(lambda m, a: m.backbone(a))(ref, jnp.asarray(x))
    with torch.no_grad():
        got = port.backbone(t(x))
    assert tuple(got.shape) == (2, 2, 2, TINY.backbone_channels)
    assert_rel_l2(got, want, 1e-4)


def test_field_weights_and_decode_match_jax(models):
    ref, port = models
    w_ref, b_ref = nnx.jit(lambda m: m.field_weights())(ref)
    with torch.no_grad():
        w, b = port.field_weights()
        assert_rel_l2(w, w_ref, 1e-4)
        assert_rel_l2(b, b_ref, 1e-4)
        pts = np.random.default_rng(1).normal(size=(7, 3)).astype(np.float32)
        assert_rel_l2(port.field(t(pts)), nnx.jit(lambda m, p: m.field(p))(ref, jnp.asarray(pts)), 1e-4)
        feats = np.random.default_rng(2).normal(size=(2, 2, 2, TINY.backbone_link_dim)).astype(np.float32)
        want = nnx.jit(lambda m, f, w_, b_: m.decode(f, w_, b_))(ref, jnp.asarray(feats), w_ref, b_ref)
        got = port.decode(t(feats), w, b)
    for g, wnt in zip(got, want):
        assert_rel_l2(g, wnt, 1e-4)


def test_heatmap_decode_and_reconstruction_match_jax():
    rng = np.random.default_rng(4)
    heat = rng.uniform(size=(2, 5, 8, 3, 4)).astype(np.float32)
    heat /= heat.sum(axis=(2, 3, 4), keepdims=True)
    assert_rel_l2(nlf._decode_heatmap_3d(t(heat)), jax_nlf._decode_heatmap_3d(jnp.asarray(heat)), 1e-6)
    coords2d = rng.uniform(0, TINY.proc_side, (2, 30, 2)).astype(np.float32)
    coords3d = rng.normal(scale=0.5, size=(2, 30, 3)).astype(np.float32)
    uncert = rng.uniform(0, 0.5, (2, 30)).astype(np.float32)
    k = np.stack([np.array([[90.0, 0, 32], [0, 90.0, 32], [0, 0, 1]], np.float32)] * 2)
    want = jax.jit(jax_nlf.reconstruct_absolute, static_argnums=4)(
        jnp.asarray(coords2d), jnp.asarray(coords3d), jnp.asarray(uncert), jnp.asarray(k), jax_nlf.NLFConfig.tiny())
    got = nlf.reconstruct_absolute(t(coords2d), t(coords3d), t(uncert), t(k), TINY)
    assert_rel_l2(got, want, 1e-4)


def test_warp_crop_and_crop_transforms_match_jax():
    k = nlf.intrinsics_from_fov(240, 320)
    np.testing.assert_array_equal(k, jax_nlf.intrinsics_from_fov(240, 320))
    r, new_k, scales = nlf.crop_transforms(BOXES, k, TINY.proc_side)
    for got, want in zip((r, new_k, scales), jax_nlf.crop_transforms(BOXES, k, TINY.proc_side)):
        np.testing.assert_array_equal(got, want)
    image = (IMG.astype(np.float32) / 255.0) ** 2.2
    invproj = np.linalg.inv(new_k[0] @ r[0])
    want = jax.jit(jax_nlf.warp_crop, static_argnums=3)(jnp.asarray(image), k, invproj, TINY.proc_side)
    assert_rel_l2(nlf.warp_crop(t(image), k, invproj, TINY.proc_side), want, 1e-4)
    got_crops, got_k, _ = nlf.extract_crops(t(image), BOXES, k, TINY.proc_side)
    want_crops, want_k, _ = jax_nlf.extract_crops(jnp.asarray(image), BOXES, k, TINY.proc_side)
    np.testing.assert_array_equal(got_k, want_k)
    assert_rel_l2(got_crops, want_crops, 1e-4)


def test_crop_model_matches_jax(models):
    """Uncertainties within 1e-4. The absolute joints come from a 3×3 least
    squares that a random-weight net makes near-singular (every point of a
    crop reconstructs about 800 m away): in f32 both packages are ~1e-4 from
    their f64 result (JAX 2.4e-4, the port 1.4e-4 here), so the port is held
    to be no further from the f64 forward than JAX is, and the reconstruction
    is held to JAX's in f64 on these very inputs."""
    ref, port = models
    x = crops(seed=9)
    _, new_k, _ = nlf.crop_transforms(BOXES, nlf.intrinsics_from_fov(240, 320), TINY.proc_side)
    w_ref, b_ref = nnx.jit(lambda m: m.field_weights())(ref)
    want = _jit(ref, jnp.asarray(x), w_ref, b_ref, jnp.asarray(new_k))
    feats = nnx.jit(lambda m, a: jax.nn.silu(m.link_bn(m.link_conv(m.backbone(a)))))(ref, jnp.asarray(x))
    decoded = nnx.jit(lambda m, f, w_, b_: m.decode(f, w_, b_))(ref, feats, w_ref, b_ref)
    with torch.no_grad():
        w, b = port.field_weights()
        got = port(t(x), w, b, t(new_k))
        exact = port.double()(t(x).double(), w.double(), b.double(), t(new_k).double())
        port.float()
    assert_rel_l2(got[1], want[1], 1e-4)

    def dist(a):
        a = np.asarray(a, np.float64)
        return np.linalg.norm(a - exact[0].numpy()) / np.linalg.norm(exact[0].numpy())

    assert dist(got[0]) <= max(dist(want[0]), 1e-4), (dist(got[0]), dist(want[0]))
    with jax.enable_x64(True):
        args64 = [np.asarray(a, np.float64) for a in (*decoded, new_k)]
        want64 = jax_nlf.reconstruct_absolute(*map(jnp.asarray, args64), jax_nlf.NLFConfig.tiny())
        assert want64.dtype == jnp.float64
        want64 = np.asarray(want64)
    assert_rel_l2(nlf.reconstruct_absolute(*map(t, args64), TINY), want64, 1e-9)


@pytest.fixture(scope="module")
def estimators(models):
    ref, port = models
    return jax_nlf.NLFEstimator(ref), nlf.NLFEstimator(port)


def test_estimate_on_the_tiny_net_matches_jax(estimators):
    """The whole estimator on the tiny net: its poses reconstruct far away
    (see above), project to a point and fail the box check on both sides."""
    jax_est, est = estimators
    assert jax_est.estimate(IMG, BOXES) == est.estimate(IMG, BOXES) == []
    assert est.estimate(IMG, np.zeros((0, 5), np.float32)) == []


def scripted_poses(n_boxes):
    """Crop-camera poses (N, 36, 3) mm of people 3 m away, about 1.7 m tall,
    and low uncertainties: what a trained crop model hands the filter."""
    rng = np.random.default_rng(12)
    pts = rng.normal(size=(n_boxes, TINY.n_points, 3)) * np.array([250.0, 500.0, 150.0])
    pts[..., 2] += 3000.0
    return pts.astype(np.float32), np.full((n_boxes, TINY.n_points), 0.1, np.float32)


def test_estimate_host_path_matches_jax_on_a_scripted_crop_model(estimators, monkeypatch):
    """The estimator past the crop model (the rotation back to the camera,
    the plausibility filter, pose NMS, the joint slice) on the same scripted
    crop-model output, with two overlapping boxes of one person and a third
    of another: bit-equal."""
    jax_est, est = estimators
    boxes = np.concatenate([BOXES, BOXES[:1] + np.array([4, 2, 0, 0, -0.1], np.float32)])
    poses, uncert = scripted_poses(len(boxes))
    poses[2] = poses[0] + 3.0  # the third box's person is the first one
    monkeypatch.setattr(jax_est, "_fwd", lambda *a: (jnp.asarray(poses), jnp.asarray(uncert)))
    monkeypatch.setattr(est.model, "forward", lambda *a: (t(poses), t(uncert)))
    got, want = est.estimate(IMG, boxes), jax_est.estimate(IMG, boxes)
    assert len(got) == len(want) == 2  # NMS drops the repeated person
    for g, w in zip(got, want):
        assert g.shape == (TINY.n_joints, 3)
        np.testing.assert_array_equal(g, w)


def test_published_checkpoint_loads_strictly_as_jax_converts_it(models, tmp_path):
    from apex_studio_tpu.loaders.state_mapping import apply_state_dict as jax_apply

    from apex_studio_tpu_torch.loaders.safetensors_io import save_safetensors
    from tests.torch_port_helpers import jax_params

    _, port = models
    published = nlf.nlf_published_state_dict(port)
    assert all(k.startswith("crop_model.") for k in published)
    path = tmp_path / "nlf_l_multi.safetensors"
    save_safetensors(path, {k: v.contiguous() for k, v in published.items()})
    loaded = nlf.load_nlf(path, device="cpu", cfg=TINY).model
    for name, value in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[name], value), name
    # the JAX converter maps the same names onto every JAX parameter
    jax_model = nnx.eval_shape(jax_tiny)
    jax_apply(jax_model, jax_nlf.convert_nlf_checkpoint({k: v.numpy() for k, v in published.items()},
                                                        jax_nlf.NLFConfig.tiny()), strict=True)
    ref = jax_params(jax_model)
    for name, value in ref.items():
        port_name = name[: -len("kernel")] + "weight" if name.endswith("kernel") else name
        want = torch.from_numpy(np.array(value))
        got = loaded.state_dict()[port_name]
        if got.ndim == 4:
            want = want.permute(3, 2, 0, 1)
        elif got.ndim == 2 and port_name.endswith("weight"):
            want = want.T
        assert torch.equal(got, want), name
    with pytest.raises(KeyError):  # a checkpoint without one key does not load
        nlf.convert_nlf_checkpoint({k: v for k, v in published.items() if "bn_head" not in k
                                    and not k.endswith(f"backbone.1.{len(TINY.stages) + 1}.1.weight")}, TINY)


def test_renderer_is_the_jax_one():
    rng = np.random.default_rng(7)
    people = []
    for _ in range(2):
        j = rng.normal(size=(24, 3)).astype(np.float32) * 150
        j[:, 2] += 3000
        j[rng.integers(0, 24, 3)] = 0
        people.append(j)
    k = nlf.intrinsics_from_fov(96, 128)
    args = (96, 128, k[0, 0], k[1, 1], k[0, 2], k[1, 2])
    got = nlf_render.render_capsule_frames([nlf_render.pose_cylinder_specs(people), []], *args)
    want = jax_render.render_capsule_frames([jax_render.pose_cylinder_specs(people), []], *args)
    assert len(got) == 2 and got[0].any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the DWPose host code on stand-ins ---------------------------------------------------


class ScriptedDet:
    """A ``cv2.dnn`` YOLOX net: a seeded raw head output [1, 8400, 85] with
    two people (class 0) and one animal (class 15) well above the threshold."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        pred = np.zeros((1, 8400, 85), np.float32)
        pred[0, :, :2] = rng.uniform(-0.5, 0.5, (8400, 2))
        pred[0, :, 2:4] = rng.uniform(-1, 1, (8400, 2))
        pred[0, :, 4:] = rng.uniform(0, 0.2, (8400, 81))
        base = 80 * 80 + 40 * 40  # the stride-32 grid
        for gy, gx, cls, size in ((9, 6, 0, 6.5), (10, 13, 0, 5.0), (8, 10, 15, 4.0)):
            a = base + gy * 20 + gx
            pred[0, a, 2:4] = np.log([size * 0.6, size])
            pred[0, a, 4] = 0.95
            pred[0, a, 5 + cls] = 0.9
        self.pred = pred

    def setInput(self, blob):
        assert blob.shape == (1, 3, 640, 640) and blob.dtype == np.float32

    def forward(self):
        return self.pred.copy()


class ScriptedPose:
    """A ``cv2.dnn`` SimCC net: seeded [1, 133, 576] / [1, 133, 768] outputs,
    a different draw each call."""

    def __init__(self, seed=1):
        self.rng = np.random.default_rng(seed)

    def setInput(self, blob):
        assert blob.shape == (1, 3, 384, 288)

    def getUnconnectedOutLayersNames(self):
        return ("simcc_x", "simcc_y")

    def forward(self, names):
        x = self.rng.uniform(0, 1, (1, 133, 576)).astype(np.float32)
        y = self.rng.uniform(0, 1, (1, 133, 768)).astype(np.float32)
        return [x, y]


def scripted_runner(module):
    runner = module.DWPoseRunner.__new__(module.DWPoseRunner)
    runner.det, runner.pose = ScriptedDet(), ScriptedPose()
    return runner


FRAME = np.random.default_rng(8).integers(0, 256, (360, 480, 3), dtype=np.uint8)
HOST_CASES = {
    "dwpose": ("DWPosePreprocessor", dict(stickwidth=4)),
    "dwpose_no_hands_face": ("DWPosePreprocessor", dict(detect_hands=False, detect_face=False)),
    "pose2d": ("Pose2DPreprocessor", dict(target_width=416, target_height=240)),
    "pose2d_no_head": ("Pose2DPreprocessor", dict(target_width=416, target_height=240, draw_head=False)),
    "face2d": ("Face2DPreprocessor", dict(scale=1.3)),
    "animalpose": ("AnimalPosePreprocessor", dict(threshold=0.3)),
}


def host_pair(case, runner_kind):
    cls_name, params = HOST_CASES[case]
    mods = [(jax_dwpose, jax_pose2d), (dwpose, pose2d)]
    out = []
    for dw, p2 in mods:
        cls = getattr(dw if cls_name == "DWPosePreprocessor" else p2, cls_name)
        runner = FakeRunner(*FRAME.shape[:2]) if runner_kind == "fake" else scripted_runner(dw)
        proc = cls(runner=runner)
        if runner_kind == "fake" and case == "animalpose":
            proc._detect_animals = lambda bgr, conf=0.3: np.array([[30, 40, 300, 320]], np.float32)
        out.append(proc.process_frame(FRAME, **params))
    return out


@pytest.mark.parametrize("runner_kind", ["fake", "scripted"])
@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_code_is_bit_equal_to_jax(case, runner_kind):
    want, got = host_pair(case, runner_kind)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.any()


def test_scripted_runner_detections_equal_jax():
    bgr = FRAME[..., ::-1].copy()
    boxes = scripted_runner(dwpose).detect_people(bgr)
    np.testing.assert_array_equal(boxes, scripted_runner(jax_dwpose).detect_people(bgr))
    assert boxes.shape == (2, 4)
    pts, score = scripted_runner(dwpose).pose_one(bgr, boxes[0])
    want_pts, want_score = scripted_runner(jax_dwpose).pose_one(bgr, boxes[0])
    np.testing.assert_array_equal(pts, want_pts)
    np.testing.assert_array_equal(score, want_score)


def test_dwpose_nlf_with_an_estimator_matches_jax(estimators, monkeypatch):
    """``dwpose_nlf`` through its NLF branch: the tiny net's output as it is
    (no pose passes, only the 2-D hands and face are drawn), then a scripted
    crop model whose person is drawn as capsules under them; bit-equal."""
    jax_est, est = estimators
    procs = []
    for module, estimator in ((jax_pose2d, jax_est), (pose2d, est)):
        proc = module.DWPoseNLFPreprocessor(runner=FakeRunner(240, 320))
        proc._nlf = estimator
        procs.append(proc)
    want, got = (p.process_frame(IMG) for p in procs)
    np.testing.assert_array_equal(got, want)
    overlay = dwpose.draw_wholebody([FakeRunner(240, 320).pose_one(None, None)], 240, 320, stickwidth=2, body=False)
    np.testing.assert_array_equal(got, overlay)  # no capsule: the poses failed the filter

    poses, uncert = scripted_poses(1)
    monkeypatch.setattr(jax_est, "_fwd", lambda *a: (jnp.asarray(poses), jnp.asarray(uncert)))
    monkeypatch.setattr(est.model, "forward", lambda *a: (t(poses), t(uncert)))
    want, got = (p.process_frame(IMG) for p in procs)
    np.testing.assert_array_equal(got, want)
    assert np.any(got != overlay)  # the capsule body is drawn


def test_dwpose_nlf_without_a_checkpoint_draws_the_2d_skeleton(monkeypatch, caplog):
    monkeypatch.delenv("APEX_NLF_PATH", raising=False)
    monkeypatch.setattr("apex_studio_tpu.preprocess.weights.find_local", lambda stem: None)
    monkeypatch.setattr("apex_studio_tpu_torch.preprocess.weights.find_local", lambda stem: None)
    want_proc = jax_pose2d.DWPoseNLFPreprocessor(runner=FakeRunner(240, 320))
    got_proc = pose2d.DWPoseNLFPreprocessor(runner=FakeRunner(240, 320))
    want_proc.setup()
    got_proc.setup()
    assert got_proc._nlf is None and got_proc._nlf_missing
    assert "NLF checkpoint not found" in caplog.text
    frame = np.full((240, 320, 3), 100, np.uint8)
    got = got_proc.process_frame(frame)
    np.testing.assert_array_equal(got, want_proc.process_frame(frame))
    np.testing.assert_array_equal(got, dwpose.draw_wholebody([FakeRunner(240, 320).pose_one(None, None)],
                                                             240, 320, stickwidth=6))


@pytest.mark.parametrize("name", ["dwpose", "pose2d", "face2d", "animalpose", "dwpose_nlf"])
def test_missing_onnx_files_raise(name, tmp_path, monkeypatch):
    from apex_studio_tpu_torch.preprocess.base import run_preprocessor

    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="yolox_l.onnx"):
        run_preprocessor(name, FRAME, device="cpu")
