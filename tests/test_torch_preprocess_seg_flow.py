"""The port's background removal, anime segmentation and optical flow (U²-Net
full and light, ISNet, the anime face U-Net, GMFlow in its three published
configurations) against the JAX package's on the CPU. GMFlow's tests are in
``tests/test_torch_preprocess_flow.py`` (one file each, so that the test
workers split them), on this file's helpers.

- Forwards: each JAX module seeded (``jax_build``, BN running means near 0),
  carried into the port (``loaders/from_jax.py``), f32 on the same numpy
  inputs: ‖Δ‖ ≤ 1e-4·‖ref‖. GMFlow's two-scale configurations are held at
  5e-4 as a whole: their second scale samples the first scale's flow-warped
  features, which at seeded weights vary from pixel to pixel like noise, so
  the f32 rounding of the coarse flow grows to about 1e-4 of the output on
  either side (each of the two f32 forwards is 1.1–1.6e-4 from an f64 run of
  the port); the scale-2 pieces (the warp, the local correlations, the
  local propagation, the trident encoder, the shifted windows of 8, the
  refinement's update block) are each held at 1e-4.
- Converters: a file under the published names (``loaders/export.py``)
  through both converters: the port's tree loads strictly and equals what
  the JAX module, filled from the JAX converter's tree, carries into the
  port. ``isnetis.ckpt`` is written as Lightning writes it (``state_dict``
  beside the trainer's state, an ``argparse.Namespace`` and a dict subclass
  among it, and the training-only keys).
- Preprocessors through ``run_preprocessor`` on both sides from the same
  files on disk: the float maps within 1e-4 (rembg's saliency, the anime
  matte and class probabilities, GMFlow-scale1's flow; the two-scale flows
  within 5e-4, as above), the frames' shapes and dtypes equal (rembg's RGBA
  4 channels) and their values equal but on ties: at most 1% of the pixels
  may differ, by one uint8 level where a float is truncated (rembg's mask,
  the flow colours) and by a palette colour where an argmax sits on a tie
  (the face classes).
- Departures: a missing file raises ``FileNotFoundError``; a checkpoint
  with one missing or one extra key raises.
"""

import argparse
import dataclasses
import functools
import gc

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.preprocess import anime_seg as jax_anime
from apex_studio_tpu.preprocess import u2net as jax_u2net
from apex_studio_tpu.preprocess import unimatch as jax_flow
from apex_studio_tpu.preprocess.base import preprocessor_registry as jax_registry
from apex_studio_tpu_torch.loaders.export import published_state_dict
from apex_studio_tpu_torch.preprocess import anime_seg, run_preprocessor, u2net, unimatch
from apex_studio_tpu_torch.preprocess.weights import load_preprocessor_weights
from tests.torch_port_helpers import (assert_loads_as_jax, assert_rel_l2, jax_assign, jax_build, jax_build_bn,
                                      port_from_jax)

jax_forward = nnx.jit(lambda m, *v: m(*v))


def flow_cfg(name):
    return dataclasses.replace(jax_flow.GMFLOW_CONFIGS[name]), unimatch.GMFlowConfig(
        **dataclasses.asdict(jax_flow.GMFLOW_CONFIGS[name]))


# name: (JAX module, port module, the published family, forward input shapes, input range, rel L2)
NETS = {
    "u2net": (lambda: jax_u2net.U2Net(rngs=nnx.Rngs(0)), u2net.U2Net, "u2net", [(1, 40, 52, 3)], 2.0, 1e-4),
    "u2netp": (lambda: jax_u2net.U2Net(light=True, rngs=nnx.Rngs(0)), lambda: u2net.U2Net(light=True), "u2net",
               None, 2.0, 1e-4),
    "isnet": (lambda: jax_anime.ISNetDIS(rngs=nnx.Rngs(0)), anime_seg.ISNetDIS, "isnet", None, 1.0, 1e-4),
    "anime_face": (lambda: jax_anime.AnimeFaceUNet(rngs=nnx.Rngs(0)), anime_seg.AnimeFaceUNet, "anime_face", None,
                   1.0, 1e-4),
    **{v: (lambda v=v: jax_flow.GMFlow(flow_cfg(v)[0], rngs=nnx.Rngs(0)),
           lambda v=v: unimatch.GMFlow(flow_cfg(v)[1]), "gmflow", [(1, 64, 64, 3)] * 2, 255.0,
           1e-4 if v == "gmflow-scale1" else 5e-4) for v in jax_flow.GMFLOW_CONFIGS},
}
_PAIRS = {}


@pytest.fixture(scope="module", autouse=True)
def release_pairs():
    """Drop the cached modules with this file (their JAX arrays would stay
    live for the rest of the worker)."""
    yield
    _PAIRS.clear()
    gc.collect()


def pair(name):
    """(JAX module, port module) with the JAX module's seeded weights."""
    if name not in _PAIRS:
        jax_fn, port_fn = NETS[name][:2]
        jax_model = jax_build_bn(jax_fn)
        _PAIRS[name] = jax_model, port_from_jax(port_fn, jax_model)
    return _PAIRS[name]


def as_np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def is_flow(name: str) -> bool:
    return name.startswith("gmflow")


@pytest.mark.parametrize("name", [n for n in NETS if NETS[n][3] and not is_flow(n)])
def test_forward_matches_jax(name):
    """u2netp, ISNet and the anime U-Net are held through their
    preprocessors' own compiled programs (``test_rembg_matches_jax``,
    ``test_anime_face_segment_matches_jax``). The
    two-scale GMFlows' JAX forwards run op by op: XLA takes over a minute on
    this CPU to compile the refinement's six unrolled iterations of 81-tap
    sampling, and op by op the taps share their compiled programs."""
    jax_model, port = pair(name)
    shapes, scale, tol = NETS[name][3:]
    rng = np.random.default_rng(1)
    xs = [(rng.random(s) * scale - (1.0 if scale == 2.0 else 0.0)).astype(np.float32) for s in shapes]
    eager = name.startswith("gmflow-scale2")
    want = (jax_model if eager else functools.partial(jax_forward, jax_model))(*[jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = port(*[torch.from_numpy(x) for x in xs])
    assert_rel_l2(got, as_np(want), tol)


def test_u2net_resize_and_pool_are_jax_ones():
    """``_up_to`` is ``jax.image.resize`` bilinear (half-pixel, here from the
    odd sizes a ceil-mode pool leaves); ``_pool`` the ceil-mode max pool."""
    x = np.random.default_rng(4).normal(size=(1, 7, 9, 3)).astype(np.float32)
    ref = np.zeros((1, 13, 17, 3), np.float32)
    assert_rel_l2(u2net._up_to(torch.from_numpy(x), torch.from_numpy(ref)),
                  as_np(jax_u2net._up_to(jnp.asarray(x), jnp.asarray(ref))), 1e-6)
    np.testing.assert_array_equal(as_np(u2net._pool(torch.from_numpy(x))), as_np(jax_u2net._pool(jnp.asarray(x))))


# -- converters ------------------------------------------------------------------------


class _AttributeDict(dict):
    """What Lightning pickles ``hyper_parameters`` as."""


def lightning_container(state: dict) -> dict:
    """A Lightning checkpoint around ``state``: trainer state beside it that
    ``weights_only`` refuses (a ``Namespace``, a dict subclass)."""
    return {"state_dict": state, "epoch": 3, "global_step": 1200, "pytorch-lightning_version": "1.9.4",
            "hyper_parameters": _AttributeDict(net_name="isnet_is", img_size=1024, lr=1e-4),
            "hparams": argparse.Namespace(batch_size=2),
            "optimizer_states": [{"state": {0: {"exp_avg": torch.zeros(3)}}, "param_groups": [{"lr": 1e-4}]}],
            "callbacks": {"ModelCheckpoint": {"best_model_score": torch.tensor(0.1)}}}


def published(name):
    """A state dict under the published names holding ``pair(name)``'s port
    weights; ISNet's with the keys inference does not read (the side
    outputs 2 to 6 and the ground-truth encoder), as the published file has
    them."""
    port = pair(name)[1]
    sd = published_state_dict(NETS[name][2], port.state_dict())
    if name == "isnet":
        g = torch.Generator().manual_seed(5)
        sd.update({f"net.side{i}.weight": torch.randn(1, 64, 3, 3, generator=g) for i in range(2, 7)})
        sd.update({"gt_encoder.conv_in.weight": torch.randn(16, 1, 3, 3, generator=g),
                   "gt_encoder.stage1.rebnconvin.bn_s1.num_batches_tracked": torch.tensor(7)})
    return sd


JAX_CONVERT = {
    "u2net": lambda sd, m: jax_u2net._finalize_u2net_tree(jax_u2net.convert_u2net_keys(sd), m),
    "isnet": lambda sd, m: jax_anime._finalize_isnet_tree(jax_anime.convert_isnet_keys(sd), m),
    "anime_face": lambda sd, m: jax_anime.convert_anime_face_keys(sd),
    "gmflow": lambda sd, m: jax_flow.convert_gmflow_keys(sd),
}
PORT_CONVERT = {
    "u2net": lambda sd, build: u2net.u2net_converter(build)(sd),
    "isnet": lambda sd, build: anime_seg._isnet_convert(sd),
    "anime_face": lambda sd, build: anime_seg.convert_anime_face_keys(sd),
    "gmflow": lambda sd, build: unimatch.convert_gmflow_keys(sd),
}
EXPECTED_NAMES = {
    "u2net": {"stage1.rebnconv7.conv_s1.weight", "stage1d.rebnconv6d.bn_s1.running_var",
              "stage5.rebnconv4.conv_s1.bias", "stage4d.rebnconvin.bn_s1.weight", "side6.weight", "outconv.weight"},
    "isnet": {"net.conv_in.weight", "net.stage2d.rebnconv1d.conv_s1.weight", "net.stage6.rebnconv3d.bn_s1.weight",
              "net.side1.bias"},
    "anime_face": {"en_block0.0.0.weight", "en_block0.1.conv.0.1.running_mean", "en_block0.1.conv.2.weight",
                   "en_block3.6.conv.1.0.weight", "en_block4.2.conv.3.running_var", "de_block0.1.bias"},
    "gmflow": {"backbone.layer2.0.downsample.0.bias", "transformer.layers.5.cross_attn_ffn.mlp.2.weight",
               "transformer.layers.0.self_attn.norm1.bias", "feature_flow_attn.k_proj.bias"},
}


@pytest.mark.parametrize("name", [n for n in NETS if not is_flow(n)])
def test_converters_agree_with_jax(name, tmp_path):
    """The published file through each side's converter (ISNet's through
    ``weights.py`` from its Lightning checkpoint on disk)."""
    family = NETS[name][2]
    sd = published(name)
    assert EXPECTED_NAMES[family] <= set(sd)
    if name == "gmflow-scale2":
        assert "backbone.trident_conv.weight" in sd and "upsampler.2.weight" in sd
    if name == "gmflow-scale2-regrefine6":
        assert {"refine.mask.2.weight", "refine.gru.convq2.bias", "refine_proj.weight"} <= set(sd)
    if name == "isnet":
        torch.save(lightning_container(sd), tmp_path / "isnetis.ckpt")
        sd = load_preprocessor_weights("isnet_anime", filename="isnetis.ckpt", root=tmp_path)
    jax_fn, port_fn = NETS[name][:2]
    ref = nnx.eval_shape(jax_fn)  # every parameter comes from the file
    jax_assign(ref, JAX_CONVERT[family]({k: v.numpy() for k, v in sd.items()}, ref))
    assert_loads_as_jax(port_fn, PORT_CONVERT[family](sd, port_fn), ref)


def test_lightning_checkpoint_keeps_only_the_weights(tmp_path):
    """``weights.py`` reads a Lightning checkpoint whose trainer state
    ``weights_only`` refuses: the unwrapped ``state_dict``'s tensors, and
    nothing of the trainer's state."""
    state = {"net.conv_in.weight": torch.ones(2, 3), "net.conv_in.bias": torch.zeros(2)}
    torch.save(lightning_container(state), tmp_path / "isnetis.ckpt")
    with pytest.raises(Exception):
        torch.load(tmp_path / "isnetis.ckpt", weights_only=True)
    sd = load_preprocessor_weights("isnet_anime", filename="isnetis.ckpt", root=tmp_path)
    assert set(sd) == set(state) and all(torch.equal(sd[k], v) for k, v in state.items())


# -- preprocessors ----------------------------------------------------------------------

# the JAX nets the preprocessors build, by module and global name
JAX_NETS = {"u2net": (jax_u2net, "U2Net"), "anime": (jax_anime, "AnimeFaceUNet"), "isnet": (jax_anime, "ISNetDIS"),
            "gmflow": (jax_flow, "GMFlow")}


@pytest.fixture()
def models_dir(tmp_path, monkeypatch):
    """An empty preprocessor models dir; the JAX nets built abstractly (their
    checkpoint fills every parameter) rather than by flax's initialisers."""
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    for module, cls_name in JAX_NETS.values():
        cls = getattr(module, cls_name)
        monkeypatch.setattr(module, cls_name, lambda *a, _cls=cls, **kw: nnx.eval_shape(
            lambda: _cls(*a, **{**kw, "rngs": nnx.Rngs(0)})))
    return tmp_path


def frame(h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    f = (rng.random((h, w, 3)) * 60).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    f[(yy - h // 2) ** 2 + (xx - w // 3) ** 2 <= (h // 4) ** 2] = [210, 120, 60]
    f[4:12, w // 2:w - 4] = [40, 200, 90]
    return f


def moving_clip(n=3, h=48, w=64):
    base = frame(h, w + 2 * n, seed=9)
    return [np.ascontiguousarray(base[:, 2 * i:2 * i + w]) for i in range(n)]


def assert_frames_close(got, want, max_share=0.01, max_level=1, palette=False):
    """Equal shapes and dtypes; values equal but on at most ``max_share`` of
    the pixels, which differ by at most ``max_level`` (any palette colour
    with ``palette``)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        diff = np.abs(g.astype(int) - w.astype(int))
        assert (diff.max(axis=-1) > 0).mean() <= max_share, (diff.max(axis=-1) > 0).mean()
        if not palette:
            assert diff.max() <= max_level, diff.max()


# each net's file under the JAX module's stem (the JAX loader finds no other
# name, and reads a container only under ``state_dict``) and under its
# published name and container (found by the port only)
JAX_FILE = {"u2net": "u2net.pth", "u2netp": "u2netp.pth", "anime_face": "anime_face_segment.pth",
            "isnet": "isnet_anime.pth", **{v: f"{v}.pth" for v in unimatch.GMFLOW_FILES}}
PUBLISHED_FILE = {"u2net": "u2net.pth", "u2netp": "u2netp.pth", "anime_face": "Annotators/UNet.pth",
                  "isnet": "isnetis.ckpt", **unimatch.GMFLOW_FILES}


def write_checkpoint(models_dir, net, published_layout=False):
    """``published(net)`` under the JAX stem (ISNet's in a Lightning
    container of plain types) or, with ``published_layout``, under the
    published name and container (ISNet's Lightning checkpoint with the
    trainer state ``weights_only`` refuses, GMFlow's under ``model``)."""
    sd = published(net)
    if not published_layout:
        obj = {"state_dict": sd, "epoch": 3, "global_step": 1200} if net == "isnet" else sd
        path = models_dir / JAX_FILE[net]
    else:
        obj = lightning_container(sd) if net == "isnet" else ({"model": sd} if net.startswith("gmflow") else sd)
        path = models_dir / PUBLISHED_FILE[net]
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(obj, path)
    return path


# rembg's params in turn on one preprocessor a side (its compiled forward reused)
REMBG_PARAMS = [{}, {"only_mask": True, "post_process_mask": True}, {"bgcolor": [30, 60, 90]}]


def test_rembg_matches_jax(models_dir):
    """u2netp at rembg's 320² through the JAX and the port preprocessor (the
    full U²-Net is held in ``test_forward_matches_jax``)."""
    write_checkpoint(models_dir, "u2netp")
    frames = [frame(seed=1)]
    jax_proc = jax_registry.get("rembg")()
    port_proc = u2net.RembgPreprocessor()
    for params in REMBG_PARAMS:
        params = {"model_name": "u2netp", **params}
        want = jax_proc(frames, **params)
        got = port_proc(frames, device="cpu", **params)
        assert got[0].shape == (48, 64, 3 if params.get("only_mask") else 4)
        assert_frames_close(got, want)
    assert_rel_l2(port_proc.predict_mask(frames[0]), jax_proc.predict_mask(frames[0], "u2netp"), 1e-4)
    # the module at rembg's input, through the JAX preprocessor's compiled forward
    x = np.random.default_rng(6).normal(size=(1, 320, 320, 3)).astype(np.float32)
    fwd, state = jax_proc._fwd
    with torch.no_grad():
        assert_rel_l2(port_proc.model(torch.from_numpy(x)), as_np(fwd(state, jnp.asarray(x))), 1e-4)


def test_anime_face_segment_matches_jax(models_dir):
    """With and without the matting, one preprocessor a side; ISNet and the
    U-Net (and the matte and class probabilities behind the argmax) through
    the JAX preprocessor's compiled forwards."""
    import cv2

    write_checkpoint(models_dir, "anime_face")
    write_checkpoint(models_dir, "isnet")
    frames = [frame(seed=2)]
    jax_proc = jax_registry.get("AnimeFaceSegmentor")()
    port_proc = anime_seg.AnimeFaceSegmentPreprocessor()
    for remove_background in (True, False):
        params = {"detect_resolution": 64, "remove_background": remove_background}
        want = jax_proc(frames, **params)
        got = port_proc(frames, device="cpu", **params)
        assert_frames_close(got, want, palette=True)
        assert len(np.unique(got[0].reshape(-1, 3), axis=0)) > 1
    _, seg_state = nnx.split(jax_proc.seg_model)
    _, state = nnx.split(jax_proc.model)
    img = cv2.resize(frames[0], (64, 64), interpolation=cv2.INTER_CUBIC)
    matte = port_proc.matte(img)
    assert_rel_l2(matte, as_np(jax_proc._seg_fwd(seg_state, jnp.asarray(img.astype(np.float32) / 255.0)[None]))[0],
                  1e-4)
    matted = (matte * img + 255.0 * (1 - matte)).astype(np.uint8)
    assert_rel_l2(port_proc.class_probs(matted),
                  as_np(jax_proc._fwd(state, jnp.asarray(matted.astype(np.float32) / 255.0)[None]))[0], 1e-4)
    x = np.random.default_rng(7).random((1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        assert_rel_l2(torch.sigmoid(port_proc.seg_model(torch.from_numpy(x))),
                      as_np(jax_proc._seg_fwd(seg_state, jnp.asarray(x))), 1e-4)
        assert_rel_l2(port_proc.model(torch.from_numpy(x)), as_np(jax_proc._fwd(state, jnp.asarray(x))), 1e-4)


PUBLISHED_CASES = {"rembg": (["u2netp"], {"model_name": "u2netp"}),
                   "anime_face_segment": (["anime_face", "isnet"], {"detect_resolution": 64}),
                   "ptlflow": (["gmflow-scale2-regrefine6"], {"variant": "gmflow-scale2-regrefine6",
                                                               "detect_resolution": 64})}


@pytest.mark.parametrize("name", [n for n in PUBLISHED_CASES if n != "ptlflow"])
def test_published_file_names_are_found(name, tmp_path, monkeypatch):
    """The published files, folders and containers included
    (``Annotators/UNet.pth``, the Lightning ``isnetis.ckpt``, GMFlow's
    ``model``), give what the files under the stems give. (The JAX loader
    finds neither name and reads no ``model`` container: given GMFlow's
    published file it would run random weights.)"""
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    nets, params = PUBLISHED_CASES[name]
    clip = moving_clip(2)
    stems = [write_checkpoint(tmp_path, net) for net in nets]
    want = run_preprocessor(name, clip, dict(params), device="cpu")
    for path in stems:
        path.unlink()
    for net in nets:
        write_checkpoint(tmp_path, net, published_layout=True)
    got = run_preprocessor(name, clip, dict(params), device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- departures -------------------------------------------------------------------------

MISSING = {"rembg": ("u2net.pth", {}), "anime_face_segment": ("UNet.pth", {}),
           "optical_flow": ("gmflow-scale1-mixdata.pth", {})}


@pytest.mark.parametrize("name", [n for n in MISSING if n != "optical_flow"])
def test_missing_checkpoint_raises(name, tmp_path, monkeypatch):
    """Nothing is fetched and no random net stands in: the published file's
    name and the directory are in the error."""
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    filename, params = MISSING[name]
    with pytest.raises(FileNotFoundError, match=filename) as err:
        run_preprocessor(name, [frame(), frame(seed=1)], dict(params), device="cpu")
    assert str(tmp_path) in str(err.value)


def test_missing_matting_checkpoint_raises(tmp_path, monkeypatch):
    """With ``remove_background`` the matting file is needed too."""
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    write_checkpoint(tmp_path, "anime_face")
    with pytest.raises(FileNotFoundError, match="isnetis.ckpt"):
        run_preprocessor("anime_face_segment", frame(), {"detect_resolution": 64}, device="cpu")
    out = run_preprocessor("anime_face_segment", frame(), {"detect_resolution": 64, "remove_background": False},
                           device="cpu")
    assert out[0].shape == (48, 64, 3)


# the net whose file is faulted, and the call that loads it
FAULT_CASES = {"u2netp": ("rembg", {"model_name": "u2netp"}), "isnet": ("anime_face_segment", {}),
               "anime_face": ("anime_face_segment", {"remove_background": False}),
               "gmflow-scale1": ("optical_flow", {})}


@pytest.mark.parametrize("net", [n for n in FAULT_CASES if not is_flow(n)])
@pytest.mark.parametrize("fault", ["missing_key", "extra_key"])
def test_checkpoint_with_a_key_missing_or_extra_raises(net, fault, tmp_path, monkeypatch):
    """The load is strict: one key taken out, or one unknown key added,
    raises (the JAX preprocessors load what matches and leave the rest
    random)."""
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    if net == "isnet":
        write_checkpoint(tmp_path, "anime_face")
    path = write_checkpoint(tmp_path, net, published_layout=True)
    sd = published(net)
    prefix = "net." if net == "isnet" else ""
    if fault == "missing_key":
        sd.pop(sorted(k for k in sd if k.startswith((f"{prefix}stage", "en_block", "backbone")))[0])
    else:
        sd[f"{prefix}{'backbone' if net.startswith('gmflow') else 'stage1'}.extra.weight"] = torch.zeros(3)
        if net == "anime_face":
            sd["en_block0.extra.weight"] = sd.pop("stage1.extra.weight")
    torch.save(lightning_container(sd) if net == "isnet" else sd, path)
    name, params = FAULT_CASES[net]
    with pytest.raises(KeyError):
        run_preprocessor(name, [frame(), frame(seed=1)], {"detect_resolution": 64, **params}, device="cpu")
