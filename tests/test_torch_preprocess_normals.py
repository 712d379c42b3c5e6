"""The port's normal and depth preprocessors (the EfficientNet-B5 backbone,
NormalBAE, DSINE, LeReS) against the JAX package's on the CPU.

- Forwards: each JAX module seeded (``jax_build``, BN running means near 0),
  carried into the port (``loaders/from_jax.py``), f32 on the same numpy
  inputs: every output within max|Δ| ≤ 1e-4·max|ref|. EfficientNet, NNET and
  DSINE at ``EffNetConfig.tiny()`` (DSINE with 2 refinement iterations), on
  sizes whose stride-2 "SAME" pads are asymmetric; LeReS at its published
  ResNeXt101 widths on 64².
- The geometry and resampling helpers (``same_padding`` against flax's
  "SAME", the antialiased half-pixel resize, ``axis_angle_to_matrix`` with
  its small-angle branch, ``convex_upsample``, ``get_intrins_from_fov``)
  against the JAX functions.
- Converters: a file under the published names (``loaders/export.py``)
  through both converters: the port's tree loads strictly and equals what
  the JAX module, filled by the JAX loader, carries into the port.
- Preprocessors through ``run_preprocessor`` on both sides from the same
  file on disk: frames within one uint8 level (a float map truncated, then
  resized by cv2).
- A missing checkpoint raises ``FileNotFoundError``.
"""

import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.loaders.state_mapping import apply_state_dict as jax_apply
from apex_studio_tpu.preprocess import dsine as jax_dsine
from apex_studio_tpu.preprocess import efficientnet as jax_eff
from apex_studio_tpu.preprocess import leres as jax_leres
from apex_studio_tpu.preprocess import normalbae as jax_bae
from apex_studio_tpu.preprocess.base import run_preprocessor as jax_run
from apex_studio_tpu_torch.loaders.export import published_state_dict
from apex_studio_tpu_torch.preprocess import dsine, efficientnet, leres, normalbae, run_preprocessor
from tests.torch_port_helpers import assert_close, assert_loads_as_jax, jax_build_bn, port_from_jax

TINY = efficientnet.EffNetConfig.tiny()
JAX_TINY = jax_eff.EffNetConfig.tiny()

# name: (JAX module, port module, published family)
NETS = {
    "efficientnet": (lambda: jax_eff.EfficientNetFeatures(JAX_TINY, nnx.Rngs(0)),
                     lambda: efficientnet.EfficientNetFeatures(TINY), "efficientnet"),
    "normalbae": (lambda: jax_bae.NNET(JAX_TINY, nnx.Rngs(0)), lambda: normalbae.NNET(TINY), "normalbae"),
    "dsine": (lambda: jax_dsine.DSINE(JAX_TINY, nnx.Rngs(0), num_iter=2), lambda: dsine.DSINE(TINY, num_iter=2),
              "dsine"),
    "leres": (lambda: jax_leres.LeReSModel(rngs=nnx.Rngs(0)), leres.LeReSModel, "leres"),
}
_PAIRS = {}
# one jitted forward for the file: a module and input shape seen before
# reuse its compiled program (LeReS' takes seconds to compile)
jax_forward = nnx.jit(lambda m, v: m(v))


@pytest.fixture(scope="module", autouse=True)
def release_pairs():
    """Drop the cached modules with this file: their JAX arrays would stay
    live for every later file in the worker (``jax.live_arrays()``, which
    tests/test_step_mem.py reads)."""
    yield
    _PAIRS.clear()
    gc.collect()


def pair(name):
    if name not in _PAIRS:
        jax_fn, port_fn = NETS[name][:2]
        jax_model = jax_build_bn(jax_fn)
        _PAIRS[name] = jax_model, port_from_jax(port_fn, jax_model)
    return _PAIRS[name]


def frame(h=44, w=60, seed=0):
    rng = np.random.default_rng(seed)
    f = (rng.random((h, w, 3)) * 80).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    f[(yy - h // 2) ** 2 + (xx - w // 3) ** 2 <= (h // 4) ** 2] = [210, 120, 60]
    f[: h // 3, w // 2:] = np.linspace(40, 240, w - w // 2)[None, :, None].astype(np.uint8)
    return f


def intrins(h, w):
    k = jax_dsine.get_intrins_from_fov(60.0, h, w)
    k[0, 2] += 0.5
    k[1, 2] += 0.5
    return k[None]


@pytest.mark.parametrize("hw", [(64, 96), (70, 90)], ids=["even", "odd"])
def test_efficientnet_features_match_jax(hw):
    """All 12 traced features; at 70×90 the stride-2 "SAME" pads split
    unevenly (one row / column at the bottom / right)."""
    jax_model, port = pair("efficientnet")
    x = np.random.default_rng(1).normal(size=(1, *hw, 3)).astype(np.float32)
    want = jax_forward(jax_model, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("n,k,s", [(64, 3, 2), (65, 3, 2), (33, 5, 2), (32, 5, 2), (17, 3, 1), (9, 1, 2)])
def test_same_padding_is_flax_same(n, k, s):
    assert efficientnet.same_padding(n, k, s) == tuple(jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0])


def test_nnet_forward_matches_jax():
    jax_model, port = pair("normalbae")
    x = np.random.default_rng(2).normal(size=(1, 64, 96, 3)).astype(np.float32)
    want = jax_forward(jax_model, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (1, 64, 96, 4)
    assert_close(got, want)


def test_dsine_forward_matches_jax():
    """Two refinement iterations: the GRU, the neighbour rotations, the ray
    ReLU and the convex upsample."""
    jax_model, port = pair("dsine")
    x = np.random.default_rng(3).normal(size=(1, 64, 96, 3)).astype(np.float32)
    k = intrins(64, 96)
    want = nnx.jit(lambda m, v, i: m(v, i))(jax_model, jnp.asarray(x), jnp.asarray(k))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(k))
    assert got.shape == (1, 64, 96, 3)
    assert_close(got, want)


def test_leres_forward_matches_jax():
    jax_model, port = pair("leres")
    x = np.random.default_rng(4).normal(size=(1, 64, 64, 3)).astype(np.float32)
    want = jax_forward(jax_model, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (1, 64, 64, 1)
    assert_close(got, want)


def test_dsine_helpers_match_jax():
    rng = np.random.default_rng(5)
    aa = rng.normal(size=(3, 7, 3)).astype(np.float32)
    aa[0, :3] *= 1e-7  # the small-angle series
    assert_close(dsine.axis_angle_to_matrix(torch.from_numpy(aa)), jax_dsine.axis_angle_to_matrix(jnp.asarray(aa)))
    out = rng.normal(size=(1, 5, 6, 3)).astype(np.float32)
    mask = rng.normal(size=(1, 5, 6, 9 * 4 * 4)).astype(np.float32)
    assert_close(dsine.convex_upsample(torch.from_numpy(out), torch.from_numpy(mask), 4),
                 jax_dsine.convex_upsample(jnp.asarray(out), jnp.asarray(mask), 4))
    x = rng.normal(size=(1, 12, 20, 3)).astype(np.float32)
    for h, w in ((24, 40), (7, 9)):  # up, and down with the antialias
        assert_close(dsine._resize_half_pixel(torch.from_numpy(x), h, w),
                     jax_dsine._resize_half_pixel(jnp.asarray(x), h, w))
    np.testing.assert_array_equal(dsine.get_intrins_from_fov(55.0, 300, 420),
                                  jax_dsine.get_intrins_from_fov(55.0, 300, 420))


# -- converters ------------------------------------------------------------------------

JAX_CONVERTERS = {"efficientnet": jax_eff.convert_timm_efficientnet, "normalbae": jax_bae.convert_nnet_keys,
                  "dsine": jax_dsine.convert_dsine_keys, "leres": jax_leres.convert_leres_keys}
PORT_CONVERTERS = {"efficientnet": efficientnet.convert_timm_efficientnet, "normalbae": normalbae.convert_nnet_keys,
                   "dsine": dsine.convert_dsine_keys, "leres": leres.convert_leres_keys}
EXPECTED_NAMES = {
    "efficientnet": {"conv_stem.weight", "bn1.running_var", "blocks.0.0.se.conv_reduce.bias",
                     "blocks.6.0.conv_pwl.weight", "blocks.3.0.bn3.running_mean", "conv_head.weight"},
    "normalbae": {"encoder.original_model.blocks.1.0.bn2.weight", "decoder.conv2.weight",
                  "decoder.up4._net.4.running_var", "decoder.out_conv_res1.6.weight", "decoder.out_conv_res8.bias"},
    "dsine": {"encoder.original_model.bn2.running_mean", "decoder.up2._net.3.weight", "decoder.up1._net.1.weight",
              "decoder.hidden_head.4.bias", "up_prob_head.0.weight", "gru.convq.weight"},
    "leres": {"module.encoder_modules.layer3.22.conv2.weight",
              "module.encoder_modules.layer1.0.downsample.1.running_var",
              "module.decoder_modules.ffm0.ftb2.conv_branch.2.weight",
              "module.decoder_modules.outconv.adapt_conv.3.bias",
              "module.decoder_modules.conv1.weight"},
}


def published(name):
    return published_state_dict(NETS[name][2], pair(name)[1].state_dict())


@pytest.mark.parametrize("name", list(NETS))
def test_converters_agree_with_jax(name):
    sd = published(name)
    assert EXPECTED_NAMES[name] <= set(sd)
    if name == "normalbae":  # the heads' Conv1d weights, as published
        assert sd["decoder.out_conv_res4.0.weight"].ndim == 3
    ref = nnx.eval_shape(NETS[name][0])  # every parameter comes from the file
    jax_apply(ref, JAX_CONVERTERS[name]({k: v.numpy() for k, v in sd.items()}), strict=True)
    assert_loads_as_jax(NETS[name][1], PORT_CONVERTERS[name](sd), ref)


# -- preprocessors ----------------------------------------------------------------------

CASES = {
    "normalbae": ("scannet.pt", {"model": None}, {"detect_resolution": 64}),
    "dsine": ("dsine.pt", {"model": None}, {"detect_resolution": 64, "fov": 50.0, "iterations": 2}),
    "leres": ("res101.pth", {"depth_model": None}, {"detect_resolution": 64}),
    "leres_thresholds": ("res101.pth", {"depth_model": None}, {"detect_resolution": 64, "thr_a": 20, "thr_b": 10}),
}


@pytest.fixture()
def models_dir(tmp_path, monkeypatch):
    """An empty preprocessor models dir; both sides' B5 config the tiny
    one; the JAX nets built abstractly (their checkpoint fills every
    parameter)."""
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    monkeypatch.setattr(efficientnet.EffNetConfig, "b5", classmethod(lambda cls: TINY))
    monkeypatch.setattr(jax_eff.EffNetConfig, "b5", classmethod(lambda cls: JAX_TINY))
    for module, cls_name in ((jax_bae, "NNET"), (jax_dsine, "DSINE"), (jax_leres, "LeReSModel")):
        cls = getattr(module, cls_name)
        monkeypatch.setattr(module, cls_name, lambda *a, _cls=cls, **kw: nnx.eval_shape(
            lambda: _cls(*a, **{**kw, "rngs": nnx.Rngs(0)})))
    return tmp_path


@pytest.mark.parametrize("case", list(CASES))
def test_preprocessor_matches_jax(case, models_dir):
    filename, container, params = CASES[case]
    name = case.split("_")[0]
    key = next(iter(container))
    torch.save({key: published(name)}, models_dir / filename)
    # LeReS compiles its JAX forward per shape: its frames go to the 64²
    # of its forward test
    frames = [frame(44, 44, seed=6), frame(44, 44, seed=7)] if name == "leres" else [frame(seed=6),
                                                                                    frame(50, 40, seed=7)]
    want = jax_run(name, frames, dict(params))
    got = run_preprocessor(name, frames, dict(params), device="cpu")
    assert len(got) == len(want) == 2
    for g, w, f in zip(got, want, frames):
        assert g.shape == w.shape == f.shape and g.dtype == w.dtype == np.uint8
        assert len(np.unique(g)) > 1, "a constant frame: the comparison tests nothing"
        if case != "leres_thresholds":
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
    if case.startswith("leres"):
        # The to-zero thresholds cut the 8-bit map, where a value one level
        # off its threshold falls to 0: held on the depth before them, and
        # the host rendering on the JAX depth gives the JAX frame.
        proc = leres.LeReSPreprocessor()
        proc.device = "cpu"
        proc.setup()
        jax_model = pair("leres")[0]  # the weights of the file both sides loaded
        for f, w in zip(frames, want):
            got_depth, want_depth = proc.depth(f, 64), jax_leres_depth(jax_model, f, 64)
            assert_close(got_depth, want_depth)
            np.testing.assert_array_equal(leres.render_depth(want_depth, f.shape[:2], params.get("thr_a", 0),
                                                             params.get("thr_b", 0)), w)


def jax_leres_depth(model, f, res):
    """The JAX preprocessor's depth before the rendering, through its steps."""
    import cv2

    h0, w0 = f.shape[:2]
    k = float(res) / float(min(h0, w0))
    ht, wt = int(round(h0 * k)), int(round(w0 * k))
    img = cv2.resize(f, (wt, ht), interpolation=cv2.INTER_CUBIC if k > 1 else cv2.INTER_AREA)
    img = np.pad(img, [[0, (-ht) % 64], [0, (-wt) % 64], [0, 0]], mode="edge")
    x = (img.astype(np.float32) / 255.0 - jax_leres._MEAN) / jax_leres._STD
    return np.asarray(jax_forward(model, jnp.asarray(x)[None]))[0, :ht, :wt, 0]


MISSING = {"normalbae": "scannet.pt", "dsine": "dsine.pt", "leres": "res101.pth"}


@pytest.mark.parametrize("name", list(MISSING))
def test_missing_checkpoint_raises(name, tmp_path, monkeypatch):
    """Nothing is fetched: the published file's name and the directory are
    in the error."""
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=MISSING[name]) as err:
        run_preprocessor(name, frame(), device="cpu")
    assert str(tmp_path) in str(err.value)
