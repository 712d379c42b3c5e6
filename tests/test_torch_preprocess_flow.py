"""The port's optical flow (GMFlow in its three published configurations:
the forwards, the second scale's pieces, the converters, the flow and
unimatch preprocessors, the published file names, the departures) against
the JAX package's on the CPU, on the helpers of
``tests/test_torch_preprocess_seg_flow.py``, whose docstring gives the
tolerances; the two files split one set of tests between the test workers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.preprocess import unimatch as jax_flow
from apex_studio_tpu.preprocess.base import preprocessor_registry as jax_registry
from apex_studio_tpu_torch.preprocess import run_preprocessor, unimatch
from apex_studio_tpu_torch.preprocess.weights import load_preprocessor_weights
from tests import test_torch_preprocess_seg_flow as seg
from tests.test_torch_preprocess_seg_flow import (as_np, assert_frames_close, frame, models_dir,  # noqa: F401
                                                  moving_clip, published, release_pairs, write_checkpoint)
from tests.torch_port_helpers import assert_rel_l2, jax_build, port_from_jax


@pytest.mark.parametrize("name", [n for n in seg.NETS if seg.NETS[n][3] and seg.is_flow(n)])
def test_forward_matches_jax(name):
    """GMFlow's forwards (``seg.test_forward_matches_jax``)."""
    seg.test_forward_matches_jax(name)


def test_gmflow_scale2_pieces_match_jax():
    """The second scale's functions and modules at 1e-4, at the shapes the
    64² forwards give them (so that JAX, op by op, reuses the programs
    ``test_forward_matches_jax`` compiled): the features at 16², the
    8-split shifted windows, the 81-tap correlations, the local
    propagation, the trident encoder, the refinement's update block."""
    rng = np.random.default_rng(2)
    f0, f1 = (rng.normal(size=(1, 16, 16, 128)).astype(np.float32) for _ in range(2))
    flow = (3 * rng.normal(size=(1, 16, 16, 2))).astype(np.float32)
    t, j = (lambda a: torch.from_numpy(a)), jnp.asarray
    assert_rel_l2(unimatch.flow_warp(t(f1), t(flow)), as_np(jax_flow.flow_warp(j(f1), j(flow))), 1e-5)
    assert_rel_l2(unimatch.local_correlation_flow(t(f0), t(f1), 4),
                  as_np(jax_flow.local_correlation_flow(j(f0), j(f1), 4)), 1e-4)
    assert_rel_l2(unimatch.local_correlation_with_flow(t(f0), t(f1), t(flow), 4),
                  as_np(jax_flow.local_correlation_with_flow(j(f0), j(f1), j(flow), 4)), 1e-5)
    assert_rel_l2(unimatch._resize_align_corners(t(flow), 32, 32),
                  as_np(jax_flow._resize_align_corners(j(flow), 32, 32)), 1e-5)
    np.testing.assert_array_equal(unimatch.swin_shift_mask(16, 16, 8), jax_flow.swin_shift_mask(16, 16, 8))
    np.testing.assert_array_equal(unimatch.sine_position(2, 2, 128), jax_flow.sine_position(2, 2, 128))
    q = rng.normal(size=(2, 256, 128)).astype(np.float32)
    mask = unimatch.swin_shift_mask(16, 16, 8)
    for shift in (False, True):
        assert_rel_l2(unimatch._swin_attention(t(q), t(q[::-1].copy()), t(q), 16, 16, 8, shift, t(mask)),
                      as_np(jax_flow._swin_attention(j(q), j(q[::-1].copy()), j(q), 16, 16, 8, shift, j(mask))),
                      1e-5)
    prop = jax_build(lambda: jax_flow.SelfAttnPropagation(128, rngs=nnx.Rngs(0)))
    port = port_from_jax(lambda: unimatch.SelfAttnPropagation(128), prop)
    with torch.no_grad():
        for radius in (0, 1):
            assert_rel_l2(port(t(f0), t(flow), radius), as_np(prop(j(f0), j(flow), radius)), 1e-5)
    enc = jax_build(lambda: jax_flow.CNNEncoder(128, 2, rngs=nnx.Rngs(0)))
    port = port_from_jax(lambda: unimatch.CNNEncoder(128, 2), enc)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        for g, w in zip(port(t(x)), enc(j(x))):
            assert_rel_l2(g, as_np(w), 1e-4)
    upd = jax_build(lambda: jax_flow.BasicUpdateBlock(downsample_factor=4, rngs=nnx.Rngs(0)))
    port = port_from_jax(lambda: unimatch.BasicUpdateBlock(downsample_factor=4), upd)
    net, inp = (rng.normal(size=(1, 16, 16, 128)).astype(np.float32) for _ in range(2))
    corr = rng.normal(size=(1, 16, 16, 81)).astype(np.float32)
    with torch.no_grad():
        for g, w in zip(port(t(net), t(inp), t(corr), t(flow)), upd(j(net), j(inp), j(corr), j(flow))):
            assert_rel_l2(g, as_np(w), 1e-4)
    mask_up = rng.normal(size=(1, 16, 16, 9 * 16)).astype(np.float32)
    assert_rel_l2(unimatch.upsample_flow_with_mask(t(flow), t(mask_up), 4),
                  as_np(jax_flow.upsample_flow_with_mask(j(flow), j(mask_up), 4)), 1e-5)


def test_flow_to_image_is_the_jax_one():
    flow = (5 * np.random.default_rng(3).normal(size=(40, 56, 2))).astype(np.float32)
    np.testing.assert_array_equal(unimatch.flow_to_image(flow), jax_flow.flow_to_image(flow))


@pytest.mark.parametrize("name", [n for n in seg.NETS if seg.is_flow(n)])
def test_converters_agree_with_jax(name, tmp_path):
    """GMFlow's published files through both converters
    (``seg.test_converters_agree_with_jax``)."""
    seg.test_converters_agree_with_jax(name, tmp_path)


@pytest.mark.parametrize("name,variant", [("optical_flow", "gmflow-scale1"), ("unimatch", "gmflow-scale2")])
def test_optical_flow_matches_jax(name, variant, models_dir, monkeypatch):
    """Three frames at scale1 (two flows, the last repeated), a pair at
    scale2, whose JAX forward runs op by op (``jax.jit`` the identity for
    the call), as in ``test_forward_matches_jax``; its flow is held at 5e-4
    (above), and its colours, whose floors move with it, within one level
    on any share of the pixels. (The refinement tier differs from scale2
    by its module, held in ``test_forward_matches_jax``; its preprocessor
    run op by op in JAX costs a forward's minute of dispatch.)"""
    scale1 = variant == "gmflow-scale1"
    if not scale1:
        monkeypatch.setattr(jax_flow.jax, "jit", lambda fn: fn)
    write_checkpoint(models_dir, variant)
    params = {"variant": variant, "detect_resolution": 64}
    clip = moving_clip(3 if scale1 else 2)
    jax_proc, jax_flows = jax_registry.get(name)(), []
    jax_predict = jax_proc.predict_flow
    jax_proc.predict_flow = lambda *a, **kw: jax_flows.append(jax_predict(*a, **kw)) or jax_flows[-1]
    want = jax_proc(clip, **params)
    port_proc = unimatch.OpticalFlowPreprocessor()
    got = port_proc(clip, device="cpu", **params)
    assert len(got) == len(clip)
    assert_frames_close(got, want, max_share=0.01 if scale1 else 1.0)
    np.testing.assert_array_equal(got[-1], got[-2])
    assert_rel_l2(port_proc.predict_flow(clip[0], clip[1], 64), jax_flows[0], 1e-4 if scale1 else 5e-4)


def test_optical_flow_single_frame_is_black():
    f = frame()
    got = run_preprocessor("flow", f, device="cpu")
    assert len(got) == 1 and not got[0].any() and got[0].shape == f.shape


def test_jax_loader_drops_the_gmflow_container(tmp_path):
    """The reference fault the port departs from: GMFlow's published file
    keeps its weights under ``model``, which the JAX loader's flattening
    drops (a dict is not an array), so the JAX preprocessor finds nothing to
    load and runs its random init; the port unwraps ``model``."""
    from apex_studio_tpu.preprocess.weights import load_preprocessor_weights as jax_load

    torch.save({"model": published("gmflow-scale1")}, tmp_path / "gmflow-scale1.pth")
    assert jax_load("gmflow-scale1", root=tmp_path) == {}
    assert set(load_preprocessor_weights("gmflow-scale1", root=tmp_path)) == set(published("gmflow-scale1"))


@pytest.mark.parametrize("name", ["ptlflow"])
def test_published_file_names_are_found(name, tmp_path, monkeypatch):
    """GMFlow's published file under ``model`` (``seg.test_published_file_names_are_found``)."""
    seg.test_published_file_names_are_found(name, tmp_path, monkeypatch)


@pytest.mark.parametrize("name", ["optical_flow"])
def test_missing_checkpoint_raises(name, tmp_path, monkeypatch):
    seg.test_missing_checkpoint_raises(name, tmp_path, monkeypatch)


@pytest.mark.parametrize("net", [n for n in seg.FAULT_CASES if seg.is_flow(n)])
@pytest.mark.parametrize("fault", ["missing_key", "extra_key"])
def test_checkpoint_with_a_key_missing_or_extra_raises(net, fault, tmp_path, monkeypatch):
    seg.test_checkpoint_with_a_key_missing_or_extra_raises(net, fault, tmp_path, monkeypatch)
