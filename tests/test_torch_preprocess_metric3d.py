"""The port's Metric3D v2 against the JAX package's on the CPU.

- Forwards: the JAX module seeded (``jax_build``), carried into the port
  (``loaders/from_jax.py``), f32 on the same numpy input: depth, confidence
  and normal each within ‖Δ‖ ≤ 1e-4·‖ref‖. ``Metric3DConfig.tiny()`` at its
  56×112 crop (a 4×8 grid against the 4×4 position grid: the bicubic
  resize runs) through the JAX preprocessor's own compiled forward; a
  giant2-style tiny config (``ffn="swiglu"``, ``multi_output``, 4 blocks) on
  a 70×98 input (5×7 against 4×4). With ``multi_output`` the port has no
  final norm (the JAX module builds one and never runs it; the published
  file has none), so the carry leaves it out.
- The decoder's pieces (``_nearest_scale``'s floor rule, ``_avg_pool``
  counting the padding, ``_convex_upsample``) against the JAX functions.
- The colormap: ``GREYS_LUT`` equals matplotlib's ``Greys`` table, and
  ``_gray_to_colormap`` the JAX one (which calls matplotlib) bit for bit.
- Converters: a file under the published names (``loaders/export.py``,
  ``depth_model.`` prefixed, ``mask_token`` included, the blocks written
  chunked as ``blocks.<chunk>.<i>``) through both converters: the port's
  tree loads strictly and equals what the JAX module, filled by the JAX
  loader from the JAX converter's tree, carries into the port.
- The preprocessor through ``run_preprocessor`` on both sides from the same
  file on disk (``Metric3DConfig.small`` standing for ``tiny`` on both sides,
  so that the CPU runs it): the depth and normal frames' shapes and dtypes
  equal and their values equal but on ties, on at most 1% of the pixels: by
  two levels where a depth sits on a colour bin's edge, one where a normal
  is truncated.
- Departures: a missing file raises ``FileNotFoundError``; a file with one
  key missing or one unknown key raises.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.loaders.state_mapping import apply_state_dict as jax_apply
from apex_studio_tpu.preprocess import metric3d as jax_m3d
from apex_studio_tpu.preprocess.base import preprocessor_registry as jax_registry
from apex_studio_tpu_torch.engine.base import materialize_random
from apex_studio_tpu_torch.loaders.export import published_state_dict
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from apex_studio_tpu_torch.preprocess import metric3d, run_preprocessor
from tests.torch_port_helpers import assert_loads_as_jax, assert_rel_l2, jax_build, jax_params

jax_forward = nnx.jit(lambda m, v: m(v))


def configs(name):
    """(JAX config, port config) of ``tiny`` or the giant2-style tiny."""
    cfg = jax_m3d.Metric3DConfig.tiny()
    if name == "giant2_style":
        cfg = dataclasses.replace(cfg, depth=4, ffn="swiglu", multi_output=True)
    return cfg, metric3d.Metric3DConfig(**dataclasses.asdict(cfg))


_PAIRS = {}


@pytest.fixture(scope="module", autouse=True)
def release_pairs():
    yield
    _PAIRS.clear()
    gc.collect()


def carried(jax_model, port_cfg):
    """The port module with ``jax_model``'s weights, less the final norm a
    ``multi_output`` JAX module keeps unused."""
    flat = jax_params(jax_model)
    if port_cfg.multi_output:
        flat = {k: v for k, v in flat.items() if not k.startswith("encoder.norm.")}
    return load_from_jax(materialize_random(lambda: metric3d.Metric3DModel(port_cfg), torch.device("cpu"), seed=0),
                         flat)


def pair(name):
    if name not in _PAIRS:
        jax_cfg, port_cfg = configs(name)
        jax_model = jax_build(lambda: jax_m3d.Metric3DModel(jax_cfg, rngs=nnx.Rngs(0)))
        _PAIRS[name] = jax_model, carried(jax_model, port_cfg)
    return _PAIRS[name]


def assert_outputs(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert_rel_l2(g, np.asarray(w), 1e-4)


def test_tiny_forward_matches_jax():
    """At the crop (4×8 against the 4×4 position grid), through the JAX
    preprocessor's compiled forward."""
    jax_model, port = pair("tiny")
    jax_proc = jax_m3d.Metric3DPreprocessor(model=jax_model)
    run, state = jax_proc._fn()
    x = np.random.default_rng(1).normal(size=(1, 56, 112, 3)).astype(np.float32)
    with torch.no_grad():
        assert_outputs(port(torch.from_numpy(x)), run(state, jnp.asarray(x)))


def test_giant2_style_forward_matches_jax():
    """SwiGLU FFN and the pre-norm taps every depth/4 blocks, off the
    position grid (5×7 against 4×4)."""
    jax_model, port = pair("giant2_style")
    assert port.encoder.norm is None and any(k.startswith("encoder.norm.") for k in jax_params(jax_model))
    x = np.random.default_rng(2).normal(size=(1, 70, 98, 3)).astype(np.float32)
    with torch.no_grad():
        assert_outputs(port(torch.from_numpy(x)), jax_forward(jax_model, jnp.asarray(x)))


def test_decoder_pieces_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 5, 7, 4)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(metric3d._nearest_scale(t(x), 3.5).numpy(),
                                  np.asarray(jax_m3d._nearest_scale(jnp.asarray(x), 3.5)))
    for k, s, p in ((3, 2, 1), (2, 2, 0)):
        assert_rel_l2(metric3d._avg_pool(t(x), k, s, p), np.asarray(jax_m3d._avg_pool(jnp.asarray(x), k, s, p)), 1e-6)
    flow = rng.normal(size=(1, 5, 7, 6)).astype(np.float32)
    mask = rng.normal(size=(1, 5, 7, 9 * 16)).astype(np.float32)
    assert_rel_l2(metric3d._convex_upsample(t(flow), t(mask), 4),
                  np.asarray(jax_m3d._convex_upsample(jnp.asarray(flow), jnp.asarray(mask), 4)), 1e-6)


def test_greys_table_is_matplotlibs():
    import matplotlib

    cmap = matplotlib.colormaps["Greys"]
    cmap(0.5)  # builds the table
    np.testing.assert_array_equal(metric3d.GREYS_LUT, cmap._lut[:cmap.N, 0])
    np.testing.assert_array_equal(cmap._lut[:cmap.N, 0], cmap._lut[:cmap.N, 1])


@pytest.mark.parametrize("seed", [0, 1])
def test_gray_to_colormap_is_the_jax_one(seed):
    rng = np.random.default_rng(seed)
    depth = (rng.random((60, 80)) * 40).astype(np.float32)
    depth[:5] = 0.0  # invalid: drawn black
    depth[5:8, :10] = -1.0
    depth[10, 10] = depth.max() * 1.5  # the top of the range: x·256 near 256 / 1.1
    np.testing.assert_array_equal(metric3d._gray_to_colormap(depth), jax_m3d._gray_to_colormap(depth, "Greys"))


# -- converters ------------------------------------------------------------------------


def published(name, chunked=True):
    """``pair(name)``'s port weights under the published names, with DINOv2's
    ``mask_token`` and (``chunked``) the blocks as ``blocks.0.<i>``."""
    jax_cfg, port_cfg = configs(name)
    sd = published_state_dict("metric3d", pair(name)[1].state_dict())
    if chunked:
        sd = {k.replace("depth_model.encoder.blocks.", "depth_model.encoder.blocks.0."): v for k, v in sd.items()}
    sd["depth_model.encoder.mask_token"] = torch.zeros(1, port_cfg.embed_dim)
    return sd


@pytest.mark.parametrize("name", ["tiny", "giant2_style"])
def test_converters_agree_with_jax(name):
    jax_cfg, port_cfg = configs(name)
    sd = published(name)
    assert {"depth_model.encoder.patch_embed.proj.weight", "depth_model.encoder.blocks.0.1.attn.qkv.weight",
            "depth_model.decoder.depth_regressor.2.bias", "depth_model.decoder.normal_predictor.6.weight",
            "depth_model.decoder.token2feature.read_0.sample.0.weight",
            "depth_model.decoder.context_feature_encoder.outputs08.0.0.downsample.1.weight",
            "depth_model.decoder.context_feature_encoder.outputs08.1.1.weight",
            "depth_model.decoder.update_block.mask.2.weight"} <= set(sd)
    assert tuple(sd["depth_model.decoder.token2feature.read_1.sample.weight"].shape) == (
        port_cfg.embed_dim, port_cfg.feature_channels[1], 2, 2)  # ConvTranspose2d's [in, out, 2, 2]
    ref = nnx.eval_shape(lambda: jax_m3d.Metric3DModel(jax_cfg, rngs=nnx.Rngs(0)))
    missing, unexpected = jax_apply(ref, jax_m3d.convert_metric3d_keys({k: v.numpy() for k, v in sd.items()}),
                                    strict=False)
    assert not unexpected and all(k.startswith("encoder.norm.") for k in missing) and (
        bool(missing) == port_cfg.multi_output), (missing, unexpected)
    if port_cfg.multi_output:  # the unused norm the file does not fill: a value for the carry's sake
        nnx.update(ref, {"encoder": {"norm": {"weight": jnp.ones(port_cfg.embed_dim),
                                              "bias": jnp.zeros(port_cfg.embed_dim)}}})

    def build():
        return metric3d.Metric3DModel(port_cfg)

    if port_cfg.multi_output:
        ref_flat = {k: v for k, v in jax_params(ref).items() if not k.startswith("encoder.norm.")}
        want = load_from_jax(materialize_random(build, torch.device("cpu"), seed=0), ref_flat).state_dict()
        from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict

        with torch.device("meta"):
            port = build()
        apply_state_dict(port, metric3d.convert_metric3d_keys(sd), device="cpu", strict=True)
        got = port.state_dict()
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    else:
        assert_loads_as_jax(build, metric3d.convert_metric3d_keys(sd), ref)


# -- the preprocessor -------------------------------------------------------------------


@pytest.fixture()
def tiny_as_small(tmp_path, monkeypatch):
    """``Metric3DConfig.small`` standing for ``tiny`` on both sides, the JAX
    module built abstractly (the file fills it), and the file under the
    published name in an empty preprocessor models dir."""
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    monkeypatch.setattr(jax_m3d.Metric3DConfig, "small", classmethod(lambda cls: jax_m3d.Metric3DConfig.tiny()))
    monkeypatch.setattr(metric3d.Metric3DConfig, "small", classmethod(lambda cls: metric3d.Metric3DConfig.tiny()))
    model_cls = jax_m3d.Metric3DModel
    monkeypatch.setattr(jax_m3d, "Metric3DModel", lambda *a, **kw: nnx.eval_shape(
        lambda: model_cls(*a, **{**kw, "rngs": nnx.Rngs(0)})))
    path = tmp_path / "metric_depth_vit_small_800k.pth"
    torch.save({"model_state_dict": published("tiny"), "optimizer": {"lr": 1e-4}}, path)
    return path


def frame(h=60, w=84, seed=0):
    rng = np.random.default_rng(seed)
    f = (rng.random((h, w, 3)) * 60).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    f[(yy - h // 2) ** 2 + (xx - w // 3) ** 2 <= (h // 4) ** 2] = [210, 120, 60]
    f[4:12, w // 2:w - 4] = [40, 200, 90]
    return f


def test_preprocessor_matches_jax(tiny_as_small):
    """Depth and normal frames from one preprocessor a side (their compiled
    forward reused), through ``run_preprocessor``'s registry names."""
    frames = [frame(seed=4)]
    jax_proc = jax_registry.get("Metric3DDetector")()
    for name, params, level in (("metric3d", {}, 2), ("metric3d_normal", {"output_type": "normal"}, 1)):
        want = jax_proc(frames, **params)
        got = run_preprocessor(name, frames, dict(params), device="cpu")
        assert got[0].shape == want[0].shape == (60, 84, 3) and got[0].dtype == want[0].dtype == np.uint8
        diff = np.abs(got[0].astype(int) - want[0].astype(int))
        assert (diff.max(axis=-1) > 0).mean() <= 0.01 and diff.max() <= level, (diff.max(), (diff > 0).mean())
        assert len(np.unique(got[0])) > 4
    port_proc = metric3d.Metric3DPreprocessor()
    port_proc.device = "cpu"
    port_proc.setup()
    x, _ = port_proc.canonical_input(frames[0])
    run, state = jax_proc._fn()
    with torch.no_grad():
        assert_outputs(port_proc._model(torch.from_numpy(x)), run(state, jnp.asarray(x)))


def test_missing_checkpoint_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="metric_depth_vit_small_800k.pth") as err:
        run_preprocessor("metric3d", frame(), device="cpu")
    assert str(tmp_path) in str(err.value)


@pytest.mark.parametrize("fault", ["missing_key", "extra_key"])
def test_checkpoint_with_a_key_missing_or_extra_raises(fault, tiny_as_small):
    """The load is strict over ``encoder.`` and ``decoder.`` (the JAX
    preprocessor loads with ``strict=False``)."""
    sd = published("tiny")
    if fault == "missing_key":
        del sd["depth_model.decoder.update_block.gru08.convz.weight"]
    else:
        sd["depth_model.decoder.update_block.extra.weight"] = torch.zeros(3)
    torch.save({"model_state_dict": sd}, tiny_as_small)
    with pytest.raises(KeyError):
        run_preprocessor("metric3d", frame(), device="cpu")
