"""The port's line and edge preprocessors (HED, PiDiNet, TEED, the lineart
generator, the anime lineart U-Net, Manga Line, M-LSD) against the JAX
package's on the CPU.

- Forwards: each JAX module seeded (``jax_build``), carried into the port
  (``loaders/from_jax.py``), f32 on the same numpy inputs: every output
  within max|Δ| ≤ 1e-4·max|ref|. The nets without a width option in JAX run
  at their published widths on small inputs; PiDiNet at inplane 12, dil 8.
- Converters: a file under the published names (``loaders/export.py``, or
  seeded raw pixel-difference weights for PiDiNet) through both converters:
  the port's tree loads strictly and equals what the JAX module filled from
  the JAX converter's tree carries into the port.
- Preprocessors: each manifest name through ``run_preprocessor`` on both
  sides from the same checkpoint on disk (the JAX modules built abstractly
  and filled from it): frames within one uint8 level where a float map is
  truncated; where the output is thresholded (``safe``, scribble,
  ``apply_filter``, ``safe_steps``, the M-LSD lines) the float map before
  the threshold within 1e-4 and the frames equal.
- A missing checkpoint raises ``FileNotFoundError`` naming the published
  file (nothing is fetched).
"""

import gc

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.preprocess import hed as jax_hed
from apex_studio_tpu.preprocess import lineart_anime as jax_anime
from apex_studio_tpu.preprocess import lineart_model as jax_lineart
from apex_studio_tpu.preprocess import manga_line as jax_manga
from apex_studio_tpu.preprocess import mlsd as jax_mlsd
from apex_studio_tpu.preprocess import pidinet as jax_pidi
from apex_studio_tpu.preprocess import teed as jax_teed
from apex_studio_tpu.preprocess.base import preprocessor_registry as jax_registry
from apex_studio_tpu.preprocess.base import run_preprocessor as jax_run
from apex_studio_tpu_torch.loaders.export import published_state_dict
from apex_studio_tpu_torch.preprocess import (hed, lineart_anime, lineart_model, manga_line, mlsd, pidinet,
                                              preprocessor_registry, run_preprocessor, teed)
from tests.torch_port_helpers import (assert_close, assert_loads_as_jax, jax_assign, jax_build, jax_build_bn,
                                      port_from_jax)

# name: (JAX module, port module, the published family, forward input shape, input range)
NETS = {
    "hed": (lambda: jax_hed.ControlNetHED(rngs=nnx.Rngs(0)), hed.ControlNetHED, "hed", (1, 32, 48, 3), (0, 255)),
    "pidinet": (lambda: jax_pidi.PiDiNet(12, 8, rngs=nnx.Rngs(0)), lambda: pidinet.PiDiNet(12, 8), None,
                (1, 32, 40, 3), (0, 1)),
    "teed": (lambda: jax_teed.TED(rngs=nnx.Rngs(0)), teed.TED, "teed", (1, 32, 48, 3), (0, 255)),
    "lineart": (lambda: jax_lineart.LineartGenerator(rngs=nnx.Rngs(0)), lineart_model.LineartGenerator,
                "lineart", (1, 32, 32, 3), (0, 1)),
    "lineart_anime": (lambda: jax_anime.LineartAnimeGenerator(rngs=nnx.Rngs(0)),
                      lineart_anime.LineartAnimeGenerator, "lineart_anime", (1, 256, 256, 3), (-1, 1)),
    "manga_line": (lambda: jax_manga.MangaLineModel(rngs=nnx.Rngs(0)), manga_line.MangaLineModel, "manga_line",
                   (1, 32, 32, 1), (0, 255)),
    "mlsd": (lambda: jax_mlsd.MLSDModel(rngs=nnx.Rngs(0)), mlsd.MLSDModel, "mlsd", (1, 64, 64, 4), (-1, 1)),
}
_PAIRS = {}
# one jitted forward for the file: a module and input shape seen before
# reuse its compiled program
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
    """(JAX module, port module) with the JAX module's seeded weights."""
    if name not in _PAIRS:
        jax_fn, port_fn = NETS[name][:2]
        jax_model = jax_build_bn(jax_fn)
        _PAIRS[name] = jax_model, port_from_jax(port_fn, jax_model)
    return _PAIRS[name]


def frame(h=40, w=56, seed=0):
    rng = np.random.default_rng(seed)
    f = (rng.random((h, w, 3)) * 60).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    f[(yy - h // 2) ** 2 + (xx - w // 3) ** 2 <= (h // 4) ** 2] = [210, 120, 60]
    f[4:12, w // 2:w - 4] = [40, 200, 90]
    f[:, w - 6] = 250
    return f


def outputs(y):
    return y if isinstance(y, (tuple, list)) else (y,)


@pytest.mark.parametrize("name", list(NETS))
def test_forward_matches_jax(name):
    jax_model, port = pair(name)
    shape, (lo, hi) = NETS[name][3:]
    x = np.random.default_rng(1).uniform(lo, hi, size=shape).astype(np.float32)
    want = outputs(jax_forward(jax_model, jnp.asarray(x)))
    with torch.no_grad():
        got = outputs(port(torch.from_numpy(x)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close(g, w)


def test_lineart_anime_up_is_torch_conv_transpose():
    """The JAX ``_Up`` (``lax.conv_transpose`` with ``transpose_kernel`` on
    the published ``[in, out, 4, 4]``) is ``conv_transpose2d`` of that
    weight: the carry takes ``w`` as it is."""
    up = jax_build(lambda: jax_anime._Up(6, 5, rngs=nnx.Rngs(0)))
    port = port_from_jax(lambda: lineart_anime._Up(6, 5), up)
    assert torch.equal(port.weight, torch.from_numpy(np.asarray(up.w.get_value())))
    x = np.random.default_rng(2).normal(size=(1, 7, 9, 6)).astype(np.float32)
    with torch.no_grad():
        assert_close(port(torch.from_numpy(x)), up(jnp.asarray(x)))


# -- converters ------------------------------------------------------------------------


def raw_pidinet(seed=3, inplane=60, dil=24):
    """Seeded raw pixel-difference weights under table5_pidinet.pth's names
    (``module.`` prefixed, as the published file keeps them)."""
    g = torch.Generator().manual_seed(seed)
    return {f"module.{k}": torch.randn(shape, generator=g) / np.sqrt(max(1, int(np.prod(shape[1:]))))
            for k, shape in pidinet.published_shapes(inplane, dil).items()}


def published(name, gain: float = 1.0):
    """A checkpoint in the published names, holding ``pair(name)``'s weights
    (PiDiNet: seeded raw weights at its published widths), every conv weight
    times ``gain``."""
    sd = raw_pidinet() if name == "pidinet" else published_state_dict(NETS[name][2], pair(name)[1].state_dict())
    return {k: v * gain if k.endswith("weight") and v.ndim > 1 else v for k, v in sd.items()}


def preprocessor_checkpoint(net):
    """``published(net)`` with edge maps that cross their thresholds: at the
    seeded scale TEED's map lies within 0.48-0.52, one of its quantized
    steps, and PiDiNet's within 0.05-0.42, below its filter's 0.5. TEED's
    conv weights are doubled; PiDiNet's classifier bias is raised by 1.7
    (a gain would grow its activations through 16 residual blocks)."""
    sd = published(net, 2.0 if net == "teed" else 1.0)
    if net == "pidinet":
        sd["module.classifier.bias"] = sd["module.classifier.bias"] + 1.7
    return sd


JAX_CONVERTERS = {"hed": jax_hed.convert_hed_keys, "pidinet": jax_pidi.convert_pidinet_keys,
                  "teed": jax_teed.convert_teed_keys, "lineart": jax_lineart.convert_lineart_keys,
                  "lineart_anime": jax_anime.convert_lineart_anime_keys,
                  "manga_line": jax_manga.convert_manga_line_keys, "mlsd": jax_mlsd.convert_mlsd_keys}
PORT_CONVERTERS = {"hed": hed.convert_hed_keys, "pidinet": pidinet.convert_pidinet_keys,
                   "teed": teed.convert_teed_keys, "lineart": lineart_model.convert_lineart_keys,
                   "lineart_anime": lineart_anime.convert_lineart_anime_keys,
                   "manga_line": manga_line.convert_manga_line_keys, "mlsd": mlsd.convert_mlsd_keys}
# published names that only the reference layout has
EXPECTED_NAMES = {
    "hed": {"norm", "block5.projection.weight", "block3.convs.2.bias"},
    "pidinet": {"module.block1_1.conv1.weight", "module.block4_1.shortcut.bias", "module.dilations.3.conv2_4.weight"},
    "teed": {"dblock_3.denselayer1.conv1.weight", "up_block_3.features.5.weight", "block_cat.DWconv2.bias",
             "side_1.conv.weight"},
    "lineart": {"model0.1.weight", "model2.2.conv_block.5.bias", "model3.3.weight", "model4.1.bias"},
    "lineart_anime": {"model.model.0.weight", "model.model.3.weight",
                      "model.model.1.model.3.model.3.model.3.model.3.model.3.model.3.model.1.weight"},
    "manga_line": {"block4.model.11.residual.model.0.running_var", "block5.model.0.shortcut.model.0.weight",
                   "conv15.model.2.bias"},
    "mlsd": {"backbone.features.0.1.running_mean", "backbone.features.1.conv.0.0.weight",
             "backbone.features.13.conv.3.running_var", "block23.conv3.weight", "block15.conv1.1.weight"},
}


@pytest.mark.parametrize("name", list(NETS))
def test_converters_agree_with_jax(name):
    """The file under its published names → each side's converter: the port
    loads it strictly (``meta`` build) into what the JAX module, filled from
    the JAX converter, carries. PiDiNet's fold runs on raw weights at its
    published widths on both sides."""
    sd = published(name)
    assert EXPECTED_NAMES[name] <= set(sd)
    if name == "hed":
        assert tuple(sd["norm"].shape) == (1, 3, 1, 1)
    jax_fn, port_fn = NETS[name][:2]
    if name == "pidinet":
        jax_fn, port_fn = (lambda: jax_pidi.PiDiNet(rngs=nnx.Rngs(0))), pidinet.PiDiNet
    ref = nnx.eval_shape(jax_fn)  # every parameter comes from the file
    jax_assign(ref, JAX_CONVERTERS[name]({k: v.numpy() for k, v in sd.items()}))
    assert_loads_as_jax(port_fn, PORT_CONVERTERS[name](sd), ref, atol=1e-6 if name == "pidinet" else 0.0)


def test_pidinet_fold_matches_the_pixel_difference_convs():
    """Each folded kernel computes the raw pixel-difference convolution it
    replaces (reference model.py:300 createConvFunc), checked on the port's
    ``fold``: cd, ad, rd, and cv untouched."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(6)
    w = torch.randn(4, 4, 3, 3, generator=g)
    x = torch.randn(1, 4, 9, 11, generator=g)
    cd = F.conv2d(x, w, padding=1) - F.conv2d(x, w.sum(dim=(2, 3), keepdim=True))
    wf = w.reshape(4, 4, 9)
    ad = F.conv2d(x, (wf - wf[:, :, [3, 0, 1, 6, 4, 2, 7, 8, 5]]).reshape(4, 4, 3, 3), padding=1)
    buf = torch.zeros(4, 4, 25)
    buf[:, :, [0, 2, 4, 10, 14, 20, 22, 24]] = wf[:, :, 1:]
    buf[:, :, [6, 7, 8, 11, 13, 16, 17, 18]] = -wf[:, :, 1:]
    rd = F.conv2d(x, buf.reshape(4, 4, 5, 5), padding=2)
    for pdc, want, pad in (("cd", cd, 1), ("ad", ad, 1), ("rd", rd, 2), ("cv", F.conv2d(x, w, padding=1), 1)):
        assert float((F.conv2d(x, pidinet.fold(pdc, w), padding=pad) - want).abs().max()) <= 1e-5, pdc


# -- preprocessors ----------------------------------------------------------------------

# manifest name: (the JAX stem both sides find, the net's pair, params)
CASES = {
    "hed": ("hed", "hed", {}),
    "hed_safe": ("hed", "hed", {"safe": True}),
    "scribble_hed": ("hed", "hed", {}),
    "pidi": ("pidinet", "pidinet", {"scribble": True}),
    "pidinet": ("pidinet", "pidinet", {}),
    "pidinet_filtered": ("pidinet", "pidinet", {"apply_filter": True, "safe": True}),
    "teed": ("teed", "teed", {}),
    "teed_unquantized": ("teed", "teed", {"safe_steps": 0}),
    "lineart_realistic": ("lineart_sk", "lineart", {}),
    "lineart_coarse": ("lineart_coarse", "lineart", {"coarse": True}),
    "lineart_anime": ("lineart_anime", "lineart_anime", {"detect_resolution": 200}),
    "scribble_anime": ("scribble_anime", "lineart", {"detect_resolution": 64}),
    "manga_line": ("manga_line", "manga_line", {"detect_resolution": 64}),
    "mlsd": ("mlsd", "mlsd", {"detect_resolution": 64}),
}
# the JAX net each preprocessor builds, by its module's global name
JAX_NETS = {"hed": (jax_hed, "ControlNetHED"), "pidinet": (jax_pidi, "PiDiNet"), "teed": (jax_teed, "TED"),
            "lineart": (jax_lineart, "LineartGenerator"), "lineart_anime": (jax_anime, "LineartAnimeGenerator"),
            "manga_line": (jax_manga, "MangaLineModel"), "mlsd": (jax_mlsd, "MLSDModel")}


def manifest_name(case):
    return {"hed_safe": "hed", "pidinet_filtered": "pidinet", "teed_unquantized": "teed",
            "lineart_coarse": "lineart_realistic"}.get(case, case)


@pytest.fixture()
def models_dir(tmp_path, monkeypatch):
    """An empty preprocessor models dir; the JAX nets built abstractly
    (their checkpoint fills every parameter) rather than by flax's
    initialisers."""
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    for module, cls_name in JAX_NETS.values():
        cls = getattr(module, cls_name)
        monkeypatch.setattr(module, cls_name, lambda *a, _cls=cls, **kw: nnx.eval_shape(
            lambda: _cls(*a, **{**kw, "rngs": nnx.Rngs(0)})))
    return tmp_path


def float_maps(case, f, port_proc, jax_model):
    """(port, JAX) float maps before the threshold: the port preprocessor's
    own step, and the JAX module's forward through the JAX process_frame's
    steps."""
    import cv2

    h, w = f.shape[:2]
    if case.startswith(("hed", "scribble_hed", "teed")):
        mult = 16 if case.startswith(("hed", "scribble")) else 8
        x = np.pad(f, ((0, (-h) % mult), (0, (-w) % mult), (0, 0)), mode="edge").astype(np.float32)
        maps = [cv2.resize(np.asarray(m)[0, :, :, 0], (w, h), interpolation=cv2.INTER_LINEAR)
                for m in jax_forward(jax_model, jnp.asarray(x)[None])]
        return port_proc.edge(f), 1.0 / (1.0 + np.exp(-np.mean(np.stack(maps, 2), axis=2, dtype=np.float64)))
    if case.startswith("pidi"):
        x = np.pad(f[:, :, ::-1], ((0, (-h) % 8), (0, (-w) % 8), (0, 0)), mode="edge")
        x = jnp.asarray(x.astype(np.float32) / 255.0)[None]
        return port_proc.edge(f), np.asarray(jax_forward(jax_model, x))[0, :h, :w, 0]
    assert case == "mlsd"
    img = cv2.resize(f, (64, 64), interpolation=cv2.INTER_AREA)
    x = np.concatenate([img.astype(np.float32), np.ones((64, 64, 1), np.float32)], axis=-1) / 127.5 - 1.0
    return port_proc.tpmap(f, 64), np.asarray(jax_forward(jax_model, jnp.asarray(x)[None])[0])


THRESHOLDED = {"hed_safe", "scribble_hed", "pidi", "pidinet_filtered", "teed", "mlsd"}


@pytest.mark.parametrize("case", list(CASES))
def test_preprocessor_matches_jax(case, models_dir):
    stem, net, params = CASES[case]
    name = manifest_name(case)
    torch.save(preprocessor_checkpoint(net), models_dir / f"{stem}.pth")
    frames = [frame(seed=7), frame(seed=8)]
    want = jax_run(name, frames, dict(params))
    got = run_preprocessor(name, frames, dict(params), device="cpu")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (40, 56, 3) and g.dtype == w.dtype == np.uint8
    assert any(len(np.unique(g)) > 1 for g in got), "a constant frame: the comparison tests nothing"
    if case not in THRESHOLDED:
        for g, w in zip(got, want):
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
        return
    # the float map before the threshold, on the weights both sides loaded
    port_proc = preprocessor_registry.get(name)()
    port_proc.device = "cpu"
    port_proc.setup()
    jax_proc = jax_registry.get(name)()
    jax_model = {"hed": lambda p: p._ensure_model(), "pidinet": lambda p: p._ensure(),
                 "teed": lambda p: p._ensure_model(), "mlsd": lambda p: p._ensure_model()}[net](jax_proc)
    for f in frames:
        got_map, want_map = float_maps(case, f, port_proc, jax_model)
        assert_close(got_map, want_map)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mlsd_decode_is_the_jax_decode():
    """``decode_lines`` (host numpy, copied) on a map with planted segments
    and noise, against the JAX function."""
    rng = np.random.default_rng(9)
    tp = rng.normal(0, 1, size=(32, 32, 9)).astype(np.float32)
    tp[..., 0] -= 4.0
    for y, x in ((5, 6), (20, 25), (12, 14)):
        tp[y, x, 0] = 5.0
        tp[y, x, 1:5] = [-6, -3, 7, 4]
    got = mlsd.decode_lines(tp, score_thr=0.1, dist_thr=5.0)
    np.testing.assert_array_equal(got, jax_mlsd.decode_lines(tp, score_thr=0.1, dist_thr=5.0))
    assert len(got) >= 3


def test_nms_sketch_is_the_jax_one():
    rng = np.random.default_rng(10)
    x = (rng.random((40, 56)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(hed.nms_sketch(x, 127, 3.0), jax_hed.nms_sketch(x, 127, 3.0))


MISSING = {"hed": "ControlNetHED.pth", "scribble_hed": "ControlNetHED.pth", "pidi": "table5_pidinet.pth",
           "pidinet": "table5_pidinet.pth", "teed": "7_model.pth", "lineart_realistic": "sk_model.pth",
           "lineart_anime": "netG.pth", "scribble_anime": "netG_A_latest.pth", "manga_line": "erika.pth",
           "mlsd": "mlsd_large_512_fp32.pth"}


@pytest.mark.parametrize("name", list(MISSING))
def test_missing_checkpoint_raises(name, tmp_path, monkeypatch):
    """Nothing is fetched and no random net stands in: the published file's
    name and the directory are in the error."""
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=MISSING[name]) as err:
        run_preprocessor(name, frame(), device="cpu")
    assert str(tmp_path) in str(err.value)


def test_published_file_names_are_found(tmp_path, monkeypatch):
    """A checkpoint under its published file name, folders included, is
    found as under the stem: TEED's ``Annotators/7_model.pth`` and the anime
    scribble generator's ``scribble/anime_style/netG_A_latest.pth``."""
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    f = frame(seed=11)
    for stem, rel, name, net, params in (
            ("teed", "Annotators/7_model.pth", "teed", "teed", {}),
            ("scribble_anime", "scribble/anime_style/netG_A_latest.pth", "scribble_anime", "lineart",
             {"detect_resolution": 64})):
        torch.save(published(net), tmp_path / f"{stem}.pth")
        want = run_preprocessor(name, f, dict(params), device="cpu")[0]
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / f"{stem}.pth").rename(tmp_path / rel)
        np.testing.assert_array_equal(run_preprocessor(name, f, dict(params), device="cpu")[0], want)
