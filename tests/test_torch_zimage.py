"""The port's Z-Image DiTs (base and control) against the JAX package's, on the
CPU.

Tiny models (dim 64, two heads of 32 = sum of the axes (8, 12, 12)) are built by
the JAX package from its seed and carried into the port with
``loaders/from_jax.py``; both run the same numpy inputs in f32 and are held to
max|Δ| ≤ 1e-4·max|ref|. The latent grid gives 25 image tokens, not a multiple
of 32, so the ``x_pad_token`` path runs; the caption bucket of 32 holds 20 real
tokens, so ``cap_pad_token`` fills the rest. Every attention of the model goes
to the flash backend unmasked (34 calls a forward at the published depth).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from apex_studio_tpu.models.transformers import zimage as jax_zimage
from apex_studio_tpu_torch.models.transformers import zimage
from apex_studio_tpu_torch.ops.attention import attention_registry
from tests.torch_port_helpers import assert_close, jax_build, jitted, port_from_jax

BASE = dict(dim=64, n_layers=2, n_refiner_layers=2, n_heads=2, n_kv_heads=2, in_channels=4,
            cap_feat_dim=48, axes_dims=(8, 12, 12), axes_lens=(64, 32, 32))
CONTROL = dict(BASE, n_layers=4, control_layers_places=(0, 2), control_refiner_layers_places=(0, 1),
               control_in_dim=9)
F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)


def build(kind):
    if kind == "base":
        ref = jax_build(lambda: jax_zimage.ZImageTransformer2DModel(jax_zimage.ZImageConfig(**BASE),
                                                                    rngs=nnx.Rngs(0), **F32))
        port = port_from_jax(lambda: zimage.ZImageTransformer2DModel(zimage.ZImageConfig(**BASE),
                                                                     dtype=torch.float32), ref)
    else:
        ref = jax_build(lambda: jax_zimage.ZImageControlTransformer2DModel(
            jax_zimage.ZImageControlConfig(**CONTROL), rngs=nnx.Rngs(0), **F32))
        port = port_from_jax(lambda: zimage.ZImageControlTransformer2DModel(
            zimage.ZImageControlConfig(**CONTROL), dtype=torch.float32), ref)
    rng = np.random.default_rng(1)
    # the learned tokens are zero at init: give them values so that their paths show
    for name in ("x_pad_token", "cap_pad_token"):
        val = rng.normal(size=(1, 64)).astype(np.float32)
        getattr(ref, name).value = jnp.asarray(val)
        getattr(port, name).data.copy_(torch.from_numpy(val))
    return ref, port


@pytest.fixture(scope="module")
def models():
    return {kind: build(kind) for kind in ("base", "control")}


def inputs(seed=0, real=20):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, 4, 1, 10, 10)).astype(np.float32)  # 5 x 5 = 25 image tokens
    t = np.array([0.37], np.float32)
    cap = rng.normal(size=(1, 32, 48)).astype(np.float32)
    mask = np.zeros((1, 32), bool)
    mask[0, :real] = True
    cc = rng.normal(size=(1, 9, 1, 10, 10)).astype(np.float32)
    return x, t, cap, mask, cc


def run_port(model, *args, **kw):
    with torch.inference_mode():
        return model(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args), **kw)


class TestBase:
    @pytest.mark.parametrize("masked", [True, False])
    def test_forward_matches_jax(self, models, masked):
        ref, port = models["base"]
        x, t, cap, mask, _ = inputs()
        m = mask if masked else None
        want = jitted(ref, lambda r, *a: r(*a[:3], a[3] if a[3:] else None), x, t, cap, *(() if m is None else (m,)))
        out = run_port(port, x, t, cap, m)
        assert out.shape == x.shape
        assert_close(out, np.asarray(want), rel=1e-4)

    def test_caption_padding_takes_the_pad_token(self, models):
        _, port = models["base"]
        x, t, cap, mask, _ = inputs()
        noisy = cap.copy()
        noisy[0, 20:] += 5.0  # changes only the slots the mask marks as padding
        np.testing.assert_array_equal(run_port(port, x, t, cap, mask).numpy(),
                                      run_port(port, x, t, noisy, mask).numpy())
        assert not torch.equal(run_port(port, x, t, cap, None), run_port(port, x, t, noisy, None))

    def test_attention_calls_are_unmasked(self, models, monkeypatch):
        calls = []
        flash = attention_registry.get("flash")

        def counting(q, k, v, bias=None, **kw):
            calls.append((q.shape[1], bias))
            return flash(q, k, v, bias=bias, **kw)

        monkeypatch.setitem(attention_registry._entries, "flash", counting)
        x, t, cap, mask, _ = inputs()
        run_port(models["base"][1], x, t, cap, mask)
        # noise refiner over 32 padded image tokens, context refiner over the
        # 32-token bucket, main layers over both
        assert calls == [(32, None)] * 2 + [(32, None)] * 2 + [(64, None)] * 2

    def test_pos_tables_match_jax(self, models):
        ref, port = models["base"]
        want = ref._pos_tables(5, 7, 64, 96)
        got = port._pos_tables(5, 7, 64, 96, torch.device("cpu"))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_patchify_round_trip_matches_jax(self, models):
        ref, port = models["base"]
        x = np.random.default_rng(2).normal(size=(2, 4, 1, 6, 8)).astype(np.float32)
        tokens = port.patchify(torch.from_numpy(x))
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref.patchify(jnp.asarray(x))))
        np.testing.assert_array_equal(port.unpatchify(tokens, 1, 6, 8).numpy(), x)

    def test_config_from_published_dict(self):
        cfg = {"dim": 64, "n_heads": 2, "all_patch_size": [2], "all_f_patch_size": [1],
               "axes_dims": [8, 12, 12], "axes_lens": [64, 32, 32], "unknown_key": 1}
        ours, theirs = zimage.ZImageConfig.from_dict(cfg), jax_zimage.ZImageConfig.from_dict(cfg)
        assert vars(ours) == vars(theirs) and ours.axes_dims == (8, 12, 12)
        ctrl = {**cfg, "control_layers_places": [0, 2], "control_in_dim": 9}
        ours, theirs = zimage.ZImageControlConfig.from_dict(ctrl), jax_zimage.ZImageControlConfig.from_dict(ctrl)
        assert vars(ours) == vars(theirs) and ours.control_layers_places == (0, 2)

    def test_published_width_parameter_count(self):
        with torch.device("meta"):
            model = zimage.ZImageTransformer2DModel(zimage.ZImageConfig())
        n = sum(p.numel() for p in model.parameters())
        assert 6.1e9 < n < 6.2e9, n


class TestControl:
    @pytest.mark.parametrize("scale", [0.75, 1.0])
    def test_forward_matches_jax(self, models, scale):
        ref, port = models["control"]
        x, t, cap, mask, cc = inputs(3)
        want = jitted(ref, lambda r, *a: r(*a[:4], control_context=a[4], control_context_scale=scale),
                      x, t, cap, mask, cc)
        out = run_port(port, x, t, cap, mask, control_context=torch.from_numpy(cc), control_context_scale=scale)
        assert_close(out, np.asarray(want), rel=1e-4)

    def test_without_context_is_the_base_forward(self, models):
        ref, port = models["control"]
        x, t, cap, mask, _ = inputs(4)
        want = jitted(ref, lambda r, *a: r(*a), x, t, cap, mask)
        assert_close(run_port(port, x, t, cap, mask), np.asarray(want), rel=1e-4)

    def test_hints_reach_the_output(self, models):
        _, port = models["control"]
        x, t, cap, mask, cc = inputs(5)
        a = run_port(port, x, t, cap, mask, control_context=torch.from_numpy(cc), control_context_scale=1.0)
        b = run_port(port, x, t, cap, mask, control_context=torch.from_numpy(cc), control_context_scale=0.0)
        assert (a - b).abs().max() > 1e-3
