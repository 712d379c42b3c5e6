"""The port's QwenImage MMDiT and ControlNet against the JAX package's, on the
CPU in f32.

Toy widths: dim 32 (2 heads of 16, RoPE axes (4, 6, 6)), a 3-block DiT and a
2-block ControlNet, ``joint_attention_dim`` 32. The JAX modules are built from
seeded numpy values (``jax_build``: biases and norm scales off their initial
0 and 1), and the weights are carried into the port with
``loaders/from_jax.py``; the JAX forwards run jitted. Outputs are held to rel
L2 ≤ 1e-5; the RoPE tables to
max|Δ| ≤ 1e-6; packing is exact. The latent grid is 3 × 4 tokens (not square)
and the edit case adds two condition grids of other sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from apex_studio_tpu.models.transformers import qwenimage as jax_qwenimage
from apex_studio_tpu_torch.models.registry import _load_builtin_families, transformer_registry
from apex_studio_tpu_torch.models.transformers import qwenimage
from apex_studio_tpu_torch.ops.attention import attention_registry
from tests.torch_port_helpers import assert_rel_l2, jax_build, port_from_jax

TINY = dict(in_channels=16, out_channels=4, num_layers=3, attention_head_dim=16, num_attention_heads=2,
            joint_attention_dim=32, axes_dims_rope=(4, 6, 6))
F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
GRID = (3, 4)
SEGMENTS = ((3, 4), (2, 3))


@pytest.fixture(scope="module")
def models():
    ref = jax_build(lambda: jax_qwenimage.QwenImageTransformer2DModel(jax_qwenimage.QwenImageConfig(**TINY),
                                                                      rngs=nnx.Rngs(0), **F32), seed=1)
    port = port_from_jax(lambda: qwenimage.QwenImageTransformer2DModel(qwenimage.QwenImageConfig(**TINY),
                                                                       dtype=torch.float32), ref)
    cn_cfg = dict(TINY, num_layers=2)
    cn_ref = jax_build(lambda: jax_qwenimage.QwenImageControlNetModel(
        jax_qwenimage.QwenImageControlNetConfig(**cn_cfg), rngs=nnx.Rngs(1), **F32), seed=2)
    cn_port = port_from_jax(lambda: qwenimage.QwenImageControlNetModel(
        qwenimage.QwenImageControlNetConfig(**cn_cfg), dtype=torch.float32), cn_ref)
    return ref, port, cn_ref, cn_port


def inputs(n_img, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, n_img, 16)).astype(np.float32)
    txt = rng.normal(size=(1, 8, 32)).astype(np.float32)
    return x, txt, np.array([0.37], np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("segments", [(), SEGMENTS], ids=["t2i", "extra_segments"])
def test_forward_matches_jax(models, segments):
    ref, port, _, _ = models
    n_img = sum(h * w for h, w in (GRID, *segments))
    x, txt, ts = inputs(n_img)
    want = nnx.jit(lambda m, *a: m(*a, grid_hw=GRID, extra_segments=segments))(
        ref, jnp.asarray(x), jnp.asarray(txt), jnp.asarray(ts))
    with torch.no_grad():
        got = port(t(x), t(txt), t(ts), grid_hw=GRID, extra_segments=segments)
    assert tuple(got.shape) == (1, n_img, 16)
    assert_rel_l2(got, want, 1e-5)


def test_rope_table_ids_match_jax(models):
    ref, port, _, _ = models
    want = ref.rope_tables(3, 5, 7, extra_segments=((3, 5), (4, 2)))
    got = port.rope_tables(3, 5, 7, extra_segments=((3, 5), (4, 2)))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_pack_unpack_match_jax():
    lat = np.random.default_rng(3).normal(size=(2, 4, 6, 8)).astype(np.float32)
    packed = qwenimage.pack_latents(t(lat))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_qwenimage._pack(jnp.asarray(lat))))
    assert tuple(packed.shape) == (2, 12, 16)
    np.testing.assert_array_equal(qwenimage.unpack_latents(packed, 6, 8).numpy(), lat)


def test_controlnet_samples_match_jax(models):
    _, _, cn_ref, cn_port = models
    x, txt, ts = inputs(12)
    cond = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    want = nnx.jit(lambda m, *a: m(*a, grid_hw=GRID, conditioning_scale=jnp.float32(0.7)))(
        cn_ref, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(txt), jnp.asarray(ts))
    with torch.no_grad():
        got = cn_port(t(x), t(cond), t(txt), t(ts), grid_hw=GRID, conditioning_scale=0.7)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert_rel_l2(g, w, 1e-5)


def test_controlnet_injection_matches_jax(models):
    """2 samples over 3 blocks: ceil(3/2) = 2, so blocks 0, 1 take sample 0
    and block 2 sample 1."""
    ref, port, _, _ = models
    x, txt, ts = inputs(12)
    rng = np.random.default_rng(7)
    samples = [rng.normal(size=(1, 12, 32)).astype(np.float32) for _ in range(2)]
    want = nnx.jit(lambda m, *a, samples: m(*a, grid_hw=GRID, controlnet_block_samples=samples))(
        ref, jnp.asarray(x), jnp.asarray(txt), jnp.asarray(ts), samples=[jnp.asarray(s) for s in samples])
    with torch.no_grad():
        got = port(t(x), t(txt), t(ts), grid_hw=GRID, controlnet_block_samples=[t(s) for s in samples])
        plain = port(t(x), t(txt), t(ts), grid_hw=GRID)
        swapped = port(t(x), t(txt), t(ts), grid_hw=GRID, controlnet_block_samples=[t(s) for s in samples[::-1]])
    assert_rel_l2(got, want, 1e-5)
    assert (got - plain).abs().max() > 1e-3 and (got - swapped).abs().max() > 1e-3


def test_one_unmasked_flash_call_a_block(models, monkeypatch):
    _, port, _, cn_port = models
    calls = []
    flash = attention_registry.get("flash")
    monkeypatch.setitem(attention_registry._entries, "flash",
                        lambda q, *a, **kw: calls.append((q.shape[1], kw.get("bias"))) or flash(q, *a, **kw))
    x, txt, ts = inputs(24)
    with torch.no_grad():
        port(t(x), t(txt), t(ts), grid_hw=GRID, extra_segments=((3, 4),))
        cn_port(t(x[:, :12]), t(x[:, 12:]), t(txt), t(ts), grid_hw=GRID)
    # [txt ‖ img] joint sequences: 8 + 24 in the DiT, 8 + 12 in the ControlNet
    assert calls == [(32, None)] * 3 + [(20, None)] * 2


def test_registry_names():
    _load_builtin_families()
    assert transformer_registry.get("qwenimage.base") is qwenimage.QwenImageTransformer2DModel
    assert transformer_registry.get("qwenimage") is qwenimage.QwenImageTransformer2DModel
    for name in ("qwenimage.controlnet", "QwenImageControlNetModel"):
        assert transformer_registry.get(name) is qwenimage.QwenImageControlNetModel
    assert qwenimage.QwenImageControlNetConfig.from_dict({"num_layers": 5, "extra_condition_channels": 4,
                                                         "axes_dims_rope": [16, 56, 56]}).extra_condition_channels == 4
