"""The port's Wan DiT variants against the JAX package's, on the CPU in f32.

Toy widths as tests/test_torch_wan.py: 2 blocks, 2 heads of 32 (dim 64),
FFN 96, text dim 48, freq dim 32; 3 latent frames of 10 × 12 (90 tokens).
The JAX modules are built from seeded numpy values (``jax_build``) and carried
into the port with ``loaders/from_jax.py``; the JAX forwards run jitted.
Outputs are held to rel L2 ≤ 1e-4, and so are the causal K/V caches.

- VACE (``vace_layers`` (0, 1), 12 control channels): without control, with
  a control of the main sequence's length, with a shorter control (zero
  padded to the main sequence), with per-layer scales; scale 0 equals no
  control; the default ``vace_layers``.
- Fun / Phantom: a subject reference of 2 frames with 2 of the 4 channels
  (zero padded), and without one (the base forward).
- Causal: ``forward_causal`` on a cache of 4 latent frames, block 1 (one
  frame at ``cache_pos`` 0) then block 2 (two frames at ``cache_pos`` 30),
  plain and with a local window of 45 tokens plus 15 sink tokens; the
  RoPE tables of a block's absolute frames; the validity mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from apex_studio_tpu.models.transformers import wan as jax_wan
from apex_studio_tpu_torch.models.registry import _load_builtin_families, transformer_registry
from apex_studio_tpu_torch.models.transformers import wan
from tests.torch_port_helpers import assert_rel_l2, jax_build, port_from_jax

TINY = dict(num_attention_heads=2, attention_head_dim=32, in_channels=4, out_channels=4, text_dim=48,
            freq_dim=32, ffn_dim=96, num_layers=2)
VACE = dict(TINY, vace_layers=(0, 1), vace_in_channels=12)
F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
LATENT = (3, 10, 12)  # T, H, W: 3 × 5 × 6 tokens
TOL = 1e-4


def pair(jax_cls, port_cls, cfg, seed):
    ref = jax_build(lambda: jax_cls(jax_wan.WanConfig(**cfg), rngs=nnx.Rngs(0), **F32), seed=seed)
    port = port_from_jax(lambda: port_cls(wan.WanConfig(**cfg), dtype=torch.float32), ref)
    return ref, port


@pytest.fixture(scope="module")
def vace():
    return pair(jax_wan.WanVACETransformer3DModel, wan.WanVACETransformer3DModel, VACE, 11)


@pytest.fixture(scope="module")
def fun():
    return pair(jax_wan.WanFunTransformer3DModel, wan.WanFunTransformer3DModel, TINY, 12)


@pytest.fixture(scope="module")
def causal():
    return pair(jax_wan.WanCausalTransformer3DModel, wan.WanCausalTransformer3DModel, TINY, 13)


def inputs(seed=0, frames=LATENT[0]):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, 4, frames, *LATENT[1:])).astype(np.float32)
    ctx = rng.normal(size=(1, 7, 48)).astype(np.float32)
    ctx[:, 5:] = 0.0
    return x, np.array([731.0], np.float32), ctx


def t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def j(a):
    return None if a is None else jnp.asarray(a)


CONTROL = {"none": None, "full": 3, "shorter": 2, "scaled": 3}


@pytest.mark.parametrize("case", list(CONTROL))
def test_vace_matches_jax(vace, case):
    ref, port = vace
    x, ts, ctx = inputs()
    frames = CONTROL[case]
    ctl = None if frames is None else np.random.default_rng(1).normal(
        size=(1, 12, frames, *LATENT[1:])).astype(np.float32)
    scale = np.array([0.5, 1.5], np.float32) if case == "scaled" else None
    want = nnx.jit(lambda m, *a: m(*a))(ref, j(x), j(ts), j(ctx), j(ctl), j(scale))
    with torch.no_grad():
        got = port(t(x), t(ts), t(ctx), control=t(ctl), control_scale=t(scale))
    assert tuple(got.shape) == (1, 4, *LATENT)
    assert_rel_l2(got, want, TOL)


def test_vace_scale_zero_is_no_control(vace):
    _, port = vace
    x, ts, ctx = inputs()
    ctl = torch.randn(1, 12, *LATENT, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        off = port(t(x), t(ts), t(ctx), control=ctl, control_scale=torch.zeros(2))
        base = port(t(x), t(ts), t(ctx))
        on = port(t(x), t(ts), t(ctx), control=ctl)
    torch.testing.assert_close(off, base, rtol=0, atol=1e-6)
    assert (on - base).abs().max() > 1e-3


def test_vace_default_layers_match_jax():
    cfg = dict(TINY, num_layers=16)
    ref = nnx.eval_shape(lambda: jax_wan.WanVACETransformer3DModel(jax_wan.WanConfig(**cfg), **F32))
    with torch.device("meta"):
        port = wan.WanVACETransformer3DModel(wan.WanConfig(**cfg), dtype=torch.float32)
    assert port.cfg.vace_layers == tuple(ref.cfg.vace_layers) == (0, 2, 4, 6, 8, 10, 12, 14)
    assert len(port.vace_blocks) == 8 and port.vace_blocks[0].proj_in is not None
    assert all(b.proj_in is None for b in port.vace_blocks[1:])


@pytest.mark.parametrize("with_ref", [True, False], ids=["subject_ref_padded", "no_ref"])
def test_fun_matches_jax(fun, with_ref):
    ref, port = fun
    x, ts, ctx = inputs(3)
    sub = np.random.default_rng(4).normal(size=(1, 2, 2, *LATENT[1:])).astype(np.float32) if with_ref else None
    want = nnx.jit(lambda m, *a: m(*a))(ref, j(x), j(ts), j(ctx), j(sub))
    with torch.no_grad():
        got = port(t(x), t(ts), t(ctx), subject_ref=t(sub))
    assert tuple(got.shape) == (1, 4, *LATENT)
    assert_rel_l2(got, want, TOL)


# a cache of 4 latent frames of 5 × 6 tokens; block 1 = frame 0, block 2 = frames 1-2
FRAME = 30
S_MAX = 4 * FRAME
WINDOWS = {"full": (-1, 0), "local_45_sink_15": (45, 15)}


@pytest.mark.parametrize("window", list(WINDOWS))
def test_causal_two_blocks_and_cache_match_jax(causal, window):
    ref, port = causal
    local, sink = WINDOWS[window]

    @nnx.jit(static_argnames=("local", "sink"))
    def jax_step(m, x, tt, ctx, kc, vc, pos, cos, sin, local, sink):
        return m.forward_causal(x, tt, ctx, kc, vc, pos, cos, sin, local_tokens=local, sink_tokens=sink)

    kc_j, vc_j = ref.init_cache(1, S_MAX)
    kc_p, vc_p = port.init_cache(1, S_MAX)
    assert tuple(kc_p.shape) == kc_j.shape == (2, 1, S_MAX, 2, 32)
    ctx_np = inputs()[2]
    for blk, (start, n) in enumerate(((0, 1), (1, 2))):
        rng = np.random.default_rng(20 + blk)
        x = rng.normal(size=(1, 4, n, *LATENT[1:])).astype(np.float32)
        tt = np.full((1, n), 500.0 - 100 * blk, np.float32)
        cos_j, sin_j = ref.causal_rope_tables(start, n, 5, 6)
        cos_p, sin_p = port.causal_rope_tables(start, n, 5, 6)
        np.testing.assert_allclose(cos_p.numpy(), cos_j, rtol=0, atol=1e-6)
        np.testing.assert_allclose(sin_p.numpy(), sin_j, rtol=0, atol=1e-6)
        want, (kc_j, vc_j) = jax_step(ref, j(x), j(tt), j(ctx_np), kc_j, vc_j, jnp.int32(start * FRAME),
                                      j(cos_j), j(sin_j), local, sink)
        with torch.no_grad():
            got, (kc_p, vc_p) = port.forward_causal(t(x), t(tt), t(ctx_np), kc_p, vc_p, start * FRAME, cos_p,
                                                    sin_p, local_tokens=local, sink_tokens=sink)
        assert tuple(got.shape) == (1, 4, n, *LATENT[1:])
        assert_rel_l2(got, want, TOL)
        assert_rel_l2(kc_p, kc_j, TOL)
        assert_rel_l2(vc_p, vc_j, TOL)
        end = (start + n) * FRAME
        assert not kc_p[:, :, end:].any() and kc_p[:, :, :end].abs().min() > 0


def test_causal_mask_matches_the_jax_rule(causal):
    _, port = causal
    # block at cache_pos 60 of 30 tokens: valid < 90, window [45, 90) plus sink [0, 15)
    m = port.causal_mask(2, S_MAX, 60, 30, local_tokens=45, sink_tokens=15)[0].numpy()
    pos = np.arange(S_MAX)
    np.testing.assert_array_equal(m, ((pos >= 45) & (pos < 90)) | (pos < 15))
    np.testing.assert_array_equal(port.causal_mask(1, S_MAX, 60, 30)[0].numpy(), pos < 90)


def test_registry_names():
    _load_builtin_families()
    assert transformer_registry.get("wan.causal") is wan.WanCausalTransformer3DModel
    assert transformer_registry.get("WanCausalTransformer3DModel") is wan.WanCausalTransformer3DModel
    assert transformer_registry.get("wan.vace") is wan.WanVACETransformer3DModel
    for name in ("wan.fun", "wan.phantom", "Wan2_2FunTransformerModel"):
        assert transformer_registry.get(name) is wan.WanFunTransformer3DModel
    assert wan.WanConfig.from_dict({"vace_layers": [0, 5]}).vace_layers == (0, 5)


@pytest.mark.parametrize("variant", ["vace", "fun", "causal"])
def test_checkpoint_round_trip_through_published_names(variant):
    """A variant's state dict in diffusers' naming (``loaders/export.py``):
    VACE's ``vace_patch_embedding`` as its Conv3d weight and its blocks'
    ``proj_in`` / ``proj_out``; loads back bit-equal through the ``wan``
    converter, and JAX's converter names every key alike."""
    from apex_studio_tpu.loaders.converters import convert_keys as jax_convert_keys
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.loaders.converters import convert_keys
    from apex_studio_tpu_torch.loaders.export import published_state_dict
    from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict

    cls, cfg = {"vace": (wan.WanVACETransformer3DModel, VACE), "fun": (wan.WanFunTransformer3DModel, TINY),
                "causal": (wan.WanCausalTransformer3DModel, TINY)}[variant]
    model = materialize_random(lambda: cls(wan.WanConfig(**cfg), dtype=torch.float32), torch.device("cpu"), seed=4)
    sd = published_state_dict("wan", model.state_dict())
    if variant == "vace":
        assert tuple(sd["vace_patch_embedding.weight"].shape) == (64, 12, 1, 2, 2)
        assert {"vace_blocks.0.proj_in.weight", "vace_blocks.1.proj_out.bias",
                "vace_blocks.1.attn1.to_out.0.weight", "vace_blocks.0.ffn.net.0.proj.weight"} <= set(sd)
    converted = convert_keys("wan", sd)
    with torch.device("meta"):
        back = cls(wan.WanConfig(**cfg), dtype=torch.float32)
    apply_state_dict(back, converted, device="cpu", strict=True)
    for name, value in model.state_dict().items():
        assert torch.equal(back.state_dict()[name], value), name
    assert sorted(jax_convert_keys("wan", {k: v.numpy() for k, v in sd.items()})) == sorted(converted)
