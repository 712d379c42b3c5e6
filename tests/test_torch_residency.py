"""The port's int8 / int4 weight residency against the JAX package's, on the CPU.

Same seeded numpy inputs through both. Tolerances:

- quantization (``quantize_kernel_int8/int4``): bytes and scales equal to the
  JAX functions' after the transpose ([in, out] ↔ [out, in]);
- dequant and int4 Linear in f32: max|Δ| ≤ 1e-4·max|ref| (two f32 products
  summed in another order);
- W8A8 Linear in f32: ‖Δ‖₂ ≤ 2e-3·‖ref‖₂ and the quantized activations equal
  in ≥ 99.9% of entries. The int32 product is exact in both; ``x/sx`` may
  differ by one ulp between XLA and torch, which moves a value that sits on a
  rounding tie by one step;
- the JAX package's own gates, re-stated for the port: W8A8 within 1% of the
  dequant path for one matmul and within 3% through a Flux block.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from apex_studio_tpu.models.layers import Linear as JaxLinear
from apex_studio_tpu.models.transformers import flux as jax_flux
from apex_studio_tpu.quantize import residency as jax_residency
from apex_studio_tpu_torch.engine.base import materialize_random
from apex_studio_tpu_torch.models.layers import Linear, int_mm
from apex_studio_tpu_torch.models.transformers.flux import FluxConfig, FluxTransformer2DModel
from apex_studio_tpu_torch.quantize import residency
from tests.torch_port_helpers import assert_close, port_from_jax


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


@pytest.mark.parametrize("shape", [(64, 32), (128, 96), (3, 8)], ids=str)
class TestQuantizeBytes:
    """``shape`` is the JAX kernel's [in, out]."""

    def kernel(self, shape):
        k = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
        k[:, 1] = 0.0  # an all-zero output channel takes scale 1
        return k

    def test_int8_equals_jax_transposed(self, shape):
        k = self.kernel(shape)
        q_ref, s_ref = jax_residency.quantize_kernel_int8(k)
        q, s = residency.quantize_kernel_int8(k.T)
        assert q.dtype == np.int8 and q.shape == shape[::-1]
        np.testing.assert_array_equal(q, q_ref.T)
        np.testing.assert_array_equal(s, s_ref)

    def test_int4_packed_bytes_equal_jax_transposed(self, shape):
        k = self.kernel(shape)
        p_ref, s_ref = jax_residency.quantize_kernel_int4(k)
        p, s = residency.quantize_kernel_int4(k.T)
        assert p.dtype == np.uint8 and p.shape == (shape[1] // 2, shape[0])
        np.testing.assert_array_equal(p, p_ref.T)
        np.testing.assert_array_equal(s, s_ref)


def test_int4_rejects_odd_out():
    with pytest.raises(ValueError, match="even"):
        residency.quantize_kernel_int4(np.ones((3, 8), np.float32))


def linear_pair(mode, din=128, dout=96, bias=True):
    """A JAX Linear made resident in ``mode`` and the port's, carried from it."""
    jl = JaxLinear(din, dout, use_bias=bias, dtype=jnp.float32, param_dtype=jnp.float32,
                   rngs=nnx.Rngs(1))
    if bias:
        jl.bias.value = jnp.asarray(np.random.default_rng(5).normal(size=dout), jnp.float32)
    apply = jax_residency.apply_int4_residency if mode == "w4" else jax_residency.apply_int8_residency
    assert apply(jl, min_numel=1) == 1
    pl = port_from_jax(lambda: Linear(din, dout, use_bias=bias, dtype=torch.float32), jl)
    return jl, pl


INPUTS = {"rows_4": (4, 128), "row_1": (1, 128), "batch_2x5": (2, 5, 128)}


@pytest.mark.parametrize("mode", ["dequant", "w8a8", "w4"])
@pytest.mark.parametrize("shape", INPUTS.values(), ids=INPUTS.keys())
class TestLinearAgainstJax:
    def test_forward_matches_jax(self, mode, shape, monkeypatch):
        monkeypatch.setenv("APEX_INT8_COMPUTE", "0" if mode == "dequant" else "1")
        jl, pl = linear_pair(mode)
        assert pl.weight_bits == (4 if mode == "w4" else 8)
        assert pl.weight.dtype == (torch.uint8 if mode == "w4" else torch.int8)
        x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
        ref = np.asarray(jl(jnp.asarray(x)))
        out = pl(torch.from_numpy(x))
        assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
        if mode == "w8a8":
            assert rel_l2(out.numpy(), ref) <= 2e-3
        else:
            assert_close(out, ref)


def test_carried_int4_bytes_are_jax_bytes_transposed():
    jl, pl = linear_pair("w4")
    np.testing.assert_array_equal(pl.weight.numpy(), np.asarray(jl.kernel.value).T)
    np.testing.assert_array_equal(pl.weight_scale.numpy(), np.asarray(jl.kernel_scale.value))


def test_w8a8_quantized_activations_equal_jax():
    x = np.random.default_rng(3).normal(size=(64, 256)).astype(np.float32)
    xj = jnp.asarray(x)
    sx = jnp.maximum(jnp.max(jnp.abs(xj), axis=-1, keepdims=True), 1e-6) / 127.0
    ref = np.asarray(jnp.clip(jnp.rint(xj / sx), -127, 127).astype(jnp.int8))
    xt = torch.from_numpy(x)
    st = xt.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / 127.0
    ours = torch.round(xt / st).clamp_(-127, 127).to(torch.int8).numpy()
    assert (ours == ref).mean() >= 0.999
    assert np.abs(ours.astype(np.int16) - ref.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("m,k,n", [(1, 63, 5), (1, 64, 8), (16, 128, 24), (17, 128, 24), (40, 72, 16)])
def test_int_mm_is_exact(m, k, n):
    rng = np.random.default_rng(m * k + n)
    a = rng.integers(-127, 128, size=(m, k), dtype=np.int8)
    w = rng.integers(-127, 128, size=(n, k), dtype=np.int8)
    out = int_mm(torch.from_numpy(a), torch.from_numpy(w))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)


def test_zero_activation_row_quantizes_to_zero():
    """What pads the rows on the card: a zero row has scale 1e-6/127, quantizes
    to zero and yields the bias alone."""
    _, pl = linear_pair("w8a8")
    out = pl(torch.zeros(2, 128))
    torch.testing.assert_close(out, pl.bias.expand(2, -1), rtol=0, atol=0)


class TestGates:
    """tests/test_residency.py's gates on the port's own modules."""

    def resident_linear(self, bits, din, dout, seed):
        """The JAX gate's Linear (its seeded init) carried into the port, then
        made resident by the port; and the plain product on the f32 weights."""
        jl = JaxLinear(din, dout, dtype=jnp.float32, param_dtype=jnp.float32, rngs=nnx.Rngs(seed))
        lin = port_from_jax(lambda: Linear(din, dout, dtype=torch.float32), jl)
        w, b = lin.weight.detach().clone(), lin.bias.detach().clone()
        apply = residency.apply_int4_residency if bits == 4 else residency.apply_int8_residency
        assert apply(lin, min_numel=1) == 1
        return lin, lambda x: torch.nn.functional.linear(x, w, b)

    @pytest.mark.parametrize("bits,limit", [(8, 1e-2), (4, 1e-1)])
    def test_residency_error_bound(self, bits, limit, monkeypatch):
        monkeypatch.setenv("APEX_INT8_COMPUTE", "0")
        lin, plain = self.resident_linear(bits, 128, 96, seed=1)
        x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 128)).astype(np.float32))
        assert rel_l2(lin(x).numpy(), plain(x).numpy()) < limit

    def test_w8a8_matches_dequant_within_gate(self, monkeypatch):
        lin, _ = self.resident_linear(8, 256, 192, seed=2)
        x = torch.from_numpy(np.random.default_rng(2).normal(size=(8, 256)).astype(np.float32))
        monkeypatch.setenv("APEX_INT8_COMPUTE", "0")
        y_deq = lin(x)
        monkeypatch.setenv("APEX_INT8_COMPUTE", "1")
        assert rel_l2(lin(x).numpy(), y_deq.numpy()) < 1e-2

    def test_w8a8_block_gate(self, monkeypatch):
        """One double and one single Flux block, weights carried from the JAX
        model made int8-resident there: W8A8 within 3% of the dequant path in
        the port, and both paths against JAX's."""
        kw = dict(num_layers=1, num_single_layers=1, attention_head_dim=32, num_attention_heads=4,
                  joint_attention_dim=64, pooled_projection_dim=32, axes_dims_rope=(8, 12, 12))
        jm = jax_flux.FluxTransformer2DModel(jax_flux.FluxConfig(**kw), dtype=jnp.float32,
                                             param_dtype=jnp.float32, rngs=nnx.Rngs(0))
        n = jax_residency.apply_int8_residency(jm, min_numel=1 << 10)
        pm = port_from_jax(lambda: FluxTransformer2DModel(FluxConfig(**kw), dtype=torch.float32), jm)
        assert residency.count_resident(pm) == n > 0
        rng = np.random.default_rng(3)
        x = rng.normal(size=(1, 16, 64)).astype(np.float32)
        txt = rng.normal(size=(1, 8, 64)).astype(np.float32)
        pooled = rng.normal(size=(1, 32)).astype(np.float32)
        t, g = np.array([0.5], np.float32), np.array([3.5], np.float32)
        outs = {}
        for flag in ("0", "1"):
            monkeypatch.setenv("APEX_INT8_COMPUTE", flag)
            ref = np.asarray(jm(*map(jnp.asarray, (x, txt, pooled, t)), guidance=jnp.asarray(g),
                                grid_hw=(4, 4)))
            with torch.inference_mode():
                outs[flag] = pm(*map(torch.from_numpy, (x, txt, pooled, t, g)), grid_hw=(4, 4)).numpy()
            # dequant: f32 sums in another order; W8A8: rounding ties through the blocks
            assert rel_l2(outs[flag], ref) <= (1e-4 if flag == "0" else 5e-3)
        assert rel_l2(outs["1"], outs["0"]) < 3e-2


TINY = dict(in_channels=16, out_channels=16, num_layers=1, num_single_layers=1,
            attention_head_dim=32, num_attention_heads=2, joint_attention_dim=48,
            pooled_projection_dim=32, axes_dims_rope=(8, 12, 12))


class TestMaterializeRandom:
    @pytest.mark.parametrize("bits", [8, 4])
    def test_meta_to_cpu_fills_every_leaf(self, bits):
        with torch.device("meta"):
            model = FluxTransformer2DModel(FluxConfig(**TINY), dtype=torch.bfloat16)
        fill = residency.materialize_random_int4 if bits == 4 else residency.materialize_random_int8
        n = fill(model, device="cpu", min_numel=64 * 64, seed=7)
        linears = [m for m in model.modules() if isinstance(m, Linear)]
        big = [m for m in linears if m.weight_scale is not None]
        assert n == len(big) == residency.count_resident(model) > 0
        for m in linears:
            out_f = m.bias.shape[0]
            if m.weight_scale is None:
                assert m.weight.dtype == torch.bfloat16 and m.weight.numel() < 64 * 64
                continue
            assert m.weight_bits == bits
            in_f = m.weight.shape[1]
            assert m.weight.dtype == (torch.uint8 if bits == 4 else torch.int8)
            assert m.weight.shape[0] == (out_f // 2 if bits == 4 else out_f)
            qmax = 7.0 if bits == 4 else 127.0
            assert m.weight_scale.dtype == torch.float32 and m.weight_scale.shape == (out_f,)
            np.testing.assert_allclose(m.weight_scale.numpy(), 0.02 / np.sqrt(in_f) / qmax, rtol=1e-6)
            w = m.weight.to(torch.int16)
            assert (w.min() >= (0 if bits == 4 else -127)) and w.unique().numel() > 100
        tensors = list(model.parameters()) + list(model.buffers())
        assert not any(t.is_meta for t in tensors) and all(t.device.type == "cpu" for t in tensors)
        assert all(torch.isfinite(t).all() for t in tensors if t.is_floating_point())
        rng = np.random.default_rng(0)
        with torch.inference_mode():
            y = model(torch.from_numpy(rng.normal(size=(1, 16, 16)).astype(np.float32)),
                      torch.from_numpy(rng.normal(size=(1, 6, 48)).astype(np.float32)),
                      torch.from_numpy(rng.normal(size=(1, 32)).astype(np.float32)),
                      torch.tensor([0.5]), torch.tensor([3.5]), grid_hw=(4, 4))
        assert y.shape == (1, 16, 16) and torch.isfinite(y.float()).all()

    def test_seeded(self):
        def make(seed):
            with torch.device("meta"):
                lin = Linear(64, 32, dtype=torch.float32)
            residency.materialize_random_int8(lin, device="cpu", min_numel=1, seed=seed)
            return lin.weight
        assert torch.equal(make(3), make(3)) and not torch.equal(make(3), make(4))

    def test_odd_out_stays_unquantized_at_int4(self):
        with torch.device("meta"):
            lin = Linear(64, 33, dtype=torch.float32)
        assert residency.materialize_random_int4(lin, device="cpu", min_numel=1) == 0
        assert lin.weight.dtype == torch.float32 and lin.weight_scale is None

    def test_full_flux_resident_count_equals_jax(self):
        """At full Flux Dev width and depth, on abstract models: the same
        weights cross the 2**20 threshold in both packages."""
        jm = nnx.eval_shape(lambda: jax_flux.FluxTransformer2DModel(
            jax_flux.FluxConfig(), dtype=jnp.bfloat16, param_dtype=jnp.bfloat16, rngs=nnx.Rngs(0)))
        n_jax = sum(jax_residency._is_quantizable(m, jax_residency.DEFAULT_MIN_NUMEL)
                    for _, m in nnx.iter_modules(jm))
        with torch.device("meta"):
            pm = FluxTransformer2DModel(FluxConfig(), dtype=torch.bfloat16)
        n_port = sum(residency._is_quantizable(m, residency.DEFAULT_MIN_NUMEL, 8) for m in pm.modules())
        assert n_port == n_jax == 500


class TestApplyResidency:
    @pytest.mark.parametrize("bits", [8, 4])
    def test_apply_equals_jax_apply(self, bits):
        """Quantizing in the port what JAX quantizes from the same f32 weights
        gives the same bytes."""
        jl = JaxLinear(48, 40, dtype=jnp.float32, param_dtype=jnp.float32, rngs=nnx.Rngs(4))
        pl = port_from_jax(lambda: Linear(48, 40, dtype=torch.float32), jl)
        j_apply, p_apply = ((jax_residency.apply_int4_residency, residency.apply_int4_residency)
                            if bits == 4 else
                            (jax_residency.apply_int8_residency, residency.apply_int8_residency))
        assert j_apply(jl, min_numel=1) == p_apply(pl, min_numel=1) == 1
        np.testing.assert_array_equal(pl.weight.numpy(), np.asarray(jl.kernel.value).T)
        np.testing.assert_array_equal(pl.weight_scale.numpy(), np.asarray(jl.kernel_scale.value))
        assert p_apply(pl, min_numel=1) == 0  # already resident

    def test_min_numel_threshold(self):
        model = materialize_random(lambda: FluxTransformer2DModel(FluxConfig(**TINY), dtype=torch.float32),
                                   torch.device("cpu"), seed=0)
        assert residency.apply_int8_residency(model) == 0  # nothing reaches 2**20 elements
        assert residency.DEFAULT_MIN_NUMEL == jax_residency.DEFAULT_MIN_NUMEL == 1 << 20
