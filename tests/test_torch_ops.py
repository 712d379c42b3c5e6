"""The port's shared ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both. f32 tolerance:
max|Δ| ≤ 1e-4·max|ref| unless a case says otherwise. The flash wrapper runs
its plain version here (CPU tensors); tests/test_torch_cuda.py holds the CUDA
kernel itself against that plain version on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_studio_tpu.ops import attention as jax_attention
from apex_studio_tpu.ops import embeddings as jax_emb
from apex_studio_tpu.ops import norms as jax_norms
from apex_studio_tpu.ops import rope as jax_rope
from apex_studio_tpu.ops.attention.pallas_flash import flash_attention as jax_flash
from apex_studio_tpu_torch.ops.attention import _prep_bias
from apex_studio_tpu_torch.ops.attention import attention as port_attention
from apex_studio_tpu_torch.ops import embeddings as port_emb
from apex_studio_tpu_torch.ops import norms as port_norms
from apex_studio_tpu_torch.ops import rope as port_rope
from apex_studio_tpu_torch.ops.attention.flash import (
    flash_attention,
    flash_attention_reference,
    flash_attention_tiled_reference,
)

REL = 1e-4


def close(out, ref, rel=REL):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-6), (err, np.abs(ref).max())


def rnd(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


class TestNorms:
    @pytest.mark.parametrize("with_weight", [False, True])
    def test_rms_norm(self, with_weight):
        x, w = rnd(2, 5, 32), rnd(32, seed=1) if with_weight else None
        ref = jax_norms.rms_norm(jnp.asarray(x), None if w is None else jnp.asarray(w), eps=1e-6)
        close(port_norms.rms_norm(t(x), None if w is None else t(w), eps=1e-6), ref)

    @pytest.mark.parametrize("affine", [False, True])
    def test_layer_norm(self, affine):
        x = rnd(2, 5, 48) * 3 + 1
        w, b = (rnd(48, seed=1), rnd(48, seed=2)) if affine else (None, None)
        ref = jax_norms.layer_norm(jnp.asarray(x), None if w is None else jnp.asarray(w),
                                   None if b is None else jnp.asarray(b))
        close(port_norms.layer_norm(t(x), None if w is None else t(w), None if b is None else t(b)), ref)

    def test_bf16_input_keeps_dtype(self):
        x = torch.from_numpy(rnd(4, 64)).to(torch.bfloat16)
        out = port_norms.layer_norm(x)
        assert out.dtype == torch.bfloat16
        ref = jax_norms.layer_norm(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
        close(out.float(), np.asarray(ref, np.float32), rel=1e-2)

    def test_modulate_and_gate(self):
        x, s, h, g = rnd(2, 3, 8), rnd(2, 1, 8, seed=1), rnd(2, 1, 8, seed=2), rnd(2, 1, 8, seed=3)
        close(port_norms.modulate(t(x), t(s), t(h)),
              jax_norms.modulate(jnp.asarray(x), jnp.asarray(s), jnp.asarray(h)))
        close(port_norms.gate(t(x), t(g)), jax_norms.gate(jnp.asarray(x), jnp.asarray(g)))


class TestRoPE:
    def test_numpy_tables_are_float64_built(self):
        ids = np.stack(np.meshgrid(np.arange(3), np.arange(4), np.arange(5), indexing="ij"), -1)
        ids = ids.reshape(-1, 3)
        c, s = port_rope.precompute_axial_freqs(ids, (8, 12, 12))
        rc, rs = jax_rope.precompute_axial_freqs(ids, (8, 12, 12))
        assert c.dtype == np.float32
        np.testing.assert_array_equal(c, rc)
        np.testing.assert_array_equal(s, rs)

    def test_tensor_tables_match_jax_f32_path(self):
        ids = np.random.default_rng(0).integers(0, 64, size=(1, 40, 3)).astype(np.int32)
        c, s = port_rope.precompute_axial_freqs(t(ids), (16, 56, 56))
        rc, rs = jax_rope.precompute_axial_freqs(jnp.asarray(ids), (16, 56, 56))
        np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=1e-5)

    def test_apply_rope_interleaved_pairs(self):
        x = rnd(1, 10, 2, 16)
        ids = np.arange(10)[None, :, None]
        c, s = jax_rope.precompute_axial_freqs(ids, [16])
        ref = jax_rope.apply_rope(jnp.asarray(x), c[:, :, None, :], s[:, :, None, :])
        out = port_rope.apply_rope(t(x), t(c)[:, :, None, :], t(s)[:, :, None, :])
        close(out, ref)


class TestTimestepEmbedding:
    @pytest.mark.parametrize("flip,dim", [(True, 256), (False, 256), (True, 33)])
    def test_matches_jax(self, flip, dim):
        tt = np.array([0.0, 1.5, 999.0], np.float32)
        ref = jax_emb.timestep_embedding(jnp.asarray(tt), dim, flip_sin_to_cos=flip)
        out = port_emb.timestep_embedding(t(tt), dim, flip_sin_to_cos=flip)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def qkv(b, sq, sk, h, d, seed=0):
    return rnd(b, sq, h, d, seed=seed), rnd(b, sk, h, d, seed=seed + 1), rnd(b, sk, h, d, seed=seed + 2)


def key_mask(sk, lengths):
    return np.arange(sk)[None, :] < np.asarray(lengths)[:, None]


# (name, b, sq, sk, h, d, key lengths or None, causal). Key lengths give a
# [B, Sk] padding mask; a length of 0 masks every key of that batch row.
FLASH_CASES = [
    ("aligned", 1, 128, 128, 2, 32, None, False),
    ("ragged_kv", 1, 72, 200, 2, 32, None, False),
    ("key_padding_bias", 2, 64, 96, 2, 32, [50, 96], False),
    ("causal", 1, 64, 64, 2, 32, None, True),
    # Sk = 128 has no tail block in Pallas; with a tail, Pallas averages the
    # zero padding instead of V for such a row (a JAX-side fault).
    ("fully_masked_row", 2, 64, 128, 2, 32, [50, 0], False),
]


# Cases on the edges of the kernel's 128-row and 128-key tiles and of the two
# 64-row halves of a query tile: (name, b, sq, sk, h, d, bias, causal). bias is
# None, "shared" (a [1, Sk] key-padding bias over the last third of the keys)
# or "late" (the first 128 keys masked, so the running max starts at
# -1e30·log2 e and must recover on the next tile).
TILE_EDGE_CASES = [
    ("sq129_sk257", 1, 129, 257, 2, 32, None, False),
    ("sq40_sk1", 2, 40, 1, 2, 32, None, False),
    ("sk128_exact", 1, 72, 128, 2, 32, None, False),
    ("sk129", 1, 72, 129, 2, 32, None, False),
    ("causal_s200", 1, 200, 200, 2, 32, None, True),
    ("causal_s384", 1, 384, 384, 1, 32, None, True),
    ("shared_bias_b2", 2, 150, 300, 2, 32, "shared", False),
    ("first_key_tile_bias_masked", 1, 130, 300, 2, 32, "late", False),
]


def tile_edge_bias(kind, sk):
    if kind is None:
        return None
    keep = np.arange(sk) < 2 * sk // 3 if kind == "shared" else np.arange(sk) >= 128
    return _prep_bias(None, t(keep[None, :]))  # [1, 1, 1, Sk]


class TestFlashAttention:
    @pytest.mark.parametrize("case", TILE_EDGE_CASES, ids=[c[0] for c in TILE_EDGE_CASES])
    def test_tiled_reference_matches_plain_and_pallas(self, case):
        """The tile-by-tile emulation of the CUDA kernel against the plain
        version and the Pallas kernel (interpret mode), f32:
        max|Δ| ≤ 2e-5·max|ref| (sums taken tile by tile, exp2 against exp)."""
        _, b, sq, sk, h, d, kind, causal = case
        q, k, v = qkv(b, sq, sk, h, d, seed=11)
        bias = tile_edge_bias(kind, sk)
        out = flash_attention_tiled_reference(t(q), t(k), t(v), bias=bias, is_causal=causal)
        assert torch.isfinite(out).all()
        close(out, flash_attention_reference(t(q), t(k), t(v), bias=bias, is_causal=causal), rel=2e-5)
        pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           bias=None if bias is None else jnp.asarray(bias.numpy()),
                           is_causal=causal, interpret=True)
        close(out, pallas, rel=2e-5)

    @pytest.mark.parametrize("case", TILE_EDGE_CASES, ids=[c[0] for c in TILE_EDGE_CASES])
    def test_tiled_reference_bf16(self, case):
        """The same emulation on bf16 inputs (P rounded to bf16 before P·V)
        against the plain version: max|Δ| ≤ 2e-2·max|ref|, ‖Δ‖₂ ≤ 1e-2·‖ref‖₂."""
        _, b, sq, sk, h, d, kind, causal = case
        q, k, v = (t(a).to(torch.bfloat16) for a in qkv(b, sq, sk, h, d, seed=12))
        bias = tile_edge_bias(kind, sk)
        out = flash_attention_tiled_reference(q, k, v, bias=bias, is_causal=causal)
        assert out.dtype == torch.bfloat16 and out.shape == q.shape
        ref = flash_attention_reference(q, k, v, bias=bias, is_causal=causal).float()
        delta = out.float() - ref
        assert delta.abs().max().item() <= 2e-2 * ref.abs().max().item()
        assert torch.linalg.vector_norm(delta).item() <= 1e-2 * torch.linalg.vector_norm(ref).item()

    def test_tiled_reference_reads_views_of_fused_projection(self):
        fused = t(rnd(2, 257, 3, 2, 32, seed=13))
        q, k, v = fused.unbind(2)
        close(flash_attention_tiled_reference(q, k, v), flash_attention_reference(q, k, v), rel=2e-5)

    def test_tiled_reference_fully_masked_row_is_mean_of_v(self):
        q, k, v = qkv(2, 72, 160, 2, 16)
        bias = _prep_bias(None, t(key_mask(160, [50, 0])))
        out = flash_attention_tiled_reference(t(q), t(k), t(v), bias=bias)
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out[1].numpy(), np.broadcast_to(v[1].mean(0), (72, 2, 16)),
                                   atol=1e-5)
        close(out, flash_attention_reference(t(q), t(k), t(v), bias=bias), rel=2e-5)

    @pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
    def test_reference_and_dispatcher_match_pallas(self, case, monkeypatch):
        monkeypatch.setenv("APEX_PALLAS_INTERPRET", "1")
        _, b, sq, sk, h, d, lengths, causal = case
        q, k, v = qkv(b, sq, sk, h, d)
        mask = None if lengths is None else key_mask(sk, lengths)
        ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            mask=None if mask is None else jnp.asarray(mask),
                            is_causal=causal, backend="pallas_flash")
        naive = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mask=None if mask is None else jnp.asarray(mask),
                              is_causal=causal, backend="naive")
        out = port_attention(t(q), t(k), t(v), mask=None if mask is None else t(mask),
                             is_causal=causal)
        close(out, ref)
        close(out, naive)
        bias = None if mask is None else _prep_bias(None, t(mask))
        close(flash_attention_reference(t(q), t(k), t(v), bias=bias, is_causal=causal), ref)

    def test_fully_masked_row_is_mean_of_v(self):
        q, k, v = qkv(2, 8, 40, 2, 16)
        mask = key_mask(40, [40, 0])
        out = port_attention(t(q), t(k), t(v), mask=t(mask))
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out[1].numpy(), np.broadcast_to(v[1].mean(0), (8, 2, 16)),
                                   atol=1e-5)

    def test_scale_and_bias_2d(self):
        q, k, v = qkv(2, 16, 24, 2, 32)
        bias = rnd(2, 24, seed=9)
        ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias),
                        scale=0.3, interpret=True)
        close(flash_attention(t(q), t(k), t(v), bias=t(bias), scale=0.3), ref)

    def test_rich_bias_routes_to_xla(self, monkeypatch):
        monkeypatch.setenv("APEX_PALLAS_INTERPRET", "1")
        q, k, v = qkv(1, 16, 16, 2, 32)
        bias = rnd(1, 2, 16, 16, seed=5)  # per-head, per-query
        ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            bias=jnp.asarray(bias), backend="pallas_flash")
        close(port_attention(t(q), t(k), t(v), bias=t(bias)), ref)
        with pytest.raises(ValueError, match="key-padding"):
            flash_attention(t(q), t(k), t(v), bias=t(bias))

    @pytest.mark.parametrize("backend", ["naive", "xla"])
    @pytest.mark.parametrize("causal", [False, True])
    def test_plain_backends_match_jax(self, backend, causal):
        q, k, v = qkv(2, 24, 24, 3, 16, seed=4)
        ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=causal,
                            backend=backend)
        close(port_attention(t(q), t(k), t(v), is_causal=causal, backend=backend), ref)

    def test_causal_needs_square(self):
        q, k, v = qkv(1, 8, 16, 1, 16)
        with pytest.raises(ValueError, match="Sq == Sk"):
            flash_attention(t(q), t(k), t(v), is_causal=True)

    @pytest.mark.parametrize("backend", ["naive", "xla"])
    def test_clip_empty_prompt_mask(self, backend):
        """CLIP's causal & padding mask for an empty prompt masks every key:
        the finite -1e30 gives JAX's uniform average, not NaN."""
        s = 6
        q, k, v = qkv(2, s, s, 2, 16)
        attn_mask = np.array([[1, 1, 1, 0, 0, 0], [0] * s], bool)
        mask = np.tril(np.ones((s, s), bool))[None, None] & attn_mask[:, None, None, :]
        ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            mask=jnp.asarray(mask), backend=backend)
        out = port_attention(t(q), t(k), t(v), mask=t(mask), backend=backend)
        assert torch.isfinite(out).all()
        close(out, ref)

    def test_bf16_reference_on_cpu(self):
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in qkv(1, 32, 48, 2, 64))
        out = flash_attention(q, k, v)
        assert out.dtype == torch.bfloat16
        ref = jax_attention(*(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (q, k, v)),
                            backend="naive")
        ref = torch.from_numpy(np.asarray(ref, np.float32))
        d = out.float() - ref
        assert d.abs().max().item() <= 2e-2 * ref.abs().max().item()
        assert torch.linalg.vector_norm(d).item() <= 1e-2 * torch.linalg.vector_norm(ref).item()
