"""The flash kernel's head dims beyond 64 and 128, on the CPU.

The CUDA kernel runs a head dim d (a multiple of 8 from 16 to 128) on its 64-
or 128-wide template, with the columns past d zero-filled by TMA and only d
columns stored. Here, where no card is: the tile-by-tile emulation of that
algorithm (``flash_attention_tiled_reference``, which pads the columns as the
tensor maps fill them) against the plain version, and the plain version
against the Pallas TPU kernel in interpret mode, at SAM2's head dims (Hiera-B+
56, its decoder's 32 and 16, Hiera-L's 72, Hiera-T/S's 96).
Tolerance, f32: max|Δ| ≤ 2e-5·max|ref| (sums taken tile by tile, exp2
against exp), as tests/test_torch_ops.py holds the 64 and 128 cases.
tests/test_torch_cuda.py holds the kernel itself on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_studio_tpu.ops.attention.pallas_flash import flash_attention as jax_flash
from apex_studio_tpu_torch.ops.attention import _prep_bias
from apex_studio_tpu_torch.ops.attention.flash import (
    flash_attention,
    flash_attention_reference,
    flash_attention_tiled_reference,
    padded_head_dim,
)

REL = 2e-5


def close(out, ref, rel=REL):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-6), (err, np.abs(ref).max())


def qkv(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, d)).astype(np.float32) for s in (sq, sk, sk))


def t(x):
    return torch.from_numpy(np.asarray(x))


# (name, b, sq, sk, h, d, key lengths or None, causal): a ragged Sk across
# the 128-key tile edge, a [B, Sk] bias, causal, a window batch as Hiera makes
# it, the decoder's few tokens
CASES = [
    ("d16_ragged", 2, 40, 150, 2, 16, None, False),
    ("d16_decoder_image_to_token", 1, 130, 10, 4, 16, None, False),
    ("d32_decoder_self", 1, 10, 10, 4, 32, None, False),
    ("d56_window_batch", 16, 49, 49, 2, 56, None, False),
    ("d56_key_padding_bias", 2, 70, 257, 2, 56, [200, 77], False),
    ("d56_causal", 1, 150, 150, 2, 56, None, True),
    ("d72_ragged", 1, 129, 257, 2, 72, None, False),
    ("d72_bias", 2, 60, 140, 2, 72, [140, 3], False),
    ("d96_ragged", 1, 33, 130, 3, 96, None, False),
]


def bias_of(lengths, sk):
    if lengths is None:
        return None
    keep = np.arange(sk)[None, :] < np.asarray(lengths)[:, None]
    return _prep_bias(None, t(keep))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_zero_padded_columns_equal_the_plain_version(case):
    """The kernel's algorithm with the head dim zero-padded to its template's
    width equals the plain version at the real head dim and scale."""
    _, b, sq, sk, h, d, lengths, causal = case
    q, k, v = (t(x) for x in qkv(b, sq, sk, h, d, seed=d + sq))
    bias = bias_of(lengths, sk)
    out = flash_attention_tiled_reference(q, k, v, bias=bias, is_causal=causal)
    assert out.shape == (b, sq, h, d) and torch.isfinite(out).all()
    close(out, flash_attention_reference(q, k, v, bias=bias, is_causal=causal))
    # the padding is the template's: 64 up to 64 columns, 128 above
    assert padded_head_dim(d) == (64 if d <= 64 else 128)


@pytest.mark.parametrize("case", [c for c in CASES if c[5] in (16, 56)], ids=lambda c: c[0])
def test_plain_version_matches_pallas_interpret(case):
    """The plain version (what the CPU runs and the card is held to) against
    the Pallas TPU kernel in interpret mode at SAM2's head dims."""
    _, b, sq, sk, h, d, lengths, causal = case
    q, k, v = qkv(b, sq, sk, h, d, seed=d + sq + 1)
    bias = bias_of(lengths, sk)
    out = flash_attention(t(q), t(k), t(v), bias=bias, is_causal=causal)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    bias=None if bias is None else jnp.asarray(bias.numpy()), is_causal=causal, interpret=True)
    close(out, ref)


def test_tiled_reference_bf16_at_d56():
    """Hiera-B+'s head dim in bf16 (P rounded to bf16 before P·V, as on the
    card) against the plain version: max|Δ| ≤ 2e-2·max|ref|, ‖Δ‖₂ ≤
    1e-2·‖ref‖₂."""
    q, k, v = (t(x).to(torch.bfloat16) for x in qkv(2, 130, 257, 2, 56, seed=5))
    out = flash_attention_tiled_reference(q, k, v).float()
    ref = flash_attention_reference(q, k, v).float()
    assert (out - ref).abs().max() <= 2e-2 * ref.abs().max()
    assert torch.linalg.vector_norm(out - ref) <= 1e-2 * torch.linalg.vector_norm(ref)


@pytest.mark.parametrize("d", [8, 60, 136])
def test_head_dims_the_kernel_does_not_take_raise(d):
    with pytest.raises(ValueError, match="head dim"):
        padded_head_dim(d)
