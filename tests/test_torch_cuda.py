"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA card. The file
imports no JAX, so it runs on a machine without it:
``python -m pytest tests/test_torch_cuda.py --noconftest -q``.
Tolerance: bf16 on unit-normal inputs, max|Δ| ≤ 2e-2·max|ref| and
‖Δ‖₂ ≤ 1e-2·‖ref‖₂. Both scale with the output, whose typical size falls as
Sk grows, so a kernel that drops a key tile cannot pass at a long Sk.
"""

import pytest
import torch

from apex_studio_tpu_torch.ops.attention import _prep_bias
from apex_studio_tpu_torch.ops.attention.flash import flash_attention, flash_attention_reference

def assert_agrees(out, ref):
    d, r = out.float() - ref.float(), ref.float()
    assert d.abs().max().item() <= 2e-2 * r.abs().max().item()
    assert torch.linalg.vector_norm(d).item() <= 1e-2 * torch.linalg.vector_norm(r).item()


# (name, b, sq, sk, h, d, key lengths or None, causal); a length of 0 masks
# every key of that batch row, one length for b > 1 gives a [1, Sk] bias, and a
# negative length -n masks the first n keys instead. The second half sits on
# the edges of the kernel's 128 x 128 tiles and its two 64-row warpgroups.
CASES = [
    ("aligned", 1, 128, 128, 2, 128, None, False),
    ("ragged_kv", 2, 72, 200, 4, 128, None, False),
    ("ragged_q", 1, 100, 64, 3, 64, None, False),
    ("key_padding_bias", 2, 64, 96, 2, 128, [50, 96], False),
    ("fully_masked_row", 2, 64, 160, 2, 64, [50, 0], False),
    ("causal", 1, 384, 384, 4, 64, None, True),
    ("causal_ragged", 1, 200, 200, 2, 128, None, True),
    ("flux_length_kv", 1, 256, 4608, 4, 128, None, False),
    ("sq129_sk257", 1, 129, 257, 4, 128, None, False),
    ("sq129_sk257_d64", 2, 129, 257, 3, 64, None, False),
    ("sq40_sk1", 2, 40, 1, 3, 128, None, False),
    ("sk128_exact", 1, 200, 128, 4, 128, None, False),
    ("sk129", 1, 200, 129, 4, 128, None, False),
    ("causal_s384_d128", 1, 384, 384, 4, 128, None, True),
    ("causal_s200_b2_d128", 2, 200, 200, 3, 128, None, True),
    ("shared_bias_batch_stride_0", 2, 150, 300, 4, 128, [211], False),
    ("first_key_tile_bias_masked", 1, 130, 300, 4, 128, [-128], False),
    # HunyuanVideo 1.5's token refiner: 1000 Qwen2.5-VL tokens, 16 heads, a [1, Sk] text mask
    ("hyv15_refiner_sk1000_bias", 1, 1000, 1000, 16, 128, [612], False),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_kernel_matches_plain_version(case, cuda):
    _, b, sq, sk, h, d, lengths, causal = case
    g = torch.Generator(cuda).manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).to(torch.bfloat16)
               for s in (sq, sk, sk))
    bias = None
    if lengths is not None:
        cols, n = torch.arange(sk, device=cuda)[None, :], torch.tensor(lengths, device=cuda)[:, None]
        mask = torch.where(n < 0, cols >= -n, cols < n)
        bias = _prep_bias(None, mask)
    before = flash_attention.launches
    out = flash_attention(q, k, v, bias=bias, is_causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_reference(q, k, v, bias=bias, is_causal=causal)
    assert torch.isfinite(out.float()).all()
    assert_agrees(out, ref)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_bshd(cuda):
    """q/k/v as views of one fused projection (non-contiguous BSHD)."""
    g = torch.Generator(cuda).manual_seed(1)
    qkv = torch.randn(1, 256, 3, 4, 128, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out = flash_attention(q, k, v)
    ref = flash_attention_reference(q, k, v)
    assert_agrees(out, ref)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn(1, 16, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q, q, q)
    q = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :32], q[..., :32], q[..., :32])
    q72 = torch.randn(1, 16, 2, 72, device=cuda).to(torch.bfloat16)  # SigLIP so400m's heads
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q72, q72, q72)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [34257, 113457], ids=["hyv15_33_frames", "hyv15_121_frames"])
def test_flash_kernel_hyv15_joint_attention_row_subsets(s, cuda):
    """HunyuanVideo 1.5's joint attention at 720p (16 heads of 128, no mask).
    The plain version's f32 scores cannot be held whole (75 GB at 34,257
    tokens), so it is computed over all keys for three 128-row subsets of the
    kernel's output: the first tile, the last (ragged) tile and one across an
    interior tile edge."""
    g = torch.Generator(cuda).manual_seed(2)
    q, k, v = (torch.randn(1, s, 16, 128, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    tail = s % 128 or 128
    edge = s // 256 * 128
    for rows in (slice(0, 128), slice(s - tail, s), slice(edge - 64, edge + 64)):
        ref = flash_attention_reference(q[:, rows], k, v)
        assert torch.isfinite(out[:, rows].float()).all()
        assert_agrees(out[:, rows], ref)


# -- int8 / int4 resident Linear -------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 17, 40])
def test_int_mm_small_m_is_exact(m, cuda):
    """``torch._int_mm`` on the card refuses 16 rows or fewer; ``int_mm`` pads
    them with zero rows and slices, which changes no value."""
    from apex_studio_tpu_torch.models.layers import int_mm

    g = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, 256), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (64, 256), generator=g, dtype=torch.int8)
    out = int_mm(a.to(cuda), w.to(cuda))
    assert out.dtype == torch.int32 and tuple(out.shape) == (m, 64)
    assert torch.equal(out.cpu().long(), a.long() @ w.long().t())


@pytest.mark.cuda
def test_int_mm_rejects_k_not_multiple_of_8(cuda):
    from apex_studio_tpu_torch.models.layers import int_mm

    a = torch.zeros(32, 63, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        int_mm(a, torch.zeros(8, 63, dtype=torch.int8, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(1, 512), (2, 33, 512)], ids=["row_1", "batch_2x33"])
def test_resident_linear_matches_the_cpu(bits, shape, cuda):
    """The same resident Linear on the card and on the CPU, f32 compute:
    ‖Δ‖₂ ≤ 1e-4·‖ref‖₂ for int4 (two f32 products summed in another order) and
    2e-3 for W8A8 (``x / sx`` on a rounding tie may fall one step apart)."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.layers import Linear
    from apex_studio_tpu_torch.quantize.residency import apply_int4_residency, apply_int8_residency

    lin = materialize_random(lambda: Linear(512, 384, dtype=torch.float32), torch.device("cpu"), seed=bits)
    assert (apply_int4_residency if bits == 4 else apply_int8_residency)(lin, min_numel=1) == 1
    on_card = materialize_random(lambda: Linear(512, 384, dtype=torch.float32), cuda, seed=0)
    on_card.set_quantized(lin.weight.to(cuda), lin.weight_scale.to(cuda), bits)
    on_card.bias.data.copy_(lin.bias)
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(1))
    ref, out = lin(x), on_card(x.to(cuda)).cpu()
    assert out.shape == ref.shape
    rel = (torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref)).item()
    assert rel <= (1e-4 if bits == 4 else 2e-3), rel
