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

from apex_studio_tpu_torch.ops.attention import _prep_bias, one_query_wide_head_attention
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
    # ZImage at 1024px, 30 heads: main layers over 4096 image + 128 caption
    # tokens, the noise refiner over 4096, the context refiner over a caption bucket
    ("zimage_layers_s4224_h30", 1, 4224, 4224, 30, 128, None, False),
    ("zimage_noise_refiner_s4096_h30", 1, 4096, 4096, 30, 128, None, False),
    ("zimage_caption_s128_h30", 1, 128, 128, 30, 128, None, False),
    # Qwen3's decode step: one query row over the KV cache, the valid prefix as
    # a key-padding bias ([1, Sk], then [B, Sk] with a ragged Sk)
    ("qwen3_decode_sq1_sk300_bias", 1, 1, 300, 32, 128, [292], False),
    ("qwen3_decode_sq1_sk437_bias_b2", 2, 1, 437, 32, 128, [400, 437], False),
    ("decode_sq1_sk1_no_bias", 1, 1, 1, 32, 128, None, False),
    # QwenImage at 1024px, 24 heads, one unmasked joint launch a block: an edit
    # with one condition image (4096 + 4096 + a 64-token text bucket, not a
    # multiple of 128) and edit_plus with two (4096 + 2 x 4096 + 64)
    ("qwenimage_edit_s8256_h24", 1, 8256, 8256, 24, 128, None, False),
    ("qwenimage_edit_plus_s12352_h24", 1, 12352, 12352, 24, 128, None, False),
    # Wan 2.2 A14B, 40 heads, unmasked: self-attention over a 480x832 frame
    # (1560 tokens) and a 1024² image (4096), cross-attention of those and of
    # an 81-frame clip (32,760 tokens) over the 512 UMT5 rows
    ("wan_self_s1560_h40", 1, 1560, 1560, 40, 128, None, False),
    ("wan_cross_sq1560_sk512_h40", 1, 1560, 512, 40, 128, None, False),
    ("wan_self_s4096_h40", 1, 4096, 4096, 40, 128, None, False),
    ("wan_cross_sq4096_sk512_h40", 1, 4096, 512, 40, 128, None, False),
    ("wan_cross_sq32760_sk512_h40", 1, 32760, 512, 40, 128, None, False),
    # Wan 2.1 i2v's image cross-attention over the 257 CLIP tokens (one key in
    # the last tile), first–last frame's over 514, at a reduced query length
    ("wan21_image_cross_sq4096_sk257_h40", 1, 4096, 257, 40, 128, None, False),
    ("fflf_image_cross_sq4096_sk514_h40", 1, 4096, 514, 40, 128, None, False),
    # the causal block against the whole cache (12 heads), reduced: one block
    # of a frame (1560 tokens) against a cache of 6 frames, the first block
    # (valid keys = the block's own) and the last (every key valid)
    ("causal_first_block_sq1560_sk9360_bias_h12", 1, 1560, 9360, 12, 128, [1560], False),
    ("causal_last_block_sq1560_sk9360_bias_h12", 1, 1560, 9360, 12, 128, [9360], False),
    # FLUX.2 t2i at 1024px: 512 text + 4096 image tokens, 48 heads
    ("flux2_t2i_s4608_h48", 1, 4608, 4608, 48, 128, None, False),
    # HunyuanVideo's token refiner: 256 llava-llama-3 slots, 24 heads, a 60-token prompt kept
    ("hyv_refiner_s256_bias_h24", 1, 256, 256, 24, 128, [60], False),
    # HuMo's per-frame audio cross-attention at 97 frames of 480x832: each of
    # the 25 latent frames' 1560 tokens against its 16 audio tokens (the
    # frames as the batch), 40 heads
    ("humo_audio_cross_b25_sq1560_sk16_h40", 25, 1560, 16, 40, 128, None, False),
    # Wan S2V at 480x832, 80 frames a chunk: the audio injector (each of the 20
    # latent frames' 1560 tokens against 4 audio tokens and a padding token)
    # and the text cross-attention of a chunk with its motion tokens (35,074)
    ("s2v_audio_injector_b20_sq1560_sk5_h40", 20, 1560, 5, 40, 128, None, False),
    ("s2v_text_cross_sq35074_sk512_h40", 1, 35074, 512, 40, 128, None, False),
    # MultiTalk at 81 frames: two speakers' 2 x 32 audio tokens a latent frame,
    # and the CLIP image cross-attention over 257 keys at the clip's 32,760 queries
    ("multitalk_audio_cross_b21_sq1560_sk64_h40", 21, 1560, 64, 40, 128, None, False),
    ("multitalk_clip_cross_sq32760_sk257_h40", 1, 32760, 257, 40, 128, None, False),
    # head dims other than 64 and 128, on the 64- and 128-wide templates with
    # the columns past the head dim zero-filled by TMA: SAM2's Hiera-B+ at
    # 1024² (head dim 56: stage 1's windows of 8, stage 3's q-pool, windows of
    # 14 and global blocks, stage 4's windows of 7), its mask decoder (8 heads
    # of 32 over its 10 tokens, of 16 between them and the 64 x 64 image), the
    # other published trunks' global blocks (Hiera-L 72, Hiera-T/S 96), and a
    # bias, a ragged Sk and causal at the new widths
    ("sam2_window8_b1024_s64_h2_d56", 1024, 64, 64, 2, 56, None, False),
    ("sam2_qpool3_sq4096_sk16384_h8_d56", 1, 4096, 16384, 8, 56, None, False),
    ("sam2_window14_b25_s196_h8_d56", 25, 196, 196, 8, 56, None, False),
    ("sam2_global_s4096_h8_d56", 1, 4096, 4096, 8, 56, None, False),
    ("sam2_window7_b25_s49_h16_d56", 25, 49, 49, 16, 56, None, False),
    ("sam2_decoder_self_s10_h8_d32", 1, 10, 10, 8, 32, None, False),
    ("sam2_decoder_token_to_image_sq10_sk4096_h8_d16", 1, 10, 4096, 8, 16, None, False),
    ("sam2_decoder_image_to_token_sq4096_sk10_h8_d16", 1, 4096, 10, 8, 16, None, False),
    ("hiera_l_global_s4096_h8_d72", 1, 4096, 4096, 8, 72, None, False),
    ("hiera_s_global_s4096_h4_d96", 1, 4096, 4096, 4, 96, None, False),
    ("d56_key_padding_bias_b2", 2, 130, 257, 4, 56, [200, 77], False),
    ("d16_ragged_sq129_sk257", 1, 129, 257, 3, 16, None, False),
    ("d72_causal_s200", 1, 200, 200, 2, 72, None, True),
    ("d96_fully_masked_row", 2, 64, 160, 2, 96, [50, 0], False),
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
    q = torch.randn(1, 16, 2, 64, device=cuda).to(torch.float16)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q, q, q)
    # head dims that are no multiple of 8, or outside 16..128 (16..128 in
    # steps of 8 run: SAM2's 56, 32 and 16 among them)
    for d in (60, 8, 136):
        qd = torch.randn(1, 16, 2, d, device=cuda).to(torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(qd, qd, qd)
    # head dim 56 read from rows 60 columns (120 bytes) apart: no tensor map
    wide = torch.randn(1, 16, 2, 60, device=cuda).to(torch.bfloat16)[..., :56]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(wide, wide, wide)


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


@pytest.mark.cuda
def test_flash_kernel_wan_81_frame_self_attention_row_subsets(cuda):
    """Wan's self-attention over an 81-frame 480x832 clip (32,760 tokens, 40
    heads of 128): the plain version's f32 scores would take 172 GB, so it is
    computed over all keys for the first, the last (ragged, 120 rows) and one
    interior-edge 128-row subset of the kernel's output."""
    s = 32760
    g = torch.Generator(cuda).manual_seed(3)
    q, k, v = (torch.randn(1, s, 40, 128, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    for rows in (slice(0, 128), slice(s - s % 128, s), slice(s // 256 * 128 - 64, s // 256 * 128 + 64)):
        ref = flash_attention_reference(q[:, rows], k, v)
        assert torch.isfinite(out[:, rows].float()).all()
        assert_agrees(out[:, rows], ref)


@pytest.mark.cuda
def test_flash_kernel_causal_window_and_sink_bias(cuda):
    """A causal block against its cache with a local window and sink tokens
    (``WanCausalTransformer3DModel.causal_mask``): the key tiles between the
    sink and the window are wholly masked, and must give exactly what the
    plain version gives."""
    from apex_studio_tpu_torch.models.transformers.wan import WanCausalTransformer3DModel

    mask = WanCausalTransformer3DModel.causal_mask(1, 9360, 6240, 1560, local_tokens=3120,
                                                   sink_tokens=1560, device=cuda)
    g = torch.Generator(cuda).manual_seed(4)
    q = torch.randn(1, 1560, 12, 128, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(1, 9360, 12, 128, generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    bias = _prep_bias(None, mask)
    out = flash_attention(q, k, v, bias=bias)
    assert_agrees(out, flash_attention_reference(q, k, v, bias=bias))
    # the masked keys do not count: the same attention over the valid keys alone
    keep = mask[0]
    assert_agrees(out, flash_attention_reference(q, k[:, keep], v[:, keep]))


@pytest.mark.cuda
def test_flash_kernel_vace_self_attention_row_subsets(cuda):
    """VACE's self-attention at 81 frames plus one reference frame (22 × 1560
    = 34,320 tokens, 40 heads of 128) on three 128-row subsets of the
    kernel's output, the plain version over all keys."""
    s = 34320
    g = torch.Generator(cuda).manual_seed(5)
    q, k, v = (torch.randn(1, s, 40, 128, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    for rows in (slice(0, 128), slice(s - s % 128, s), slice(s // 256 * 128 - 64, s // 256 * 128 + 64)):
        ref = flash_attention_reference(q[:, rows], k, v)
        assert torch.isfinite(out[:, rows].float()).all()
        assert_agrees(out[:, rows], ref)


@pytest.mark.cuda
def test_flash_kernel_hunyuanvideo_joint_attention_with_text_bias(cuda):
    """HunyuanVideo's joint attention at 33 frames of 720x1280: 32,400 image
    and 256 text tokens, 24 heads of 128, the text key padding as a [1, S]
    bias keeping a 60-token prompt. The plain version's scores cannot be held
    whole (102 GB), so it is computed over all keys for three 128-row subsets
    of the kernel's output (the first tile, the last with the text queries,
    one across an interior tile edge), and over the kept keys alone."""
    s = 9 * 45 * 80 + 256
    g = torch.Generator(cuda).manual_seed(7)
    q, k, v = (torch.randn(1, s, 24, 128, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    bias = torch.zeros(1, s, device=cuda)
    bias[:, s - 256 + 60:] = -1e30
    out = flash_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    keep = bias[0] == 0
    for rows in (slice(0, 128), slice(s - s % 128, s), slice(s // 256 * 128 - 64, s // 256 * 128 + 64)):
        assert torch.isfinite(out[:, rows].float()).all()
        assert_agrees(out[:, rows], flash_attention_reference(q[:, rows], k, v, bias=bias))
        assert_agrees(out[:, rows], flash_attention_reference(q[:, rows], k[:, keep], v[:, keep]))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [56, 72, 96])
def test_flash_kernel_reads_hiera_fused_qkv_views_in_f32(d, cuda):
    """Hiera's attention: f32 q/k/v as views of one fused projection at the
    published trunks' head dims, one launch on bf16 tiles, f32 out."""
    g = torch.Generator(cuda).manual_seed(d)
    qkv = torch.randn(2, 196, 3, 4, d, generator=g, device=cuda)
    q, k, v = qkv.unbind(2)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1 and out.dtype == torch.float32
    assert_agrees(out, flash_attention_reference(q, k, v))


@pytest.mark.cuda
def test_sam2_launches_the_kernel_per_attention(cuda):
    """A small SAM2 image model on the card (Hiera head dim 16, decoder 32 and
    16): one launch a Hiera block, 3 a two-way block and the final one; its
    mask logits within 1e-2 rel L2 of the plain attention's (the kernel's bf16
    rounding of q/k/v and P, as chip_smoke.py's ``SAM2_LOGITS_REL_L2``)."""
    from apex_studio_tpu_torch.mask.sam2 import SAM2Config, SAM2ImageModel
    from apex_studio_tpu_torch.ops.attention import attention_registry

    torch.manual_seed(0)
    cfg = SAM2Config(embed_dim=32, num_heads=2, stages=(1, 1, 2, 1), window_specs=(4, 4, 4, 4),
                     global_att_blocks=(2,), img_size=128, d_model=128, decoder_heads=4, decoder_mlp_dim=256)
    model = SAM2ImageModel(cfg).to(cuda).eval()
    img = torch.rand(1, 128, 128, 3, device=cuda)
    pts = torch.tensor([[[0.5, 0.5], [0.2, 0.3], [0.0, 0.0], [0.0, 0.0]]], device=cuda)
    labels = torch.tensor([[1, 0, -1, -1]], device=cuda)
    before = flash_attention.launches
    with torch.no_grad():
        masks = model.predict(img, pts, labels)[0]
        assert flash_attention.launches == before + sum(cfg.stages) + 3 * cfg.decoder_depth + 1
        attention_registry._entries["flash"] = flash_attention_reference
        try:
            plain = model.predict(img, pts, labels)[0]
        finally:
            attention_registry._entries["flash"] = flash_attention
    rel = (torch.linalg.vector_norm(masks - plain) / torch.linalg.vector_norm(plain)).item()
    assert torch.isfinite(masks).all() and rel <= 1e-2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [97, 33])
def test_flash_kernel_takes_f32_through_bf16_tiles(frames, cuda):
    """HuMo's wav2vec2 self-attention in f32 (12 heads of 64 over the audio
    features resampled to one a video frame): one launch on bf16 tiles, the
    output in f32, against the plain version in f32 on the same inputs."""
    g = torch.Generator(cuda).manual_seed(frames)
    q, k, v = (torch.randn(1, frames, 12, 64, generator=g, device=cuda) for _ in range(3))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert_agrees(out, flash_attention_reference(q, k, v))


@pytest.mark.cuda
def test_wav2vec2_launches_the_kernel_once_a_layer(cuda):
    """A small wav2vec2 (head dim 64) on the card in f32: one launch an
    encoder layer; every hidden state finite and f32."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.audio.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model

    model = materialize_random(lambda: Wav2Vec2Model(Wav2Vec2Config(
        hidden_size=128, num_hidden_layers=3, num_attention_heads=2, intermediate_size=256, conv_dim=(32,) * 7,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)), cuda, seed=0)
    wav = 0.1 * torch.randn(1, 16000, generator=torch.Generator().manual_seed(1)).to(cuda)
    with torch.inference_mode():
        before = flash_attention.launches
        states = model(wav, seq_len=33)
    assert flash_attention.launches == before + 3
    assert all(s.dtype == torch.float32 and s.shape == (1, 33, 128) and torch.isfinite(s).all() for s in states)


@pytest.mark.cuda
def test_hunyuanvideo_and_humo_dits_launch_the_kernel_per_attention(cuda):
    """Small HunyuanVideo and HuMo DiTs (head dim 128) in bf16 on the card:
    HunyuanVideo one joint launch a dual and a single block (the text mask
    as the bias) plus one a refiner block; HuMo three a block (self, text
    cross and the per-frame audio cross-attention); outputs finite."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers import hunyuanvideo as hv
    from apex_studio_tpu_torch.models.transformers import wan_humo

    g = torch.Generator().manual_seed(0)
    hyv = materialize_random(lambda: hv.HunyuanVideoTransformer3DModel(hv.HunyuanVideoConfig(
        num_attention_heads=2, num_layers=2, num_single_layers=3, text_embed_dim=64, pooled_projection_dim=32,
        image_condition_type="token_replace")), cuda, seed=0)
    x = torch.randn(1, 16, 3, 8, 10, generator=g).to(cuda)
    text = torch.randn(1, 40, 64, generator=g).to(cuda)
    mask = (torch.arange(40) < 25)[None].to(cuda)
    t = torch.tensor([500.0], device=cuda)
    humo = materialize_random(lambda: wan_humo.HumoWanTransformerModel(wan_humo.WanHuMoConfig(
        dim=256, ffn_dim=512, num_heads=2, num_layers=3, text_dim=64, audio_kv_dim=64, audio_window=2,
        audio_blocks=2, audio_channels=16, audio_intermediate_dim=32)), cuda, seed=1)
    with torch.inference_mode():
        before = flash_attention.launches
        out = hyv(x, t, text, mask, pooled=torch.randn(1, 32, generator=g).to(cuda), guidance=t * 12)
        assert flash_attention.launches == before + 2 + 3 + 2
        assert out.shape == x.shape and torch.isfinite(out.float()).all()
        before = flash_attention.launches
        out = humo(x, t, text, torch.randn(1, 3, 2, 2, 16, generator=g).to(cuda),
                   torch.randn(1, 20, 3, 8, 10, generator=g).to(cuda))
        assert flash_attention.launches == before + 3 * 3
        assert out.shape == x.shape and torch.isfinite(out.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("s,h", [(35074, 40), (9 * 1024 + 1024 + 256, 24), (33 * 1024 + 1024 + 256, 24)],
                         ids=["s2v_self_s35074_h40", "avatar_joint_s10496_bias_h24", "avatar_joint_s35072_bias_h24"])
def test_flash_kernel_audio_video_self_attention_row_subsets(s, h, cuda):
    """S2V's self-attention over a chunk with its motion tokens (40 heads)
    and the Avatar's joint attention over [reference | latent frames | 256
    text slots] at 512x512 (24 heads, a [1, S] bias keeping a 60-token
    prompt), for one window of 9 and of 33 latent frames: three 128-row
    subsets of the kernel's output against the plain version over all keys."""
    g = torch.Generator(cuda).manual_seed(s)
    q, k, v = (torch.randn(1, s, h, 128, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    bias = None
    if h == 24:
        bias = torch.zeros(1, s, device=cuda)
        bias[:, s - 256 + 60:] = -1e30
    out = flash_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    for rows in (slice(0, 128), slice(s - (s % 128 or 128), s), slice(s // 256 * 128 - 64, s // 256 * 128 + 64)):
        assert torch.isfinite(out[:, rows].float()).all()
        assert_agrees(out[:, rows], flash_attention_reference(q[:, rows], k, v, bias=bias))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [10200, 6120, 2040], ids=["skyreels_df_window", "skyreels_i2v_9_frames",
                                                          "skyreels_t2v_frame"])
def test_flash_kernel_skyreels_self_attention(s, cuda):
    """SkyReels V2 at 544x960 (34 x 60 tokens a latent frame, 40 heads of
    128): diffusion forcing's 5-frame window (10,200 tokens), a 9-frame i2v
    clip and one t2v frame; the whole output against the plain version, the
    window's over its first, last and one interior-edge 128-row subset."""
    g = torch.Generator(cuda).manual_seed(s)
    q, k, v = (torch.randn(1, s, 40, 128, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    subsets = ((slice(0, 128), slice(s - (s % 128 or 128), s), slice(s // 256 * 128 - 64, s // 256 * 128 + 64))
               if s > 8192 else (slice(0, s),))
    for rows in subsets:
        assert torch.isfinite(out[:, rows].float()).all()
        assert_agrees(out[:, rows], flash_attention_reference(q[:, rows], k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("frames,heads", [(499, 16), (80, 12)], ids=["s2v_wav2vec2_large", "multitalk_wav2vec2"])
def test_flash_kernel_audio_encoder_f32_shapes(frames, heads, cuda):
    """The audio encoders' f32 self-attention, head dim 64: wav2vec2-large
    (16 heads) over S2V's 10 s clip at 50 Hz, the base encoder (12 heads) over
    MultiTalk's 80 video frames; bf16 tiles, f32 out, against the plain
    version in f32."""
    g = torch.Generator(cuda).manual_seed(frames)
    q, k, v = (torch.randn(1, frames, heads, 64, generator=g, device=cuda) for _ in range(3))
    out = flash_attention(q, k, v)
    assert out.dtype == torch.float32
    assert_agrees(out, flash_attention_reference(q, k, v))


@pytest.mark.cuda
def test_audio_video_dits_launch_the_kernel_per_attention(cuda):
    """Small S2V, MultiTalk and Avatar DiTs (head dim 128) in bf16 on the
    card: S2V two a block and one an injector layer; MultiTalk four a block
    (self, text, CLIP and audio cross-attention), two speakers; the Avatar
    the HunyuanVideo DiT's joint launches and the refiner's, its perceiver
    adapter on the plain route; outputs finite."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers import hunyuanvideo_avatar as av
    from apex_studio_tpu_torch.models.transformers import wan_multitalk as mt
    from apex_studio_tpu_torch.models.transformers import wan_s2v

    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(cuda)

    t = torch.tensor([500.0], device=cuda)
    s2v = materialize_random(lambda: wan_s2v.WanS2VTransformer3DModel(wan_s2v.WanS2VConfig(
        num_attention_heads=2, num_layers=3, ffn_dim=256, text_dim=64, audio_dim=32, num_wav2vec_layers=3,
        audio_inject_layers=(0, 2), enable_framepack=True, pose_dim=16)), cuda, seed=0)
    talk = materialize_random(lambda: mt.WanMultiTalkTransformer3DModel(mt.WanMultiTalkConfig(
        num_attention_heads=2, num_layers=3, ffn_dim=256, text_dim=64, image_dim=32, added_kv_proj_dim=256,
        audio_blocks=2, audio_channels=16, intermediate_dim=32, audio_output_dim=32, context_tokens=4)), cuda,
        seed=1)
    avatar = materialize_random(lambda: av.HunyuanAvatarVideoModel(av.HunyuanAvatarConfig(
        num_attention_heads=2, num_layers=2, num_single_layers=3, text_embed_dim=64, pooled_projection_dim=32,
        audio_seq_len=2, audio_blocks=2, audio_channels=8, audio_intermediate_dim=32, audio_output_dim=256,
        double_stream_list=(1,))), cuda, seed=2)
    with torch.inference_mode():
        before = flash_attention.launches
        # 3 latent frames and 2 motion frames: (9 + 11) audio columns quarter to 5 frames
        out = s2v(rand(1, 16, 3, 16, 16), t, rand(1, 20, 64), rand(1, 16, 2, 16, 16), rand(1, 3, 32, 11),
                  rand(1, 16, 1, 16, 16), rand(1, 16, 3, 16, 16), motion_frames=(9, 2))
        assert flash_attention.launches == before + 2 * 3 + 2
        assert out.shape == (1, 16, 3, 16, 16) and torch.isfinite(out.float()).all()
        masks = torch.zeros(3, 64, device=cuda)
        masks[0, :32], masks[1, 32:], masks[2, ::5] = 1.0, 1.0, 1.0
        before = flash_attention.launches
        out = talk(rand(1, 36, 3, 16, 16), t, rand(1, 20, 64), rand(1, 5, 32), rand(2, 9, 5, 2, 16), masks)
        assert flash_attention.launches == before + 4 * 3
        assert out.shape == (1, 16, 3, 16, 16) and torch.isfinite(out.float()).all()
        before = flash_attention.launches
        mask = (torch.arange(40) < 25)[None].to(cuda)
        out = avatar(rand(1, 16, 3, 8, 8), t, rand(1, 40, 64), mask, pooled=rand(1, 32),
                     ref_latents=rand(1, 16, 3, 8, 8), audio=rand(1, 9, 2, 2, 8))
        assert flash_attention.launches == before + 2 + 3 + 2
        assert out.shape == (1, 16, 3, 8, 8) and torch.isfinite(out.float()).all()


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


# -- the ZImage path -------------------------------------------------------------------


@pytest.mark.cuda
def test_qwen3_decode_step_runs_the_kernel_once_a_layer(cuda):
    """A small Qwen3 in bf16 on the card: ``decode_step`` launches the kernel
    once a layer (prefill none: its mask is per query) and agrees with a full
    recompute of the sequence within 3e-2 relative L2."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.text_encoders.qwen3 import Qwen3Config, Qwen3TextEncoder

    cfg = Qwen3Config(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=3,
                      num_attention_heads=4, num_key_value_heads=2, head_dim=128)
    model = materialize_random(lambda: Qwen3TextEncoder(cfg), cuda, seed=0, std=0.05)
    ids = torch.randint(0, 512, (1, 20), generator=torch.Generator().manual_seed(0)).to(cuda)
    with torch.inference_mode():
        before = flash_attention.launches
        _, caches = model.prefill(ids[:, :16], torch.ones(1, 16, dtype=torch.int32, device=cuda), cache_len=20)
        assert flash_attention.launches == before
        for pos in range(16, 20):
            h, caches = model.decode_step(ids[:, pos:pos + 1], pos, caches)
        assert flash_attention.launches == before + 3 * 4
        full = model(ids, attention_mask=torch.ones_like(ids), normalize_last=True)[0, -1]
    rel = (torch.linalg.vector_norm(h[0, 0].float() - full.float()) / torch.linalg.vector_norm(full.float())).item()
    assert rel <= 3e-2, rel


@pytest.mark.cuda
def test_zimage_dit_launches_the_kernel_per_attention(cuda):
    """A small ZImage DiT (head dim 128) in bf16 on the card: one launch per
    attention (2 + 2 refiner blocks, 2 layers), output finite."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers.zimage import ZImageConfig, ZImageTransformer2DModel

    cfg = ZImageConfig(dim=256, n_layers=2, n_heads=2, n_kv_heads=2, cap_feat_dim=64)
    model = materialize_random(lambda: ZImageTransformer2DModel(cfg), cuda, seed=0)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 16, 1, 18, 22, generator=g).to(cuda)  # 99 image tokens, padded to 128
    cap = torch.randn(1, 32, 64, generator=g).to(cuda)
    with torch.inference_mode():
        before = flash_attention.launches
        out = model(x, torch.tensor([0.5], device=cuda), cap, torch.arange(32, device=cuda)[None] < 20)
    assert flash_attention.launches == before + 2 + 2 + 2
    assert out.shape == x.shape and torch.isfinite(out.float()).all()


# -- the QwenImage path ---------------------------------------------------------------


@pytest.mark.cuda
def test_qwenimage_dit_and_controlnet_launch_the_kernel_per_block(cuda):
    """A small QwenImage DiT and ControlNet (head dim 128) in bf16 on the
    card: one joint launch a block, the condition grid's tokens included,
    output finite."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers import qwenimage

    small = dict(num_attention_heads=2, joint_attention_dim=64, axes_dims_rope=(16, 56, 56))
    model = materialize_random(lambda: qwenimage.QwenImageTransformer2DModel(
        qwenimage.QwenImageConfig(num_layers=3, **small)), cuda, seed=0)
    cn = materialize_random(lambda: qwenimage.QwenImageControlNetModel(
        qwenimage.QwenImageControlNetConfig(num_layers=2, **small)), cuda, seed=1)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2 * 9 * 11, 64, generator=g).to(cuda)  # a 9 x 11 grid and one condition grid
    txt = torch.randn(1, 32, 64, generator=g).to(cuda)
    t = torch.tensor([0.5], device=cuda)
    with torch.inference_mode():
        before = flash_attention.launches
        out = model(x, txt, t, grid_hw=(9, 11), extra_segments=((9, 11),))
        samples = cn(x[:, :99], x[:, 99:], txt, t, grid_hw=(9, 11))
        guided = model(x[:, :99], txt, t, grid_hw=(9, 11), controlnet_block_samples=samples)
    assert flash_attention.launches == before + 3 + 2 + 3
    assert out.shape == (1, 198, 64) and torch.isfinite(out.float()).all()
    assert guided.shape == (1, 99, 64) and torch.isfinite(guided.float()).all()


@pytest.mark.cuda
def test_wan_dit_launches_the_kernel_twice_a_block(cuda):
    """A small Wan DiT (head dim 128) in bf16 on the card: a self- and a
    cross-attention launch a block, output finite and of the latents' shape."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers.wan import WanConfig, WanTransformer3DModel

    cfg = WanConfig(num_attention_heads=2, text_dim=64, ffn_dim=512, num_layers=3)
    model = materialize_random(lambda: WanTransformer3DModel(cfg), cuda, seed=0)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 16, 3, 18, 22, generator=g).to(cuda)  # 3 x 9 x 11 = 297 tokens
    ctx = torch.randn(1, 512, 64, generator=g).to(cuda)
    with torch.inference_mode():
        before = flash_attention.launches
        out = model(x, torch.tensor([500.0], device=cuda), ctx)
    assert flash_attention.launches == before + 2 * 3
    assert out.shape == x.shape and torch.isfinite(out.float()).all()


@pytest.mark.cuda
def test_wan_variants_launch_the_kernel_per_attention(cuda):
    """Small Wan DiTs (head dim 128) in bf16 on the card: Wan 2.1 i2v makes
    three launches a block (self, text and image cross-attention); VACE two
    a main block and two a VACE block; a causal block two a block, the self
    launch over the whole cache with a [1, S_max] bias; outputs finite."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers import wan

    small = dict(num_attention_heads=2, text_dim=64, ffn_dim=512, num_layers=3)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 16, 3, 18, 22, generator=g).to(cuda)  # 3 x 9 x 11 = 297 tokens
    ctx = torch.randn(1, 512, 64, generator=g).to(cuda)
    t = torch.tensor([500.0], device=cuda)
    i2v = materialize_random(lambda: wan.WanTransformer3DModel(wan.WanConfig(
        **small, image_dim=80, added_kv_proj_dim=256)), cuda, seed=0)
    vace = materialize_random(lambda: wan.WanVACETransformer3DModel(wan.WanConfig(
        **small, vace_layers=(0, 2), vace_in_channels=24)), cuda, seed=1)
    causal = materialize_random(lambda: wan.WanCausalTransformer3DModel(wan.WanConfig(**small)), cuda, seed=2)
    with torch.inference_mode():
        before = flash_attention.launches
        out = i2v(x, t, ctx, context_image=torch.randn(1, 257, 80, generator=g).to(cuda))
        assert flash_attention.launches == before + 3 * 3
        assert out.shape == x.shape and torch.isfinite(out.float()).all()
        before = flash_attention.launches
        out = vace(x, t, ctx, control=torch.randn(1, 24, 3, 18, 22, generator=g).to(cuda))
        assert flash_attention.launches == before + 2 * 3 + 2 * 2
        assert torch.isfinite(out.float()).all()
        kc, vc = causal.init_cache(1, 3 * 99)
        before = flash_attention.launches
        for start in range(3):
            rope = causal.causal_rope_tables(start, 1, 9, 11, device=cuda)
            out, _ = causal.forward_causal(x[:, :, start:start + 1], torch.full((1, 1), 500.0, device=cuda), ctx,
                                           kc, vc, start * 99, *rope)
        assert flash_attention.launches == before + 3 * 2 * 3
        assert out.shape == (1, 16, 1, 18, 22) and torch.isfinite(out.float()).all()
        assert kc.abs().amax(dim=(0, 1, 3, 4)).gt(0).all()


# the joint lengths of the editing paths at 1024px: FLUX.2 edit with one
# reference (512 + 2 x 4096, 48 heads), Flux Kontext (the same, 24 heads),
# DreamOmni2 with two references at the 1024² bucket (512 + 3 x 4096, 24 heads)
LONG_EDIT_SHAPES = [("flux2_edit_s8704_h48", 8704, 48), ("kontext_s8704_h24", 8704, 24),
                    ("dreamomni2_s12800_h24", 12800, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LONG_EDIT_SHAPES, ids=[c[0] for c in LONG_EDIT_SHAPES])
def test_flash_kernel_flux_edit_lengths_row_subsets(shape, cuda):
    """The kernel at the Flux editing lengths on three 128-row subsets of its
    output (the first tile, the ragged last and one across a tile edge), the
    plain version over all keys."""
    _, s, h = shape
    g = torch.Generator(cuda).manual_seed(6)
    q, k, v = (torch.randn(1, s, h, 128, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    for rows in (slice(0, 128), slice(s - 128, s), slice(s // 2 - 64, s // 2 + 64)):
        ref = flash_attention_reference(q[:, rows], k, v)
        assert torch.isfinite(out[:, rows].float()).all()
        assert_agrees(out[:, rows], ref)


@pytest.mark.cuda
def test_flux2_dits_launch_the_kernel_per_block(cuda):
    """Small FLUX.2 DiTs (head dim 128) in bf16 on the card: one joint launch
    a dual and a single block, reference tokens included; the control chain
    one more a chain block; outputs finite and of the noise tokens' shape."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers import flux2

    small = dict(in_channels=16, num_layers=2, num_single_layers=3, num_attention_heads=2, joint_attention_dim=64,
                 axes_dims_rope=(32, 32, 32, 32))
    base = materialize_random(lambda: flux2.Flux2Transformer2DModel(flux2.Flux2Config(**small)), cuda, seed=0)
    ctrl = materialize_random(lambda: flux2.Flux2ControlTransformer2DModel(flux2.Flux2ControlConfig(
        **small, control_layers=(0, 1), control_in_dim=36)), cuda, seed=1)
    g = torch.Generator().manual_seed(0)
    x, cond = (torch.randn(1, n, 16, generator=g).to(cuda) for n in (99, 30))
    seq = torch.randn(1, 40, 64, generator=g).to(cuda)
    t, gd = torch.tensor([0.5], device=cuda), torch.tensor([4.0], device=cuda)
    with torch.inference_mode():
        before = flash_attention.launches
        out = base(x, seq, t, gd, grid_hw=(9, 11), cond_tokens=cond, cond_grids=((5, 6),))
        assert flash_attention.launches == before + 2 + 3
        assert out.shape == x.shape and torch.isfinite(out.float()).all()
        before = flash_attention.launches
        out = ctrl(x, seq, t, gd, grid_hw=(9, 11), control_context=torch.randn(1, 99, 36, generator=g).to(cuda))
        assert flash_attention.launches == before + 2 + 3 + 2
        assert out.shape == x.shape and torch.isfinite(out.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,dtype", [(21, 3600, 5, 40, torch.bfloat16), (1, 32760, 24, 40, torch.bfloat16),
                                             (1, 8, 9, 16, torch.float32), (1, 4400, 4400, 24, torch.bfloat16)],
                         ids=["animate_face_cross", "lynx_ip_cross", "lynx_perceiver_f32", "wan5b_self_24_heads"])
def test_flash_kernel_wan_rest_shapes(b, sq, sk, h, dtype, cuda):
    """The last Wan engines' new launch shapes: Animate's face adapter (the
    21 latent frames of a 77-frame 720p segment as the batch, 3600 queries
    over 5 face keys), Lynx's IP cross-attention (8 identity + 16 register
    keys) and its f32 perceiver (16 heads of 64, bf16 tiles, f32 out), and
    TI2V-5B's self-attention at 24 heads over its 17-frame 704x1280 clip
    (4400 tokens); against the plain version (the IP cross over its first,
    last and an interior 128-row subset)."""
    d = 64 if dtype == torch.float32 else 128
    g = torch.Generator(cuda).manual_seed(sq + sk)
    q, k, v = (torch.randn(b, n, h, d, generator=g, device=cuda).to(dtype) for n in (sq, sk, sk))
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    subsets = ((slice(0, 128), slice(sq - (sq % 128 or 128), sq), slice(sq // 256 * 128 - 64, sq // 256 * 128 + 64))
               if sq > 8192 else (slice(0, sq),))
    for rows in subsets:
        assert torch.isfinite(out[:, rows].float()).all()
        assert_agrees(out[:, rows], flash_attention_reference(q[:, rows], k, v))


@pytest.mark.cuda
def test_wan_rest_dits_launch_the_kernel_per_attention(cuda):
    """Small Animate, Lynx, SCAIL and HoloCine DiTs (head dim 128) in bf16 on
    the card: Animate three a block (self, text, CLIP) and its face adapters
    after blocks 0 and 2; Lynx three a block (self, text, IP) and its resampler one a
    layer in f32; SCAIL three a block; HoloCine one a block (its per-query
    biased cross-attention takes the plain route); outputs finite."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers import wan, wan_animate, wan_lynx, wan_scail

    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(cuda)

    small = dict(num_attention_heads=2, num_layers=3, ffn_dim=256, text_dim=64)
    t = torch.tensor([500.0], device=cuda)
    animate = materialize_random(lambda: wan_animate.WanAnimateTransformer3DModel(wan_animate.WanAnimateConfig(
        **dict(small, num_layers=4), image_dim=32, motion_encoder_size=32, motion_style_dim=16, motion_dim=4, motion_encoder_dim=16,
        face_encoder_hidden_dim=8, face_encoder_num_heads=2, inject_face_latents_blocks=2)), cuda, seed=0)
    lynx = materialize_random(lambda: wan_lynx.WanLynxTransformer3DModel(wan_lynx.WanLynxConfig(
        **small, ip_cross_attention_dim=32, ip_registers=4)), cuda, seed=1)
    resampler = materialize_random(lambda: wan_lynx.LynxResampler(wan_lynx.LynxResampler.Config(
        dim=64, depth=2, dim_head=64, heads=2, num_queries=8, embedding_dim=16, output_dim=32)), cuda, seed=2)
    scail = materialize_random(lambda: wan_scail.SCAILModel(wan_scail.WanScailConfig(
        dim=256, num_heads=2, num_layers=3, ffn_dim=256, text_dim=64, text_len=16, image_dim=32)), cuda, seed=3)
    holo = materialize_random(lambda: wan.WanHolocineTransformer3DModel(wan.WanConfig(**small)), cuda, seed=4)
    with torch.inference_mode():
        before = flash_attention.launches
        out = animate(rand(1, 36, 3, 16, 16), t, rand(1, 20, 64), rand(1, 5, 32), rand(1, 16, 2, 16, 16),
                      rand(1, 3, 5, 32, 32).clamp(-1, 1))
        assert flash_attention.launches == before + 3 * 4 + 2  # adapters after blocks 0 and 2
        assert out.shape == (1, 16, 3, 16, 16) and torch.isfinite(out.float()).all()
        before = flash_attention.launches
        ip = resampler(rand(1, 1, 16))
        out = lynx(rand(1, 16, 3, 16, 16), t, rand(1, 20, 64), ip_tokens=ip, ip_scale=1.0)
        assert flash_attention.launches == before + 2 + 3 * 3
        assert ip.dtype == torch.float32 and out.shape == (1, 16, 3, 16, 16) and torch.isfinite(out.float()).all()
        before = flash_attention.launches
        out = scail(rand(1, 16, 2, 16, 16), t, rand(1, 20, 64), rand(1, 16, 2, 8, 8), rand(1, 16, 1, 16, 16),
                    rand(1, 5, 32))
        assert flash_attention.launches == before + 3 * 3
        assert out.shape == (1, 16, 2, 16, 16) and torch.isfinite(out.float()).all()
        before = flash_attention.launches
        bias = torch.where(torch.rand(1, 1, 192, 20, generator=g) > 0.5, 0.0, -1e4).to(cuda)
        out = holo(rand(1, 16, 3, 16, 16), t, rand(1, 20, 64), ctx_bias=bias,
                   shot_ids=torch.tensor([[0] * 128 + [1] * 64], device=cuda))
        assert flash_attention.launches == before + 3
        assert out.shape == (1, 16, 3, 16, 16) and torch.isfinite(out.float()).all()


# The other image families' joint lengths at their default sizes: (name, s, h, masked key spans, key bias):
# Chroma's [txt | img] with 90 of 512 text keys kept (its key-padding route), Ovis' 4352, FIBO's 6144 with its
# single blocks' mask and its dual blocks' 0/1 additive key bias, HiDream's 4480 at 20 heads, HunyuanImage's
# [img | byT5 | mllm] at 28 heads and its refiner's 1000 rows
IMAGE_FAMILY_SHAPES = [
    ("chroma_joint_s4608_h24_text_padding", 4608, 24, [(90, 512)], "mask"),
    ("ovis_joint_s4352_h24", 4352, 24, [], "mask"),
    ("fibo_single_s6144_h24_text_padding", 6144, 24, [(120, 2048)], "mask"),
    ("fibo_dual_s6144_h24_zero_one_bias", 6144, 24, [(120, 2048)], "zero_one"),
    ("hidream_joint_s4480_h20", 4480, 20, [], "mask"),
    ("hunyuanimage_joint_s5224_h28_text_bias", 5224, 28, [(4102, 4224), (4284, 5224)], "mask"),
    ("hunyuanimage_refiner_s1000_h28_bias", 1000, 28, [(60, 1000)], "mask"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", IMAGE_FAMILY_SHAPES, ids=[c[0] for c in IMAGE_FAMILY_SHAPES])
def test_flash_kernel_image_family_shapes(shape, cuda):
    """The kernel at the new DiTs' shapes against its plain version: a
    [1, S] key bias that masks spans inside the sequence (-1e30), or FIBO's
    dual blocks' 0/1 bias (a kept key's logit raised by 1, as the JAX module
    passes its boolean mask)."""
    _, s, h, spans, kind = shape
    g = torch.Generator(cuda).manual_seed(7)
    q, k, v = (torch.randn(1, s, h, 128, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    keep = torch.ones(1, s, dtype=torch.bool, device=cuda)
    for start, stop in spans:
        keep[:, start:stop] = False
    bias = _prep_bias(None, keep) if kind == "mask" else keep.float()
    before = flash_attention.launches
    out = flash_attention(q, k, v, bias=bias if spans else None)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.isfinite(out.float()).all()
    assert_agrees(out, flash_attention_reference(q, k, v, bias=bias if spans else None))


@pytest.mark.cuda
def test_image_family_dits_launch_the_kernel_per_attention(cuda):
    """Small Chroma, Ovis, FIBO, HiDream and HunyuanImage DiTs (head dim 128)
    in bf16 on the card: one launch a block (HunyuanImage's refiner blocks
    one each too), Chroma's and FIBO's text padding and HunyuanImage's
    text bias on the kernel; outputs finite."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers import chroma, fibo, hidream, hunyuanimage, ovis

    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(cuda)

    small = dict(num_layers=2, num_single_layers=3, num_attention_heads=2, attention_head_dim=128)
    mask = (torch.arange(16) < 10)[None].to(cuda)
    models = {
        "chroma": materialize_random(lambda: chroma.ChromaTransformer2DModel(chroma.ChromaConfig(
            **small, joint_attention_dim=64, approximator_hidden_dim=64, approximator_layers=1)), cuda, seed=0),
        "ovis": materialize_random(lambda: ovis.OvisImageTransformer2DModel(ovis.OvisConfig(
            **small, joint_attention_dim=64)), cuda, seed=1),
        "fibo": materialize_random(lambda: fibo.BriaFiboTransformer2DModel(fibo.FiboConfig(
            **small, joint_attention_dim=64, text_encoder_dim=32)), cuda, seed=2),
        "hidream": materialize_random(lambda: hidream.HiDreamImageTransformer2DModel(hidream.HiDreamConfig(
            **small, in_channels=4, out_channels=4, text_emb_dim=32, caption_dim=64,
            llama_layers=tuple(range(5)))), cuda, seed=3),
        "hunyuanimage": materialize_random(lambda: hunyuanimage.HunyuanImageTransformer2DModel(
            hunyuanimage.HunyuanImageConfig(**small, in_channels=4, out_channels=4, text_embed_dim=64,
                                            text_embed_2_dim=32)), cuda, seed=4),
    }
    t01, t1000 = torch.tensor([0.6], device=cuda), torch.tensor([600.0], device=cuda)
    calls = {
        "chroma": (lambda m: m(rand(1, 64, 64), rand(1, 16, 64), t01, attention_mask=mask, grid_hw=(8, 8)), 5),
        "ovis": (lambda m: m(rand(1, 64, 64), rand(1, 16, 64), t01, grid_hw=(8, 8)), 5),
        "fibo": (lambda m: m(rand(1, 64, 64), rand(1, 16, 64), [rand(1, 16, 32) for _ in range(5)], t1000,
                             text_mask=mask, grid_hw=(8, 8)), 5),
        "hidream": (lambda m: m(rand(1, 4, 16, 16), t1000, rand(1, 16, 64), [rand(1, 8, 64) for _ in range(5)],
                                rand(1, 32)), 5),
        "hunyuanimage": (lambda m: m(rand(1, 4, 8, 8), t1000, rand(1, 16, 64), mask, rand(1, 8, 32),
                                     torch.ones(1, 8, device=cuda)), 5 + 2),
    }
    with torch.inference_mode():
        for name, (call, launches) in calls.items():
            before = flash_attention.launches
            out = call(models[name])
            assert flash_attention.launches == before + launches, name
            assert torch.isfinite(out.float()).all(), name


# The video families on the ported VAEs and encoders: (name, sq, sk, h, d, kept keys or None):
# Kandinsky 5's 28 heads of 64 (self over 7680, its text blocks over the 256-row Qwen sequence, the cross);
# LongCat's noise queries against every key of an i2v clip (6240 against 7800: Sq ≠ Sk), its KV-cache
# launch (the new frames against context + new keys), its UMT5 cross-attention with the text mask;
# Cosmos' self-attention over 17,600 tokens at 16 heads, on row subsets below
VIDEO_REST_SHAPES = [
    ("kandinsky5_self_s7680_h28_d64", 7680, 7680, 28, 64, None),
    ("kandinsky5_text_s256_h28_d64", 256, 256, 28, 64, None),
    ("kandinsky5_cross_sq7680_sk256_h28_d64", 7680, 256, 28, 64, None),
    ("longcat_noise_vs_all_sq6240_sk7800_h32", 6240, 7800, 32, 128, None),
    ("longcat_kv_cache_sq7800_sk14040_h32", 7800, 14040, 32, 128, None),
    ("longcat_cross_sq7800_sk512_h32_text_mask", 7800, 512, 32, 128, 120),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", VIDEO_REST_SHAPES, ids=[c[0] for c in VIDEO_REST_SHAPES])
def test_flash_kernel_video_rest_shapes(shape, cuda):
    """The kernel at the new launches against its plain version over the
    first, last (ragged) and an interior 128-row tile, every key."""
    _, sq, sk, h, d, kept = shape
    g = torch.Generator(cuda).manual_seed(9)
    q = torch.randn(1, sq, h, d, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(1, sk, h, d, generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    bias = None if kept is None else _prep_bias(None, (torch.arange(sk, device=cuda) < kept)[None])
    before = flash_attention.launches
    out = flash_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.isfinite(out.float()).all()
    tail = sq % 128 or 128
    for rows in (slice(0, 128), slice(sq - tail, sq), slice(sq // 256 * 128 - 64, sq // 256 * 128 + 64)):
        assert_agrees(out[:, rows], flash_attention_reference(q[:, rows], k, v, bias=bias))


@pytest.mark.cuda
def test_video_rest_dits_launch_the_kernel_per_attention(cuda):
    """Small LongCat, Cosmos and Kandinsky 5 DiTs in bf16 on the card: LongCat
    two launches a block (three with a conditioning frame: the frame alone,
    then the noise against every key), one a block for the KV cache's pass and
    two for a forward against it; Cosmos self and cross a block; Kandinsky 5
    (head dim 64) one a text block and two a visual block; outputs finite and
    the cached forward within bf16 of the joint one over the new frames."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers import cosmos, kandinsky5, longcat

    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(cuda)

    lc = materialize_random(lambda: longcat.LongCatVideoTransformer3DModel(longcat.LongCatConfig(
        hidden_size=256, depth=2, num_heads=2, caption_channels=64, adaln_tembed_dim=32)), cuda, seed=0)
    cs = materialize_random(lambda: cosmos.CosmosTransformer3DModel(cosmos.CosmosConfig(
        in_channels=17, num_attention_heads=2, num_layers=2, text_embed_dim=64, adaln_lora_dim=16,
        extra_pos_embed_type=None)), cuda, seed=1)
    k5 = materialize_random(lambda: kandinsky5.Kandinsky5Transformer3DModel(kandinsky5.Kandinsky5Config(
        in_text_dim=64, in_text_dim2=32, time_dim=32, model_dim=128, ff_dim=256, num_text_blocks=1,
        num_visual_blocks=2)), cuda, seed=2)
    text, mask = rand(1, 16, 64), (torch.arange(16, device=cuda) < 10)[None]
    x, t = rand(1, 16, 3, 16, 16), torch.tensor([[0.0, 600.0, 600.0]], device=cuda)
    with torch.inference_mode():
        for kw, launches in (({}, 2 * 2), ({"num_cond_latents": 1}, 3 * 2)):
            before = flash_attention.launches
            out = lc(x, t, text, mask, **kw)
            assert flash_attention.launches == before + launches, kw
            assert torch.isfinite(out).all()
        joint = out[:, :, 1:]
        before = flash_attention.launches
        _, cache = lc(x[:, :, :1], torch.zeros(1, 1, device=cuda), torch.zeros(1, 16, 64, device=cuda),
                      return_kv=True, skip_crs_attn=True)
        cached = lc(x[:, :, 1:], t[:, 1:], text, mask, kv_cache=cache, num_ctx_latents=1)
        assert flash_attention.launches == before + 2 + 2 * 2
        rel = torch.linalg.vector_norm(cached - joint) / torch.linalg.vector_norm(joint)
        assert rel.item() <= 2e-2

        before = flash_attention.launches
        cond = torch.zeros(1, 1, 3, 16, 16, device=cuda)
        out = cs(rand(1, 16, 3, 16, 16), torch.tensor([[1e-4, 0.5, 0.5]], device=cuda), text, condition_mask=cond)
        assert flash_attention.launches == before + 2 * 2
        assert torch.isfinite(out).all()

        before = flash_attention.launches
        out = k5(rand(1, 16, 3, 16, 16), torch.tensor([600.0], device=cuda), text, rand(1, 32))
        assert flash_attention.launches == before + 1 + 2 * 2
        assert torch.isfinite(out).all()


# HunyuanImage 3.0 at 1024², 32 heads of 128: the image span's 4096 queries against every key (128 text ids,
# the timestep token, the image: Sq ≠ Sk) and the causal prefix over the 129 tokens before the span;
# CogVideoX 5B's joint launch at 48 heads of 64 over [226 text | 17 frames at 480x720]
HY3_COG_SHAPES = [
    ("hy3_image_vs_all_sq4096_sk4225_h32", 4096, 4225, 32, 128, False),
    ("hy3_causal_prefix_s129_h32", 129, 129, 32, 128, True),
    ("cogvideox_joint_s6976_h48_d64", 6976, 6976, 48, 64, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HY3_COG_SHAPES, ids=[c[0] for c in HY3_COG_SHAPES])
def test_flash_kernel_hy3_cogvideox_shapes(shape, cuda):
    """The kernel at the new launches against its plain version over the
    first, last (ragged) and an interior 128-row tile (every row below 256),
    every key."""
    _, sq, sk, h, d, causal = shape
    g = torch.Generator(cuda).manual_seed(10)
    q = torch.randn(1, sq, h, d, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(1, sk, h, d, generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    before = flash_attention.launches
    out = flash_attention(q, k, v, is_causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.isfinite(out.float()).all()
    if sq < 256:
        assert_agrees(out, flash_attention_reference(q, k, v, is_causal=causal))
        return
    tail = sq % 128 or 128
    for rows in (slice(0, 128), slice(sq - tail, sq), slice(sq // 256 * 128 - 64, sq // 256 * 128 + 64)):
        assert_agrees(out[:, rows], flash_attention_reference(q[:, rows], k, v))


@pytest.mark.cuda
def test_hy3_and_cogvideox_backbones_launch_the_kernel_per_attention(cuda):
    """Small HunyuanImage 3 and CogVideoX backbones in bf16 on the card:
    HunyuanImage 3 two launches a layer (the causal prefix, the image span
    against every key; with trailing tokens a causal launch over the whole
    sequence and the span against the keys up to its end), no mask handed
    to ``attention``, within bf16 of the same weights on the masked plain
    route; CogVideoX one joint launch a block; outputs finite."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers import cogvideox, hunyuanimage3
    from apex_studio_tpu_torch.ops.attention import naive_attention

    hy = materialize_random(lambda: hunyuanimage3.HunyuanImage3ForCausalMM(hunyuanimage3.HunyuanImage3Config(
        vocab_size=64, hidden_size=256, intermediate_size=256, moe_intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, use_qk_norm=True, num_experts=4, moe_topk=2,
        use_mixed_mlp_moe=True, img_in_channels=4, img_out_channels=4, patch_embed_hidden_dim=32)), cuda, seed=3)
    cog = materialize_random(lambda: cogvideox.CogVideoXTransformer3DModel(cogvideox.CogVideoXConfig(
        num_attention_heads=2, attention_head_dim=64, num_layers=2, text_embed_dim=64, time_embed_dim=32)),
        cuda, seed=4)
    g = torch.Generator().manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(cuda)

    ids = torch.randint(0, 64, (1, 80), generator=g).to(cuda)
    img, t = rand(1, 4, 8, 8), torch.tensor([600.0], device=cuda)
    with torch.inference_mode():
        for n_ids, img_begin in ((8, None), (80, 4)):  # 64 image tokens; 12 trailing the span
            before = flash_attention.launches
            out = hy(img, t, ids[:, :n_ids], img_begin=img_begin)
            assert flash_attention.launches == before + 2 * 2
            assert torch.isfinite(out).all()
        rng = torch.Generator().manual_seed(2)
        q, k, v = (torch.randn(1, 300, 2, 128, generator=rng).to(cuda, torch.bfloat16) for _ in range(3))
        mask = torch.ones(300, 300, dtype=torch.bool, device=cuda).tril()
        mask[40:240, 40:240] = True
        assert_agrees(hunyuanimage3.span_attention(q, k, v, 40, 200),
                      naive_attention(q, k, v, bias=_prep_bias(None, mask[None, None])))
        before = flash_attention.launches
        out = cog(rand(1, 16, 3, 8, 8), t, rand(1, 12, 64))
        assert flash_attention.launches == before + 2
        assert torch.isfinite(out).all()


# Mochi-1 at 480x848 over 85 frames: the joint launch over [23,850 video | 256 text] at 24 heads of 128 and the
# pooler's one query over [mean | 256 text rows] at 8 heads of 512 with its padded keys at -1e9; LTX-Video at
# 480x832 over 145 frames: the self-attention over 7410 tokens and the cross launch against 128 text rows (the
# padded ones at -10000) at 32 heads of 64
MOCHI_LTX_SHAPES = [
    ("mochi_joint_s24106_h24", 24106, 24106, 24, 128, None),
    ("mochi_pooler_sq1_sk257_h8", 1, 257, 8, 512, -1e9),
    ("ltx_self_s7410_h32_d64", 7410, 7410, 32, 64, None),
    ("ltx_cross_sq7410_sk128_h32_d64", 7410, 128, 32, 64, -10000.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MOCHI_LTX_SHAPES, ids=[c[0] for c in MOCHI_LTX_SHAPES])
def test_flash_kernel_mochi_ltx_shapes(shape, cuda):
    """The kernel at the new launches against its plain version over the
    first, last (ragged) and an interior 128-row tile (every row below 256),
    every key; the biased launches with a 24-token prompt's keys kept."""
    _, sq, sk, h, d, masked = shape
    g = torch.Generator(cuda).manual_seed(11)
    q = torch.randn(1, sq, h, d, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(1, sk, h, d, generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    bias = None
    if masked is not None:
        bias = torch.zeros(1, sk, device=cuda)
        bias[:, sk - 232 if sk == 257 else 24:] = masked
    before = flash_attention.launches
    # head dim 512 (the pooler's one query) is past the kernel's widths: its scores go in as the key bias
    out = (one_query_wide_head_attention if d > 128 else flash_attention)(q, k, v, bias=bias)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.isfinite(out.float()).all()
    if sq < 256:
        assert_agrees(out, flash_attention_reference(q, k, v, bias=bias))
        return
    tail = sq % 128 or 128
    for rows in (slice(0, 128), slice(sq - tail, sq), slice(sq // 256 * 128 - 64, sq // 256 * 128 + 64)):
        assert_agrees(out[:, rows], flash_attention_reference(q[:, rows], k, v, bias=bias))


@pytest.mark.cuda
def test_mochi_and_ltx_dits_launch_the_kernel_per_attention(cuda):
    """Small Mochi and LTX DiTs in bf16 on the card: Mochi one joint launch a
    block and the pooler's; LTX a self and a cross launch a block, one fewer
    with a block's self-attention skipped (STG); outputs finite."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers import ltx, mochi

    mo = materialize_random(lambda: mochi.MochiTransformer3DModel(mochi.MochiConfig(
        num_attention_heads=2, attention_head_dim=64, num_layers=2, text_embed_dim=128, pooled_projection_dim=32,
        time_embed_dim=32)), cuda, seed=5)
    lt = materialize_random(lambda: ltx.LTXVideoTransformer3D(ltx.LTXVideoConfig(
        in_channels=16, out_channels=16, num_layers=2, num_attention_heads=2, attention_head_dim=64,
        caption_channels=64)), cuda, seed=6)
    g = torch.Generator().manual_seed(3)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(cuda)

    mask = torch.zeros(1, 12, device=cuda)
    mask[:, :5] = 1.0
    coords = rand(1, 3, 48).abs()
    with torch.inference_mode():
        before = flash_attention.launches
        out = mo(rand(1, 12, 3, 8, 8), torch.tensor([600.0], device=cuda), rand(1, 12, 128),
                 encoder_attention_mask=mask)
        assert flash_attention.launches == before + 2 + 1
        assert torch.isfinite(out).all()
        for skips, launches in (((), 4), ((1,), 3)):
            before = flash_attention.launches
            out = lt(rand(2, 48, 16), rand(2, 12, 64), rand(2, 48).abs(), encoder_attention_mask=mask.expand(2, -1),
                     video_coords=coords.expand(2, -1, -1), skip_blocks=skips)
            assert flash_attention.launches == before + launches
            assert torch.isfinite(out).all()


# LTX-2 at its default request (512x768 over 121 frames) with CFG (B = 2): the video self-attention over 6144
# tokens at 32 heads of 128, the text cross launches over the 1024 connector rows (the unconditional row of a
# request without a negative prompt fully masked, the conditional row kept whole), the AV cross launches at the
# audio geometry (32 heads of 64) both ways, the audio self-attention over 121 tokens, one connector stack's
# self-attention (30 heads of 128)
LTX2_SHAPES = [
    ("ltx2_video_self_s6144_h32_d128", 6144, 6144, 32, 128, False),
    ("ltx2_video_text_sq6144_sk1024_h32_d128", 6144, 1024, 32, 128, True),
    ("ltx2_a2v_sq6144_sk121_h32_d64", 6144, 121, 32, 64, False),
    ("ltx2_v2a_sq121_sk6144_h32_d64", 121, 6144, 32, 64, False),
    ("ltx2_audio_self_s121_h32_d64", 121, 121, 32, 64, False),
    ("ltx2_audio_text_sq121_sk1024_h32_d64", 121, 1024, 32, 64, True),
    ("ltx2_connector_s1024_h30_d128", 1024, 1024, 30, 128, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LTX2_SHAPES, ids=[c[0] for c in LTX2_SHAPES])
def test_flash_kernel_ltx2_shapes(shape, cuda):
    """The kernel at LTX-2's launches against its plain version over the
    first, last (ragged) and an interior 128-row tile (every row below 256),
    every key; the text launches with batch row 0 fully masked, whose every
    query row is the mean of V."""
    _, sq, sk, h, d, masked = shape
    b = 1 if h == 30 else 2
    g = torch.Generator(cuda).manual_seed(12)
    q = torch.randn(b, sq, h, d, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(b, sk, h, d, generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    bias = None
    if masked:
        bias = torch.zeros(b, sk, device=cuda)
        bias[0] = -1e30
    before = flash_attention.launches
    out = flash_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.isfinite(out.float()).all()
    if masked:
        assert_agrees(out[:1], v[:1].float().mean(1, keepdim=True).expand(1, sq, h, d))
    tail = sq % 128 or 128
    subsets = ((slice(0, sq),) if sq < 256 else
               (slice(0, 128), slice(sq - tail, sq), slice(sq // 256 * 128 - 64, sq // 256 * 128 + 64)))
    for rows in subsets:
        assert_agrees(out[:, rows], flash_attention_reference(q[:, rows], k, v, bias=bias))


@pytest.mark.cuda
def test_ltx2_dit_and_connectors_launch_the_kernel_per_attention(cuda):
    """A small LTX-2 DiT in bf16 on the card: six launches a block (video and
    audio self, their text cross, a2v and v2a), two fewer in a block whose
    self-attention STG skips, four a block in the isolated-modality pass;
    the connectors one launch a layer and stack; outputs finite."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models import ltx2_connectors
    from apex_studio_tpu_torch.models.transformers import ltx2

    tf = materialize_random(lambda: ltx2.LTX2VideoTransformer3D(ltx2.LTX2Config(
        in_channels=16, out_channels=16, num_attention_heads=2, attention_head_dim=64, cross_attention_dim=128,
        audio_in_channels=16, audio_out_channels=16, audio_num_attention_heads=2, audio_attention_head_dim=32,
        audio_cross_attention_dim=64, num_layers=2, caption_channels=64)), cuda, seed=7)
    conn = materialize_random(lambda: ltx2_connectors.LTX2TextConnectors(ltx2_connectors.LTX2ConnectorsConfig(
        caption_channels=64, text_proj_in_factor=3, video_connector_num_attention_heads=2,
        video_connector_attention_head_dim=32, audio_connector_num_attention_heads=2,
        audio_connector_attention_head_dim=32, video_connector_num_learnable_registers=8,
        audio_connector_num_learnable_registers=8)), cuda, seed=8)
    g = torch.Generator().manual_seed(4)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(cuda)

    mask = torch.zeros(2, 16, device=cuda)
    mask[1, :5] = 1.0
    with torch.inference_mode():
        before = flash_attention.launches
        ctx_v, ctx_a = conn(rand(1, 16, 192).bfloat16(), mask[1:].bool())
        assert flash_attention.launches == before + 4
        assert torch.isfinite(ctx_v.float()).all() and torch.isfinite(ctx_a.float()).all()
        for kw, launches in (({}, 12), ({"skip_video_self_attn_blocks": (1,), "skip_audio_self_attn_blocks": (1,)}, 10),
                             ({"skip_av_cross_attn": True}, 8)):
            before = flash_attention.launches
            v, a = tf(rand(2, 48, 16), rand(2, 5, 16), rand(2, 48).abs(), rand(2, 16, 64), video_shape=(3, 4, 4),
                      fps=25.0, ctx_mask=mask, **kw)
            assert flash_attention.launches == before + launches
            assert torch.isfinite(v).all() and torch.isfinite(a).all()


# MAGI-1's block-causal self-attention at 480x832 (chunks of 6 latent frames of 30 x 52 tokens: 9360 rows, not a
# multiple of the kernel's 128-row tile), 24 heads of 128, as one unmasked launch a chunk
MAGI_CHUNK = 6 * 30 * 52


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [3, 1])
def test_magi_block_causal_launches_are_the_masked_attention(chunks, cuda):
    """``block_causal_attention``: one launch a chunk, chunk i's queries
    against the first (i + 1)·L keys; rows at every chunk's first and last
    tile and across each chunk edge against the plain attention under the
    explicit block-causal [S, S] mask over every key."""
    from apex_studio_tpu_torch.models.transformers.magi import block_causal_attention
    from apex_studio_tpu_torch.ops.attention import naive_attention

    s = MAGI_CHUNK * chunks
    g = torch.Generator(cuda).manual_seed(13)
    q, k, v = (torch.randn(1, s, 24, 128, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    before = flash_attention.launches
    out = block_causal_attention(q, k, v, chunks)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + chunks
    assert torch.isfinite(out.float()).all()
    chunk_of = torch.arange(s, device=cuda) // MAGI_CHUNK
    for i in range(chunks):
        a, b = i * MAGI_CHUNK, (i + 1) * MAGI_CHUNK
        for rows in (slice(a, a + 128), slice(b - 128, b), slice(max(a - 64, 0), a + 64)):
            bias = torch.where(chunk_of[rows, None] >= chunk_of[None, :], 0.0, -1e30)[None, None]
            assert_agrees(out[:, rows], naive_attention(q[:, rows], k, v, bias=bias))


@pytest.mark.cuda
def test_magi_and_flashvsr_launch_the_kernel_per_attention(cuda):
    """Small bf16 MAGI-1 and FlashVSR DiTs and a MAGI-1 VAE on the card: the
    Magi DiT R + 1 launches a layer block-causal over R chunks (R self, one
    cross over B·R rows), 2 with one chunk or ``block_causal`` off; FlashVSR 2
    a block and chunk, the cache trimmed; the VAE one f32 launch a block
    through bf16 tiles; outputs finite."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers import flashvsr, magi
    from apex_studio_tpu_torch.models.vaes import magi_vae

    dit = materialize_random(lambda: magi.MagiTransformer3DModel(magi.MagiConfig(
        num_layers=2, num_attention_heads=4, attention_head_dim=64, ffn_dim=256, num_query_groups=2, in_channels=8,
        out_channels=8, caption_channels=64, caption_max_length=8, half_channel_vae=True)), cuda, seed=9)
    fv = materialize_random(lambda: flashvsr.FlashVSRTransformer3DModel(flashvsr.FlashVSRConfig(
        dim=256, ffn_dim=512, text_dim=64, num_heads=2, num_layers=2, lq4x_proj_out_dim=256, lq_hidden_dim1=32,
        lq_hidden_dim2=48)), cuda, seed=10)
    vae = materialize_random(lambda: magi_vae.AutoencoderKLMagi(magi_vae.MagiVAEConfig(
        video_size=32, video_length=8, z_chans=4, embed_dim=128, depth=2, num_heads=2)), cuda, seed=11)
    g = torch.Generator().manual_seed(5)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(cuda)

    with torch.inference_mode():
        for r, block_causal, launches in ((3, True, 2 * 4), (1, True, 2 * 2), (3, False, 2 * 2)):
            before = flash_attention.launches
            out = dit(rand(1, 4, 2 * r, 16, 18), rand(1, r).abs(), rand(1, r, 10, 64),
                      torch.ones(1, r, 10, dtype=torch.bool, device=cuda), block_causal=block_causal)
            assert flash_attention.launches == before + launches
            assert torch.isfinite(out).all()
        t, t_mod = fv.time_embed(1000.0)
        ctx_kv = fv.context_kv(rand(1, 12, 64).bfloat16())
        caches = None
        for f, start in ((6, 0), (2, 6), (2, 8)):
            cos, sin = fv.rope_for_chunk(f, 4, 4, start)
            before = flash_attention.launches
            pred, caches = fv(rand(1, 16, f, 8, 8), t, t_mod, cos, sin, ctx_kv, caches=caches)
            assert flash_attention.launches == before + 2 * 2
            assert torch.isfinite(pred.float()).all() and caches[0][0].shape[1] == 3 * 2 * 16
        before = flash_attention.launches
        z = vae.encode(rand(1, 3, 8, 48, 40))
        video = vae.decode(z)
        assert flash_attention.launches == before + 2 * 2
        assert z.dtype == video.dtype == torch.float32 and torch.isfinite(video).all()
