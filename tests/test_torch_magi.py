"""The port's MAGI-1 modules (the chunk scheduler, the DiT, its block-causal
attention, the ViT VAE, the two converters) against the JAX package, on the
CPU in f32.

The schedule bit-equal to JAX's on the host grid (12 and 64 steps, the three
warps), the chunk-wise step within f32 rounding; the DiT within 1e-4 of
max|ref| against JAX's masked XLA route with three chunks and a clean
context chunk (with and without a padded caption mask, the caption dropped
and kept, a RoPE time offset), with one chunk and with ``block_causal``
off; the chunk-split attention at chunks of 75 rows (not a multiple of the
kernel's 128-row tile) within 1e-5 of the plain attention under the explicit
[S, S] mask, one launch a chunk; the VAE's encode (mean and sample) and
decode within 1e-4 with its position embedding at its own grid, resized up
and resized down; both converters through a safetensors file that
``loaders/export.py`` writes, loaded by both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from apex_studio_tpu.loaders.converters import convert_keys as jax_convert_keys
from apex_studio_tpu.loaders.state_mapping import apply_state_dict as jax_apply_state_dict
from apex_studio_tpu.models.transformers import magi as jax_magi
from apex_studio_tpu.models.vaes import magi_vae as jax_vae
from apex_studio_tpu.schedulers import magi as jax_sched
from apex_studio_tpu_torch.engine.base import materialize_random
from apex_studio_tpu_torch.loaders.converters import convert_keys
from apex_studio_tpu_torch.loaders.export import published_state_dict
from apex_studio_tpu_torch.loaders.safetensors_io import load_safetensors, save_safetensors
from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict
from apex_studio_tpu_torch.models.transformers import magi as port_magi
from apex_studio_tpu_torch.models.vaes import magi_vae as port_vae
from apex_studio_tpu_torch.ops.attention import naive_attention
from apex_studio_tpu_torch.schedulers import magi as port_sched
from tests.torch_port_helpers import assert_close, jax_build, jax_params, port_from_jax

# GQA (4 heads over 2 groups), the manifest's half-channel VAE latents, a
# width the TP8 interleave divides
DIT = dict(num_layers=2, num_attention_heads=4, attention_head_dim=16, ffn_dim=48, num_query_groups=2, in_channels=8,
           out_channels=8, patch_size=2, t_patch_size=1, caption_channels=16, caption_max_length=8,
           cond_hidden_ratio=0.25, half_channel_vae=True)
VAE = dict(video_size=32, video_length=8, patch_size=8, patch_length=4, z_chans=4, embed_dim=16, depth=2, num_heads=2)


@pytest.mark.parametrize("n", [12, 64, 4])
@pytest.mark.parametrize("warp", ["sd3", "square", "piecewise"])
def test_schedule_bit_equal_to_jax(n, warp):
    want = jax_sched.MagiScheduler(num_inference_steps=n, scheduler_type=warp)
    got = port_sched.MagiScheduler(num_inference_steps=n, scheduler_type=warp)
    np.testing.assert_array_equal(got.timesteps, want.timesteps)
    for sched in (want, got):
        sched.set_scheduler_params(chunk_width=2, denoise_step_per_stage=max(1, n // 4))
    for start, end, idx in ((0, 1, 0), (0, 3, 1), (1, 4, 0)):
        np.testing.assert_array_equal(got.chunk_timesteps(start, end, idx, has_clean_t=True),
                                      want.chunk_timesteps(start, end, idx, has_clean_t=True))


def test_shortcut_ladder_modes_match_jax():
    for mode in ("16,16,8", "8,16,16"):
        np.testing.assert_array_equal(port_sched.MagiScheduler(12, shortcut_mode=mode).timesteps,
                                      jax_sched.MagiScheduler(12, shortcut_mode=mode).timesteps)


def test_chunkwise_step_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 3, 6, 4, 4)).astype(np.float32)
    v = rng.normal(size=x.shape).astype(np.float32)
    scheds = [port_sched.MagiScheduler(8), jax_sched.MagiScheduler(8)]
    for s in scheds:
        s.set_scheduler_params(chunk_width=2, denoise_step_per_stage=2)
    got = scheds[0].step(torch.from_numpy(x), torch.from_numpy(v), 0, 3, 1)
    want = np.asarray(scheds[1].step(jnp.asarray(x), jnp.asarray(v), 0, 3, 1))
    assert_close(got, want, 1e-6)


@pytest.fixture(scope="module")
def dit_pair():
    cfg = jax_magi.MagiConfig.from_dict(DIT)
    jm = jax_build(lambda: jax_magi.MagiTransformer3DModel(cfg, dtype=jnp.float32, param_dtype=jnp.float32,
                                                           rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: port_magi.MagiTransformer3DModel(port_magi.MagiConfig.from_dict(DIT),
                                                                dtype=torch.float32), jm)
    return jm, pm


def dit_case(r, padded, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, 4, 2 * r, 8, 10)).astype(np.float32)  # chunks of 2 latent frames, 4 x 5 tokens
    t = np.asarray([[0.9999, 0.31, 0.07][-r:]], np.float32)  # three chunks: the first a clean context chunk
    y = rng.normal(size=(1, r, 6, 16)).astype(np.float32)
    mask = np.ones((1, r, 6), bool)
    if padded:
        mask[..., 4:] = False
    return x, t, y, mask


# (name, chunks, padded caption mask, caption dropout, block causal, RoPE time offset)
DIT_CASES = [("three_chunks_context_padded", 3, True, False, True, 0),
             ("three_chunks_dropout_offset", 3, False, True, True, 1),
             ("three_chunks_dense", 3, True, False, False, 0),
             ("one_chunk", 1, True, True, True, 0)]


@pytest.fixture(scope="module")
def dit_outputs(dit_pair):
    """Every case's JAX output from one jitted program (the masked XLA route)."""
    jm, _ = dit_pair
    graphdef, state = nnx.split(jm)
    inputs = [dit_case(r, padded, seed) for seed, (_, r, padded, *_) in enumerate(DIT_CASES)]

    def run(s, *arrays):
        m = nnx.merge(graphdef, s)
        outs = []
        for (_, _, _, drop, bc, off), i in zip(DIT_CASES, range(0, len(arrays), 4)):
            x, t, y, mask = arrays[i:i + 4]
            outs.append(m(x, t, y, mask, caption_dropout=drop, t_chunk_offset=off, block_causal=bc))
        return outs

    flat = [jnp.asarray(a) for case in inputs for a in case]
    return inputs, [np.asarray(o) for o in jax.jit(run)(state, *flat)]


@pytest.mark.parametrize("index", range(len(DIT_CASES)), ids=[c[0] for c in DIT_CASES])
def test_dit_matches_jax(dit_pair, dit_outputs, index):
    _, pm = dit_pair
    (x, t, y, mask), want = dit_outputs[0][index], dit_outputs[1][index]
    _, r, _, drop, bc, off = DIT_CASES[index]
    got = pm(*map(torch.from_numpy, (x, t, y, mask)), caption_dropout=drop, t_chunk_offset=off, block_causal=bc)
    assert tuple(got.shape) == want.shape == (1, 4, 2 * r, 8, 10)
    assert_close(got, want, 1e-4)


def test_block_causal_dit_keeps_early_chunks_from_later_ones(dit_pair):
    """Changing the last chunk's latents leaves the earlier chunks' output
    unchanged; with ``block_causal`` off it moves them."""
    _, pm = dit_pair
    x, t, y, mask = map(torch.from_numpy, dit_case(3, False, 7))
    x2 = x.clone()
    x2[:, :, 4:] += 1.0
    for bc in (True, False):
        a, b = (pm(v, t, y, mask, block_causal=bc) for v in (x, x2))
        moved = float((a[:, :, :4] - b[:, :, :4]).abs().max())
        assert (moved == 0.0) if bc else (moved > 1e-3)


@pytest.mark.parametrize("chunks", [3, 1])
def test_chunk_split_attention_is_the_masked_attention(monkeypatch, chunks):
    """Chunks of 75 rows (3 frames of 5 x 5 tokens: not a multiple of 128):
    one unmasked launch a chunk, chunk i's queries against the first
    (i + 1)·75 keys, equal to the plain attention under the explicit
    block-causal [S, S] mask of the JAX module."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 75 * chunks, 4, 32, generator=g) for _ in range(3))
    calls = []
    plain = port_magi.attention
    monkeypatch.setattr(port_magi, "attention", lambda q_, k_, v_, **kw: (
        calls.append((q_.shape[1], k_.shape[1], kw)) or plain(q_, k_, v_, **kw)))
    got = port_magi.block_causal_attention(q, k, v, chunks)
    assert calls == [(75, 75 * (i + 1), {}) for i in range(chunks)]
    mask = np.array(jax_magi.MagiTransformer3DModel.chunk_causal_mask(chunks, 75))
    want = naive_attention(q, k, v, bias=torch.from_numpy(mask)[None, None])
    assert_close(got, want.numpy(), 1e-5)


@pytest.fixture(scope="module")
def vae_pair():
    jm = jax_build(lambda: jax_vae.AutoencoderKLMagi(jax_vae.MagiVAEConfig.from_dict(VAE), rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: port_vae.AutoencoderKLMagi(port_vae.MagiVAEConfig.from_dict(VAE)), jm)
    return jm, pm


# (name, frames, height, width): the position embedding's own grid (2, 4, 4), resized up and resized down
VAE_GRIDS = [("own_grid", 8, 32, 32), ("resized_up", 12, 48, 40), ("resized_down", 4, 16, 24)]


@pytest.fixture(scope="module")
def vae_outputs(vae_pair):
    """JAX's encodes (the mean; a sample with noise) and decodes at each grid,
    one jitted program."""
    jm, _ = vae_pair
    rng = np.random.default_rng(1)
    inputs = []
    for _, f, h, w in VAE_GRIDS:
        video = rng.uniform(-1, 1, size=(1, 3, f, h, w)).astype(np.float32)
        lat = (1, 4, f // 4, h // 8, w // 8)
        inputs += [video, rng.normal(size=lat).astype(np.float32), rng.normal(size=lat).astype(np.float32)]
    graphdef, state = nnx.split(jm)

    def run(s, *arrays):
        m = nnx.merge(graphdef, s)
        outs = []
        for i in range(0, len(arrays), 3):
            video, noise, z = arrays[i:i + 3]
            outs += [m.encode(video), m.encode(video, sample=True, noise=noise), m.decode(z)]
        return outs

    outs = [np.asarray(o) for o in jax.jit(run)(state, *map(jnp.asarray, inputs))]
    return inputs, outs


@pytest.mark.parametrize("index", range(len(VAE_GRIDS)), ids=[g[0] for g in VAE_GRIDS])
def test_vae_matches_jax(vae_pair, vae_outputs, index):
    _, pm = vae_pair
    video, noise, z = map(torch.from_numpy, vae_outputs[0][3 * index:3 * index + 3])
    mean, sample, decoded = vae_outputs[1][3 * index:3 * index + 3]
    _, f, h, w = VAE_GRIDS[index]
    assert mean.shape == (1, 4, f // 4, h // 8, w // 8) and decoded.shape == (1, 3, f, h, w)
    assert_close(pm.encode(video), mean, 1e-4)
    assert_close(pm.encode(video, sample=True, noise=noise), sample, 1e-4)
    assert_close(pm.decode(z), decoded, 1e-4)
    assert pm.spatial_compression_ratio == 8 and pm.temporal_compression_ratio == 4


@pytest.mark.parametrize("dst", [(3, 6, 5), (1, 2, 3)], ids=["up", "down"])
def test_position_embedding_resize_matches_jax(dst):
    pe = np.random.default_rng(2).normal(size=(1, 2 * 4 * 4, 16)).astype(np.float32)
    want = np.asarray(jax_vae._resize_pos_embed(jnp.asarray(pe), (2, 4, 4), dst))
    assert_close(port_vae._resize_pos_embed(torch.from_numpy(pe), (2, 4, 4), dst), want, 1e-6)


def file_round_trip(family, build, jax_model, path, prepare=None):
    """A port module's state written by ``loaders/export.py`` as a safetensors
    file; the port loads it back bit-equal through its converter, and the JAX
    package, loading the same file through its converter, holds the same
    values (carried back into the port, bit-equal)."""
    src = materialize_random(build, torch.device("cpu"), seed=3)
    if prepare is not None:
        prepare(src)
    published = published_state_dict(family, src.state_dict())
    assert set(published) != set(src.state_dict())
    save_safetensors(path, published)
    tensors = load_safetensors(path)
    dst = materialize_random(build, torch.device("cpu"), seed=4)
    apply_state_dict(dst, convert_keys(family, tensors), strict=True)
    jax_apply_state_dict(jax_model, jax_convert_keys(family, {k: v.numpy() for k, v in tensors.items()}),
                         strict=True)
    back = port_from_jax(build, jax_model)
    for name, value in src.state_dict().items():
        assert torch.equal(dst.state_dict()[name], value), name
        assert torch.equal(back.state_dict()[name], value), name


def test_dit_converter_through_an_exported_file(dit_pair, tmp_path):
    """The zero-centred gammas are published less 1 and loaded plus 1; near 1
    (a trained model's), both steps are exact."""
    def near_one(model):
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, port_magi.ZeroCenteredLN):
                    mod.norm.weight.copy_(1.0 + 0.05 * torch.randn(mod.norm.weight.shape, generator=g))

    jm = nnx.clone(dit_pair[0])
    file_round_trip("magi", lambda: port_magi.MagiTransformer3DModel(port_magi.MagiConfig.from_dict(DIT),
                                                                     dtype=torch.float32),
                    jm, tmp_path / "magi.safetensors", near_one)
    published = published_state_dict("magi", port_from_jax(
        lambda: port_magi.MagiTransformer3DModel(port_magi.MagiConfig.from_dict(DIT), dtype=torch.float32),
        dit_pair[0]).state_dict())
    assert published["patch_embedding.weight"].shape == (64, 8, 1, 2, 2)
    assert {"blocks.0.attn2.to_kv.weight", "blocks.1.attn1.norm_q.weight", "norm_out.weight",
            "caption_embedding.null_caption_embedding", "rope.bands"} <= set(published)


def test_vae_converter_through_an_exported_file(vae_pair, tmp_path):
    file_round_trip("magi_vae", lambda: port_vae.AutoencoderKLMagi(port_vae.MagiVAEConfig.from_dict(VAE)),
                    nnx.clone(vae_pair[0]), tmp_path / "magi_vae.safetensors")
    published = published_state_dict("magi_vae", vae_pair[1].state_dict())
    assert published["encoder.patch_embed.proj.weight"].shape == (16, 3, 4, 8, 8)
    assert {"decoder.pos_embed", "encoder.cls_token", "decoder.blocks.1.mlp.fc2.weight",
            "decoder.last_layer.weight"} <= set(published)


def test_converted_names_match_the_jax_parameters(dit_pair, vae_pair):
    for family, (jm, pm) in (("magi", dit_pair), ("magi_vae", vae_pair)):
        published = {k: v.numpy() for k, v in published_state_dict(family, pm.state_dict()).items()}
        assert set(jax_convert_keys(family, published)) == set(jax_params(jm))
