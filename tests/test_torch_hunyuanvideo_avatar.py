"""The port's HunyuanVideo Avatar DiT against the JAX package's, on the CPU in
f32, the weights carried from the JAX module (seeded numpy values,
``jax_build``: the perceiver adapters' ``to_out`` is not zero, so the audio
reaches the output) and the JAX forwards jitted, at the toy widths of
tests/test_engine_hyv_avatar.py (2 heads of 24, 2 + 1 blocks, the adapter
after dual block 1): zero and non-zero audio windows, a face mask over one
frame and over every frame, and the motion / fps / pooled conditions present
and absent. Also the perceiver adapter and the audio projection alone.

Tolerance: max|Δ| ≤ 1e-4·max|ref| (the port's usual f32 limit).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.models.transformers import hunyuanvideo_avatar as jax_av
from apex_studio_tpu_torch.models.transformers import hunyuanvideo_avatar as av
from tests.test_engine_hyv_avatar import AVATAR_CFG
from tests.torch_port_helpers import assert_close, assert_published_round_trip, jax_build, port_from_jax


def normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(lambda: jax_av.HunyuanAvatarVideoModel(jax_av.HunyuanAvatarConfig.from_dict(AVATAR_CFG),
                                                          dtype=jnp.float32, param_dtype=jnp.float32,
                                                          rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: av.HunyuanAvatarVideoModel(av.HunyuanAvatarConfig.from_dict(AVATAR_CFG),
                                                          dtype=torch.float32), jm)
    return jm, pm


def run_both(pair, **kw):
    jm, pm = pair
    names = sorted(kw)
    fn = nnx.jit(lambda m, *a: m(**dict(zip(names, a))))
    ref = np.asarray(fn(jm, *(None if kw[n] is None else jnp.asarray(kw[n]) for n in names)))
    with torch.inference_mode():
        out = pm(**{n: None if kw[n] is None else torch.from_numpy(kw[n]) for n in names})
    return out, ref


FACE = np.zeros((1, 1, 1, 8, 8), np.float32)
FACE[..., 2:6, 1:7] = 1.0
CASES = {
    "zero_audio": dict(audio=np.zeros((1, 9, 4, 2, 6), np.float32)),
    "audio": dict(audio=normal(1, 9, 4, 2, 6, seed=9)),
    "audio_face_mask_one_frame": dict(audio=normal(1, 9, 4, 2, 6, seed=9), face_mask=FACE),
    "audio_face_mask_every_frame": dict(audio=normal(1, 9, 4, 2, 6, seed=9),
                                        face_mask=(normal(1, 1, 3, 8, 8, seed=10) > 0).astype(np.float32)),
    "no_motion_fps_pooled": dict(audio=normal(1, 9, 4, 2, 6, seed=9), motion_exp=None, motion_pose=None, fps=None,
                                 pooled=None, text_mask=None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(pair, case):
    mask = np.ones((1, 5), np.float32)
    mask[:, 3:] = 0.0
    kw = dict(x=normal(1, 4, 3, 8, 8, seed=1), t=np.array([500.0], np.float32), text=normal(1, 5, 32, seed=2),
              text_mask=mask, pooled=normal(1, 24, seed=3), guidance=np.array([6000.0], np.float32),
              ref_latents=normal(1, 4, 3, 8, 8, seed=4), face_mask=None,
              motion_exp=np.full((1, 4), 30.0, np.float32), motion_pose=np.full((1, 4), 25.0, np.float32),
              fps=np.array([25.0], np.float32))
    kw.update(CASES[case])
    out, ref = run_both(pair, **kw)
    assert tuple(out.shape) == ref.shape == (1, 4, 3, 8, 8)
    assert_close(out, ref)


def test_audio_moves_the_face_region_only(pair):
    """Under a face mask over part of the frame, the audio changes the
    output: non-zero windows against zero windows."""
    kw = dict(x=normal(1, 4, 3, 8, 8, seed=1), t=np.array([500.0], np.float32), text=normal(1, 5, 32, seed=2),
              ref_latents=normal(1, 4, 3, 8, 8, seed=4), face_mask=FACE)
    _, pm = pair
    with torch.inference_mode():
        args = {k: torch.from_numpy(v) for k, v in kw.items()}
        a = pm(**args, audio=torch.zeros(1, 9, 4, 2, 6))
        b = pm(**args, audio=torch.from_numpy(normal(1, 9, 4, 2, 6, seed=9)))
    assert (a - b).abs().max() > 1e-4


def test_perceiver_and_audio_projection_match_jax():
    cfg = jax_av.HunyuanAvatarConfig.from_dict(AVATAR_CFG)
    jp = jax_build(lambda: jax_av.PerceiverAttentionCA(48, 16, dtype=jnp.float32, rngs=nnx.Rngs(0)))
    pp = port_from_jax(lambda: av.PerceiverAttentionCA(48, 16, dtype=torch.float32), jp)
    x, lat = normal(3, 16, 48, seed=5), normal(3, 20, 48, seed=6)
    with torch.inference_mode():
        assert_close(pp(torch.from_numpy(x), torch.from_numpy(lat)),
                     np.asarray(nnx.jit(lambda m, a, b: m(a, b))(jp, jnp.asarray(x), jnp.asarray(lat))))
    ja = jax_build(lambda: jax_av.AudioProjNet2(cfg, dtype=jnp.float32, rngs=nnx.Rngs(0)))
    pa = port_from_jax(lambda: av.AudioProjNet2(av.HunyuanAvatarConfig.from_dict(AVATAR_CFG), dtype=torch.float32),
                       ja)
    audio = normal(1, 9, 4, 2, 6, seed=7)
    with torch.inference_mode():
        assert_close(pa(torch.from_numpy(audio)), np.asarray(nnx.jit(lambda m, a: m(a))(ja, jnp.asarray(audio))))


@pytest.mark.parametrize("n_in,n_out", [(3, 3), (1, 9), (8, 4), (33, 9), (7, 3)])
def test_nearest_index_is_jax_image_resize(n_in, n_out):
    import jax

    src = np.arange(n_in, dtype=np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(src), (n_out,), method="nearest"))
    np.testing.assert_array_equal(src[av.nearest_index(n_in, n_out)], ref)


def test_published_names_round_trip(pair):
    """The ``hunyuanvideo_avatar`` converter: the reference embedders, the
    motion / fps embeddings, the audio projection and the perceiver adapters
    included."""
    assert_published_round_trip(
        "hunyuanvideo_avatar",
        lambda: av.HunyuanAvatarVideoModel(av.HunyuanAvatarConfig.from_dict(AVATAR_CFG), dtype=torch.float32),
        pair[0])
