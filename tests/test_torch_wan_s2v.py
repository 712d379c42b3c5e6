"""The port's Wan S2V DiT against the JAX package's, on the CPU in f32, the
weights carried from the JAX module (built with seeded numpy values,
``jax_build``; the causal convs' ``kernel_w`` [k, in, out] → [out, in, k])
and the JAX forwards jitted. The toy widths are those of
tests/test_engine_wan_s2v.py: 2 heads of 12, 2 blocks, the audio injector
after block 0, 3 wav2vec2 states of 16, 2 audio tokens a frame.

Tolerance: max|Δ| ≤ 1e-4·max|ref| (the port's usual f32 limit).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.models.transformers.wan_s2v import FramePackMotioner as JaxMotioner
from apex_studio_tpu.models.transformers.wan_s2v import WanS2VConfig as JaxConfig
from apex_studio_tpu.models.transformers.wan_s2v import WanS2VTransformer3DModel as JaxS2V
from apex_studio_tpu_torch.models.transformers.wan_s2v import FramePackMotioner, WanS2VConfig, WanS2VTransformer3DModel
from tests.torch_port_helpers import assert_close, assert_published_round_trip, jax_build, port_from_jax

TINY = dict(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=12, text_dim=24, freq_dim=32,
            ffn_dim=48, num_layers=2, audio_inject_layers=(0,), audio_dim=16, num_wav2vec_layers=3, pose_dim=4,
            num_audio_token=2)
MOTION_FRAMES = 9  # pixel frames prepended to the audio; their latent frames are dropped after the encoder


def normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def s2v_pair(**overrides):
    kw = {**TINY, **overrides}
    jm = jax_build(lambda: JaxS2V(JaxConfig(**kw), dtype=jnp.float32, param_dtype=jnp.float32, rngs=nnx.Rngs(0)))
    return jm, port_from_jax(lambda: WanS2VTransformer3DModel(WanS2VConfig(**kw), dtype=torch.float32), jm)


def inputs(t_lat=3, t_mot=2, hw=8):
    # the causal stack quarters time: (9 + T_a) audio columns give t_mot + t_lat frames
    t_a = 4 * (t_mot + t_lat) - MOTION_FRAMES
    return dict(x=normal(1, 4, t_lat, hw, hw, seed=1), t=np.array([500.0], np.float32),
                text=normal(1, 5, 24, seed=2), motion_latents=normal(1, 4, t_mot, hw, hw, seed=3),
                audio_embeds=normal(1, 3, 16, t_a, seed=4), image_latents=normal(1, 4, 1, hw, hw, seed=5),
                pose_latents=normal(1, 4, t_lat, hw, hw, seed=6))


CASES = {
    "motion": dict(),
    "drop_motion": dict(drop_motion_frames=True),
    "no_pose": dict(pose=False),
    "framepack": dict(cfg=dict(enable_framepack=True), t_mot=19),
    "framepack_short_history": dict(cfg=dict(enable_framepack=True), t_mot=4),
    "adain_off": dict(cfg=dict(enable_adain=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    spec = CASES[case]
    jm, pm = s2v_pair(**spec.get("cfg", {}))
    inp = inputs(t_mot=spec.get("t_mot", 2))
    if not spec.get("pose", True):
        inp["pose_latents"] = None
    drop = spec.get("drop_motion_frames", False)
    mf = (MOTION_FRAMES, spec.get("t_mot", 2))
    names = list(inp)

    def jax_fwd(m, *args):
        return m(*args[:6], pose_latents=args[6], motion_frames=mf, drop_motion_frames=drop)

    ref = np.asarray(nnx.jit(jax_fwd)(jm, *(None if v is None else jnp.asarray(v) for v in inp.values())))
    with torch.inference_mode():
        out = pm(*(None if inp[n] is None else torch.from_numpy(inp[n]) for n in names[:6]),
                 pose_latents=None if inp["pose_latents"] is None else torch.from_numpy(inp["pose_latents"]),
                 motion_frames=mf, drop_motion_frames=drop)
    assert tuple(out.shape) == ref.shape == (1, 4, 3, 8, 8)
    assert_close(out, ref)


def test_audio_reaches_the_output():
    """The injector carries the audio: zeroed features change the output."""
    _, pm = s2v_pair()
    inp = {k: torch.from_numpy(v) for k, v in inputs().items()}
    mf = (MOTION_FRAMES, 2)
    with torch.inference_mode():
        a = pm(**inp, motion_frames=mf)
        b = pm(**{**inp, "audio_embeds": inp["audio_embeds"] * 0.0}, motion_frames=mf)
    assert (a - b).abs().max() > 1e-3


def test_framepack_crops_a_grid_the_patch_does_not_divide():
    """At 12 x 12 latent pixels the 4x bucket's 8 x 8 patch does not divide
    the grid: the JAX motioner's reshape fails there, the port's crops to 8 x 8
    (a strided conv's footprint), and its 4x tokens equal the JAX motioner's
    over the cropped history; the 1x and 2x buckets (2 and 4 divide 12) equal
    the JAX motioner's over the whole grid."""
    cfg = {**TINY, "enable_framepack": True}
    jm = jax_build(lambda: JaxMotioner(JaxConfig(**cfg), dtype=jnp.float32, param_dtype=jnp.float32,
                                       rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: FramePackMotioner(WanS2VConfig(**cfg), dtype=torch.float32), jm)
    motion = normal(1, 4, 19, 12, 12, seed=7)
    tokens_of = nnx.jit(lambda m, x: m(x)[0])
    with pytest.raises(TypeError):
        tokens_of(jm, jnp.asarray(motion))
    with torch.inference_mode():
        tokens, grids = pm(torch.from_numpy(motion))
    ref_crop = tokens_of(jm, jnp.asarray(motion[..., :8, :8]))
    n1, n2 = 6 * 6, 3 * 3
    assert tokens.shape == (1, n1 + n2 + 4 * 1 * 1, 24)
    assert [len(g[1]) * len(g[2]) * len(g[0]) for g in grids] == [n1, n2, 4]
    assert_close(tokens[:, n1 + n2:], np.asarray(ref_crop)[:, -4:])
    # the 1x and 2x buckets over the whole 12 x 12 grid: the JAX patch of each
    ref = nnx.jit(lambda m, x: jnp.concatenate([m.proj(m._patch(x[:, :, -1:], 1, 2, 2)),
                                                m.proj_2x(m._patch(x[:, :, -3:-1], 2, 4, 4))], axis=1))
    assert_close(tokens[:, :n1 + n2], np.asarray(ref(jm, jnp.asarray(motion))))


def test_published_names_round_trip():
    """The ``wan_s2v`` converter: FramePack, the pose embedder and the
    injectors' AdaIN included."""
    cfg = {**TINY, "enable_framepack": True}
    jm, _ = s2v_pair(enable_framepack=True)
    assert_published_round_trip(
        "wan_s2v", lambda: WanS2VTransformer3DModel(WanS2VConfig(**cfg), dtype=torch.float32), jm)
