"""The port's last Wan modules against the JAX package's, on the CPU in f32:
the ReCamMaster, HoloCine, Apex-FramePack, Animate, Lynx and SCAIL DiTs and
Lynx's resampler at the toy widths of the JAX engine tests
(tests/test_engine_wan_{recam,framepack,animate,lynx,scail}.py), weights
built with seeded numpy values (``jax_build``) and carried with
``loaders/from_jax.py``, the JAX forwards jitted; the camera and trajectory
helpers; the FramePack planner; HoloCine's bias through the plain route in
row chunks; the converters' published names round trip.

Tolerance: max|Δ| ≤ 1e-4·max|ref| (the port's usual f32 limit); the camera
embeddings, the track processing and the FramePack plans exactly;
``patch_motion`` within 1e-5·max|ref| (an ``exp`` over a float32 grid).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.models import camera as jax_camera
from apex_studio_tpu.models import trajectory as jax_trajectory
from apex_studio_tpu.models.transformers import wan as jax_wan
from apex_studio_tpu.models.transformers import wan_animate as jax_animate
from apex_studio_tpu.models.transformers import wan_framepack as jax_framepack
from apex_studio_tpu.models.transformers import wan_lynx as jax_lynx
from apex_studio_tpu.models.transformers import wan_scail as jax_scail
from apex_studio_tpu_torch.models import camera, trajectory
from apex_studio_tpu_torch.models.transformers import wan, wan_animate, wan_framepack, wan_lynx, wan_scail
from tests.torch_port_helpers import (assert_close, assert_published_round_trip, jax_build, jax_params, jitted,
                                      port_from_jax)

WAN_TINY = dict(num_attention_heads=2, attention_head_dim=24, in_channels=4, out_channels=4, text_dim=32,
                freq_dim=32, ffn_dim=64, num_layers=2)
ANIMATE_TINY = dict(in_channels=10, out_channels=4, num_attention_heads=2, attention_head_dim=12, text_dim=32,
                    freq_dim=32, ffn_dim=48, num_layers=2, image_dim=16, motion_encoder_size=32,
                    motion_style_dim=16, motion_dim=4, motion_encoder_dim=16, face_encoder_hidden_dim=8,
                    face_encoder_num_heads=2, inject_face_latents_blocks=2)
LYNX_TINY = dict(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=12, text_dim=32,
                 freq_dim=32, ffn_dim=48, num_layers=2, ip_cross_attention_dim=16, ip_registers=2)
RESAMPLER_TINY = dict(dim=16, depth=2, dim_head=8, heads=2, num_queries=3, embedding_dim=8, output_dim=16, ff_mult=2)
SCAIL_TINY = dict(in_dim=6, dim=24, ffn_dim=48, freq_dim=32, text_dim=32, text_len=8, out_dim=4, num_heads=2,
                  num_layers=2, image_dim=16, pose_rope_shift=(0, 64, 64))
FRAMEPACK_TINY = dict(WAN_TINY, num_indices=3, framepack_compressors=((1, (1, 2, 2)), (2, (2, 4, 4)), (4, (4, 8, 8))),
                      context_buckets=(("F_1", 1, 1), ("F_2", 2, 2), ("F_4", 16, 4)))


def normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def with_blur(jm):
    """``jax_build`` builds abstractly, and the JAX motion encoder keeps its
    blur kernels as plain arrays outside its parameters: give them back."""
    for _, mod in nnx.iter_graph(jm):
        if isinstance(mod, jax_animate.MotionConv) and mod.blur:
            k = np.outer([1.0, 3.0, 3.0, 1.0], [1.0, 3.0, 3.0, 1.0])
            mod.blur_kernel = jnp.asarray(k / k.sum(), jnp.float32)
    return jm


def pair(jax_cls, jax_cfg, port_cls, port_cfg):
    jm = with_blur(jax_build(lambda: jax_cls(jax_cfg, dtype=jnp.float32, param_dtype=jnp.float32,
                                             rngs=nnx.Rngs(0))))
    return jm, port_from_jax(lambda: port_cls(port_cfg, dtype=torch.float32), jm)


def t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


# -- camera and trajectory helpers ------------------------------------------------------


@pytest.mark.parametrize("spec", ["orbit", "zoom_in", "zoom_out", "pan_left", "pan_right", "tilt_up", "3",
                                  "array12", "array16", "json"])
def test_camera_embedding_equals_jax(spec, tmp_path):
    rng = np.random.default_rng(4)
    if spec == "array12":
        spec = rng.normal(size=(9, 12)).astype(np.float32)
    elif spec == "array16":
        m = np.tile(np.eye(4), (9, 1, 1))
        m[:, :3, :] += 0.1 * rng.normal(size=(9, 3, 4))
        spec = m
    elif spec == "json":
        # the published trajectories' "[a b c d] [...]" strings
        frames = {f"frame{i}": {"cam01": " ".join("[" + " ".join(map(str, row)) + "]"
                                                  for row in (np.eye(4) + 0.05 * i).tolist())} for i in range(9)}
        path = tmp_path / "cams.json"
        path.write_text(json.dumps(frames))
        spec = str(path)
    want = jax_camera.WanRecamCameraEmbedder(temporal_scale=2)(spec, 9)
    got = camera.WanRecamCameraEmbedder(temporal_scale=2)(spec, 9)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want)


def _raw_tracks(frames=121, n=6, seed=5):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 8 * 64, size=(frames, n, 2))
    vis = (rng.uniform(size=(frames, n, 1)) > 0.2).astype(np.float32) * 8
    return np.concatenate([xy, vis], axis=-1).astype(np.float32)  # (T, N, 3) pixel tracks × quant_multi


@pytest.mark.parametrize("frames", [121, 9])
def test_track_processing_equals_jax(frames):
    arr = _raw_tracks(frames)
    want = jax_trajectory.prepare_tracks(arr, 64, 48)
    got = trajectory.prepare_tracks(arr, 64, 48)
    assert got.shape == want.shape and np.array_equal(got, want)
    assert np.array_equal(trajectory.prepare_tracks(got, 64, 48), got)  # processed tracks pass through


def test_patch_motion_close_to_jax():
    tracks = trajectory.prepare_tracks(_raw_tracks(121), 64, 48)  # 81 rows → 21 latent frames
    vid = normal(4 + 16, 21, 6, 8, seed=6)
    want = np.asarray(jax_trajectory.patch_motion(jnp.asarray(tracks), jnp.asarray(vid)))
    got = trajectory.patch_motion(t(tracks), t(vid))
    assert_close(got, want, rel=1e-5)
    assert not np.allclose(want, vid)  # the tracks were painted


def test_bilinear_sample_equals_jax():
    feat = normal(5, 6, 8, seed=7)
    xy = np.random.default_rng(8).uniform(-1.2, 1.2, size=(20, 2)).astype(np.float32)
    want = np.asarray(jax_trajectory._bilinear_sample(jnp.asarray(feat), jnp.asarray(xy)))
    assert_close(trajectory._bilinear_sample(t(feat), t(xy)), want, rel=1e-6)


# -- FramePack's planner ----------------------------------------------------------------


@pytest.mark.parametrize("lat_f", [2, 5, 9, 17, 40])
def test_framepack_schedule_equals_jax(lat_f):
    buckets = jax_framepack.WanFramepackConfig().context_buckets
    js, ps = jax_framepack.FramepackSchedule(9, buckets), wan_framepack.FramepackSchedule(9, buckets)
    assert ps.num_sections(lat_f) == js.num_sections(lat_f)
    denoised = np.zeros(lat_f, bool)
    while not denoised.all():
        want, got = js.get_inference_inputs(lat_f, denoised), ps.get_inference_inputs(lat_f, denoised.copy())
        for w, g in zip(want, got):
            assert (w is None and g is None) or np.array_equal(w, g)
        if got[1] is not None:
            for (wi, wf), (gi, gf) in zip(js.split_future(want[1]), ps.split_future(got[1]), strict=True):
                assert wf == gf and np.array_equal(wi, gi)
        denoised[got[2]] = True


# -- the DiTs ----------------------------------------------------------------------------


def test_holocine_bias_and_shot_ids_match_jax():
    """HoloCine's DiT with shot ids and a per-query bias, the bias in row
    chunks smaller than the sequence (``BIAS_ROWS``)."""
    jm, pm = pair(jax_wan.WanHolocineTransformer3DModel, jax_wan.WanConfig(**WAN_TINY),
                  wan.WanHolocineTransformer3DModel, wan.WanConfig(**WAN_TINY))
    x, ctx = normal(1, 4, 3, 8, 8, seed=1), normal(1, 6, 32, seed=2)
    shot = np.repeat(np.array([0, 1, 1]), 16)[None]
    bias = np.where(np.random.default_rng(3).uniform(size=(1, 1, 48, 6)) > 0.5, 0.0, -1e4).astype(np.float32)
    tt = np.array([500.0], np.float32)
    ref = nnx.jit(lambda m, *a: m(a[0], a[1], a[2], ctx_bias=a[3], shot_ids=a[4]))(
        jm, *map(jnp.asarray, (x, tt, ctx, bias, shot)))
    saved = wan.BIAS_ROWS
    wan.BIAS_ROWS = 20
    try:
        with torch.inference_mode():
            out = pm(t(x), t(tt), t(ctx), ctx_bias=t(bias), shot_ids=t(shot))
            plain = pm(t(x), t(tt), t(ctx))
    finally:
        wan.BIAS_ROWS = saved
    assert_close(out, np.asarray(ref))
    assert (out - plain).abs().max() > 1e-3


def test_recam_matches_jax():
    jm, pm = pair(jax_wan.WanRecamTransformer3DModel, jax_wan.WanConfig(**WAN_TINY),
                  wan.WanRecamTransformer3DModel, wan.WanConfig(**WAN_TINY))
    x, ctx, cam = normal(1, 4, 4, 8, 8, seed=1), normal(1, 6, 32, seed=2), normal(1, 2, 12, seed=3)
    tt = np.array([500.0], np.float32)
    ref = nnx.jit(lambda m, *a: m(a[0], a[1], a[2], cam_emb=a[3]))(jm, *map(jnp.asarray, (x, tt, ctx, cam)))
    with torch.inference_mode():
        out = pm(t(x), t(tt), t(ctx), cam_emb=t(cam))
        other = pm(t(x), t(tt), t(ctx), cam_emb=t(cam + 1.0))
    assert_close(out, np.asarray(ref))
    assert (out - other).abs().max() > 1e-4


@pytest.mark.parametrize("case", ["section_only", "past_and_future"])
def test_framepack_matches_jax(case):
    jcfg = jax_framepack.WanFramepackConfig.from_dict(FRAMEPACK_TINY)
    pcfg = wan_framepack.WanFramepackConfig.from_dict(FRAMEPACK_TINY)
    jm, pm = pair(jax_framepack.WanApexFramepackTransformer3DModel, jcfg,
                  wan_framepack.WanApexFramepackTransformer3DModel, pcfg)
    x, ctx = normal(1, 4, 3, 8, 8, seed=1), normal(1, 6, 32, seed=2)
    tt = np.array([700.0], np.float32)
    target = np.array([2, 3, 4])
    lc = [] if case == "section_only" else [
        (normal(1, 4, 2, 8, 8, seed=3), np.array([0, 1]), 1), (normal(1, 4, 1, 8, 8, seed=4), np.array([5]), 1),
        (normal(1, 4, 2, 8, 8, seed=5), np.array([6, 7]), 2), (normal(1, 4, 3, 8, 8, seed=6), np.array([8, 9, 10]), 4)]
    ref = jitted(jm, lambda m, x, tt, ctx, *lat: m(x, tt, ctx, indices=target,
                                                   latent_context=[(a, i, f) for a, (_, i, f) in zip(lat, lc)]),
                 x, tt, ctx, *(a for a, _, _ in lc))
    with torch.inference_mode():
        out = pm(t(x), t(tt), t(ctx), latent_context=[(t(a), i, f) for a, i, f in lc], indices=target)
    assert_close(out, np.asarray(ref))
    assert "patch_embedding.weight" not in dict(pm.named_parameters())


@pytest.fixture(scope="module")
def animate_pair():
    return pair(jax_animate.WanAnimateTransformer3DModel, jax_animate.WanAnimateConfig(**ANIMATE_TINY),
                wan_animate.WanAnimateTransformer3DModel, wan_animate.WanAnimateConfig(**ANIMATE_TINY))


@pytest.mark.parametrize("case", ["pose_and_face", "no_face"])
def test_animate_matches_jax(animate_pair, case):
    """Two latent frames after the reference slot: 5 face frames at 32 px
    (4·2 − 3), the motion encoder in chunks smaller than the clip."""
    jm, pm = animate_pair
    x, ctx, clip = normal(1, 10, 3, 8, 8, seed=1), normal(1, 6, 32, seed=2), normal(1, 5, 16, seed=3)
    pose = normal(1, 4, 2, 8, 8, seed=4)
    face = None if case == "no_face" else np.random.default_rng(5).uniform(-1, 1, (1, 3, 5, 32, 32)).astype(
        np.float32)
    tt = np.array([400.0], np.float32)
    ref = nnx.jit(lambda m, *a: m(*a))(jm, *(None if a is None else jnp.asarray(a)
                                            for a in (x, tt, ctx, clip, pose, face)))
    saved = wan_animate.FACE_CHUNK
    wan_animate.FACE_CHUNK = 2
    try:
        with torch.inference_mode():
            out = pm(t(x), t(tt), t(ctx), t(clip), t(pose), t(face))
    finally:
        wan_animate.FACE_CHUNK = saved
    assert tuple(out.shape) == (1, 4, 3, 8, 8)
    assert_close(out, np.asarray(ref))


def test_animate_face_tokens_match_jax(animate_pair):
    jm, pm = animate_pair
    face = np.random.default_rng(6).uniform(-1, 1, (1, 3, 9, 32, 32)).astype(np.float32)

    def jax_tokens(m, f):
        faces = f.transpose(0, 2, 3, 4, 1).reshape(9, 32, 32, 3)
        return m.face_encoder(m.motion_encoder(faces).reshape(1, 9, -1))

    ref = nnx.jit(jax_tokens)(jm, jnp.asarray(face))
    with torch.inference_mode():
        got = pm.face_tokens(t(face))
    assert tuple(got.shape) == (1, 4, 3, 24) and ref.shape == (1, 3, 3, 24)  # 4·3 − 3 frames → 3 + the zero frame
    assert torch.equal(got[:, 0], torch.zeros_like(got[:, 0]))
    assert_close(got[:, 1:], np.asarray(ref))


@pytest.mark.parametrize("variant", ["lynx", "lite"])
def test_lynx_matches_jax(variant):
    cfg = dict(LYNX_TINY, ip_registers=0) if variant == "lite" else LYNX_TINY
    jm, pm = pair(jax_lynx.WanLynxTransformer3DModel, jax_lynx.WanLynxConfig(**cfg),
                  wan_lynx.WanLynxTransformer3DModel, wan_lynx.WanLynxConfig(**cfg))
    x, ctx, ip = normal(1, 4, 2, 8, 8, seed=1), normal(1, 6, 32, seed=2), normal(1, 3, 16, seed=3)
    tt = np.array([300.0], np.float32)
    ref = nnx.jit(lambda m, *a: m(a[0], a[1], a[2], ip_tokens=a[3], ip_scale=0.7))(
        jm, *map(jnp.asarray, (x, tt, ctx, ip)))
    with torch.inference_mode():
        out = pm(t(x), t(tt), t(ctx), ip_tokens=t(ip), ip_scale=0.7)
        off = pm(t(x), t(tt), t(ctx), ip_tokens=t(ip), ip_scale=0.0)
    assert_close(out, np.asarray(ref))
    assert (out - off).abs().max() > 1e-4
    assert (pm.blocks[0].registers is None) == (variant == "lite")


def test_lynx_resampler_matches_jax():
    jm = jax_build(lambda: jax_lynx.LynxResampler(jax_lynx.LynxResampler.Config(**RESAMPLER_TINY), rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: wan_lynx.LynxResampler(wan_lynx.LynxResampler.Config(**RESAMPLER_TINY)), jm)
    emb = normal(1, 2, 8, seed=4)
    ref = nnx.jit(lambda m, e: m(e))(jm, jnp.asarray(emb))
    with torch.inference_mode():
        out = pm(t(emb))
    assert tuple(out.shape) == (1, 3, 16)
    assert_close(out, np.asarray(ref))


def test_scail_matches_jax():
    jm, pm = pair(jax_scail.SCAILModel, jax_scail.WanScailConfig(**SCAIL_TINY),
                  wan_scail.SCAILModel, wan_scail.WanScailConfig(**SCAIL_TINY))
    x, ctx, clip = normal(1, 4, 2, 8, 8, seed=1), normal(1, 5, 32, seed=2), normal(1, 5, 16, seed=3)
    pose, ref_lat = normal(1, 4, 2, 4, 4, seed=4), normal(1, 4, 1, 8, 8, seed=5)
    tt = np.array([600.0], np.float32)
    ref = nnx.jit(lambda m, *a: m(*a, rope_t_shift=1))(jm, *map(jnp.asarray, (x, tt, ctx, pose, ref_lat, clip)))
    with torch.inference_mode():
        out = pm(t(x), t(tt), t(ctx), t(pose), t(ref_lat), t(clip), rope_t_shift=1)
        other = pm(t(x), t(tt), t(ctx), t(pose) + 1.0, t(ref_lat), t(clip), rope_t_shift=1)
    assert_close(out, np.asarray(ref))
    assert (out - other).abs().max() > 1e-4


def test_scail_rope_tables_equal_jax():
    jcfg, pcfg = jax_scail.WanScailConfig(**SCAIL_TINY), wan_scail.WanScailConfig(**SCAIL_TINY)
    jm = nnx.eval_shape(lambda: jax_scail.SCAILModel(jcfg, dtype=jnp.float32, param_dtype=jnp.float32,
                                                     rngs=nnx.Rngs(0)))
    want = jm.rope_tables(3, 4, 6, 2)
    got = wan_scail.SCAILModel.rope_tables(type("M", (), {"cfg": pcfg, "_tables": {}})(), 3, 4, 6, 2)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


# -- published names --------------------------------------------------------------------


@pytest.mark.parametrize("family", ["wan_animate", "wan_lynx", "lynx_resampler"])
def test_published_names_round_trip(family):
    builds = {
        "wan_animate": (lambda: jax_animate.WanAnimateTransformer3DModel(
            jax_animate.WanAnimateConfig(**ANIMATE_TINY), dtype=jnp.float32, param_dtype=jnp.float32,
            rngs=nnx.Rngs(0)),
            lambda: wan_animate.WanAnimateTransformer3DModel(wan_animate.WanAnimateConfig(**ANIMATE_TINY),
                                                             dtype=torch.float32)),
        "wan_lynx": (lambda: jax_lynx.WanLynxTransformer3DModel(
            jax_lynx.WanLynxConfig(**LYNX_TINY), dtype=jnp.float32, param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
            lambda: wan_lynx.WanLynxTransformer3DModel(wan_lynx.WanLynxConfig(**LYNX_TINY), dtype=torch.float32)),
        "lynx_resampler": (lambda: jax_lynx.LynxResampler(jax_lynx.LynxResampler.Config(**RESAMPLER_TINY),
                                                          rngs=nnx.Rngs(0)),
                           lambda: wan_lynx.LynxResampler(wan_lynx.LynxResampler.Config(**RESAMPLER_TINY))),
    }
    jax_fn, port_fn = builds[family]
    assert_published_round_trip(family, port_fn, nnx.eval_shape(jax_fn))


@pytest.mark.parametrize("variant", ["recam", "framepack"])
def test_wan_variant_names_round_trip(variant):
    """ReCam's ``cam_encoder`` and FramePack's packer load through the
    port's ``wan`` converter from the published names (the JAX ``wan`` table
    has neither: ROADMAP Queue 3)."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.loaders.converters import convert_keys
    from apex_studio_tpu_torch.loaders.export import published_state_dict
    from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict

    build = {"recam": lambda: wan.WanRecamTransformer3DModel(wan.WanConfig(**WAN_TINY), dtype=torch.float32),
             "framepack": lambda: wan_framepack.WanApexFramepackTransformer3DModel(
                 wan_framepack.WanFramepackConfig.from_dict(FRAMEPACK_TINY), dtype=torch.float32)}[variant]
    src = materialize_random(build, torch.device("cpu"), seed=3)
    published = published_state_dict("wan", src.state_dict())
    want = {"recam": "blocks.0.cam_encoder.weight", "framepack": "latent_embed_packer.embedders.2.weight"}[variant]
    assert want in published
    if variant == "framepack":
        assert tuple(published[want].shape) == (48, 4, 2, 4, 4)  # the Conv3d weight
    dst = materialize_random(build, torch.device("cpu"), seed=4)
    apply_state_dict(dst, convert_keys("wan", published), strict=True)
    for name, value in src.state_dict().items():
        assert torch.equal(dst.state_dict()[name], value), name


def test_scail_names_round_trip():
    """The ``wan_scail`` converter loads the published names back strictly;
    the JAX table maps every name as the port does but one: its Linear rule
    also renames the image keys' RMS norm ``norm_k_img.weight`` to
    ``.kernel``, which the JAX DiT does not have (ROADMAP Queue 3)."""
    from apex_studio_tpu.loaders.converters import convert_keys as jax_convert_keys

    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.loaders.converters import convert_keys
    from apex_studio_tpu_torch.loaders.export import published_state_dict
    from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict

    def build():
        return wan_scail.SCAILModel(wan_scail.WanScailConfig(**SCAIL_TINY), dtype=torch.float32)

    src = materialize_random(build, torch.device("cpu"), seed=3)
    published = published_state_dict("wan_scail", src.state_dict())
    assert "blocks.0.cross_attn.norm_k_img.weight" in published and "img_emb.proj.4.bias" in published
    dst = materialize_random(build, torch.device("cpu"), seed=4)
    apply_state_dict(dst, convert_keys("wan_scail", published), strict=True)
    for name, value in src.state_dict().items():
        assert torch.equal(dst.state_dict()[name], value), name
    jm = nnx.eval_shape(lambda: jax_scail.SCAILModel(jax_scail.WanScailConfig(**SCAIL_TINY), dtype=jnp.float32,
                                                     param_dtype=jnp.float32, rngs=nnx.Rngs(0)))
    jax_keys, want = set(jax_convert_keys("wan_scail", {k: v.numpy() for k, v in published.items()})), set(
        jax_params(jm))
    assert jax_keys - want == {f"blocks.{i}.norm_k_img.kernel" for i in range(2)}
    assert want - jax_keys == {f"blocks.{i}.norm_k_img.weight" for i in range(2)}


# -- the Wan VAE's chunked encode -----------------------------------------------------


@pytest.mark.parametrize("layout", ["wan21", "wan22_residual"])
def test_chunked_encode_equals_whole(layout):
    """Above ``ENCODE_WHOLE_MAX_PIXELS`` the encoder runs in time chunks with
    its causal frames carried: the same latents as the whole encode (17
    frames, two temporal downsamples; Wan 2.2's patchify and avg-pool
    shortcuts too), and ``encode`` picks the chunks by size alone."""
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.vaes import wan_vae

    extra = dict(patch_size=2, is_residual=True) if layout == "wan22_residual" else {}
    cfg = wan_vae.WanVAEConfig(base_dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1,
                               temperal_downsample=(True, True), **extra)
    vae = materialize_random(lambda: wan_vae.AutoencoderKLWan(cfg, dtype=torch.float32), torch.device("cpu"), seed=5)
    video = torch.from_numpy(np.random.default_rng(9).uniform(-1, 1, (1, 3, 17, 32, 32)).astype(np.float32))
    with torch.inference_mode():
        x = wan_vae.patchify(video, 2) if extra else video
        whole = vae.encoder(x)
        chunked = vae.encode_chunked(x)
        assert tuple(chunked.shape) == tuple(whole.shape) == (1, 8, 5, 32 // cfg.spatial_scale, 32 // cfg.spatial_scale)
        assert_close(chunked, whole.numpy(), rel=1e-5)
        saved = wan_vae.ENCODE_WHOLE_MAX_PIXELS
        wan_vae.ENCODE_WHOLE_MAX_PIXELS = 17 * 32 * 32 - 1
        try:
            calls = []
            vae.encode_chunked, plain = (lambda v: calls.append(v.shape) or plain(v)), vae.encode_chunked
            vae.encode(video)
            wan_vae.ENCODE_WHOLE_MAX_PIXELS = 17 * 32 * 32
            vae.encode(video)
        finally:
            wan_vae.ENCODE_WHOLE_MAX_PIXELS = saved
        assert len(calls) == 1
