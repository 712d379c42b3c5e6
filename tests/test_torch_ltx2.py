"""The port's LTX-2 modules (Gemma-3, the text connectors, the audio-video DiT
and its RoPE, the video and audio VAEs, the vocoder, the latent upsampler)
against the JAX package, on the CPU in f32.

Gemma-3 with a local window shorter than the prompt and a padded row, its
final output and all hidden states, within 1e-4 of max|ref|; the packed
hidden states within 1e-6 and the connectors with padding (with and without
registers) within 1e-4; the host RoPE tables bit-equal to JAX's at the
published widths; the DiT with per-token timesteps and a fully masked text
row, and with the STG and isolated-modality skips over explicit (f32)
coordinates, within 1e-4; the VAEs, the vocoder and the upsampler (every variant, and
``upsample_latents`` with the VAE's statistics) within 1e-5; the seven
converter tables' published names round-trip; both repository manifests
resolve in the port.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

import apex_studio_tpu.models.ltx2_connectors as jax_conn
from apex_studio_tpu.models import ltx2_upsampler as jax_up
from apex_studio_tpu.models import ltx2_vocoder as jax_voc
from apex_studio_tpu.models.text_encoders import gemma3 as jax_gemma
from apex_studio_tpu.models.transformers import ltx2 as jax_dit
from apex_studio_tpu.models.vaes import ltx2_audio_vae as jax_avae
from apex_studio_tpu.models.vaes import ltx2_vae as jax_vae
from apex_studio_tpu_torch.models import ltx2_connectors as port_conn
from apex_studio_tpu_torch.models import ltx2_upsampler as port_up
from apex_studio_tpu_torch.models import ltx2_vocoder as port_voc
from apex_studio_tpu_torch.models.text_encoders import gemma3 as port_gemma
from apex_studio_tpu_torch.models.transformers import ltx2 as port_dit
from apex_studio_tpu_torch.models.vaes import ltx2_audio_vae as port_avae
from apex_studio_tpu_torch.models.vaes import ltx2_vae as port_vae
from tests.test_engine_ltx2 import LTX2_TINY
from tests.torch_port_helpers import assert_close, assert_published_round_trip, jax_build, jitted, port_from_jax

MANIFESTS = [Path(__file__).resolve().parents[1] / "manifests" / "video" / name
             for name in ("ltx2-19b-ti2v.yml", "ltx2-19b-ti2v-distilled.yml")]
TINY = {c["type"]: c["config"] for c in LTX2_TINY["spec"]["components"] if c["type"] != "scheduler"}
GEMMA = {"text_config": dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=3,
                             num_attention_heads=4, num_key_value_heads=2, head_dim=16, sliding_window=3,
                             sliding_window_pattern=2, query_pre_attn_scalar=16, rope_scaling={"factor": 8.0})}
CONNECTORS = dict(caption_channels=16, text_proj_in_factor=3, video_connector_num_attention_heads=2,
                  video_connector_attention_head_dim=8, video_connector_num_layers=2,
                  video_connector_num_learnable_registers=4, audio_connector_num_attention_heads=2,
                  audio_connector_attention_head_dim=8, audio_connector_num_layers=1,
                  audio_connector_num_learnable_registers=4)
VAE = dict(TINY["vae"], latents_mean=[0.1, -0.2, 0.0, 0.3], latents_std=[1.1, 0.9, 1.0, 1.2])
AUDIO_VAE = dict(base_channels=8, ch_mult=[1, 2, 4], num_res_blocks=1, latent_channels=4, mel_bins=16)
# the published vocoder's 15-tap, stride-5 stage beside a 4-tap one
VOCODER = dict(in_channels=8, hidden_channels=16, out_channels=2, upsample_kernel_sizes=[4, 15],
               upsample_factors=[2, 5], resnet_kernel_sizes=[3, 5], resnet_dilations=[[1, 3], [1, 2]])
UPSAMPLERS = {"rational_2x": {}, "rational_1.5x": {"spatial_scale": 1.5},
              "pixel_shuffle_2d": {"dims": 2, "rational_resampler": False},
              "temporal": {"spatial_upsample": False, "temporal_upsample": True},
              "spatiotemporal": {"temporal_upsample": True}}


def pair(jax_cls, port_cls, cfg, **jax_kw):
    jm = jax_build(lambda: jax_cls(jax_cls.config_class.from_dict(cfg), rngs=nnx.Rngs(0), **jax_kw))
    pm = port_from_jax(lambda: port_cls(port_cls.config_class.from_dict(cfg), **(
        {"dtype": torch.float32} if jax_kw else {})), jm)
    return jm, pm


F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)


GEMMA_IDS = np.random.default_rng(0).integers(0, 64, size=(2, 7)).astype(np.int32)
GEMMA_MASK = np.asarray([[1] * 7, [1] * 5 + [0] * 2], np.int32)


@pytest.fixture(scope="module")
def gemma():
    """(JAX model, port model, JAX outputs): the final states and every hidden
    state of one padded batch, from one compiled program."""
    jm, pm = pair(jax_gemma.Gemma3TextEncoder, port_gemma.Gemma3TextEncoder, GEMMA, **F32)
    graphdef, state = nnx.split(jm)
    outs = jax.jit(lambda s, i, k: (nnx.merge(graphdef, s)(i, attention_mask=k),
                                    nnx.merge(graphdef, s)(i, attention_mask=k, output_hidden_states=True)))(
        state, GEMMA_IDS, GEMMA_MASK)
    return jm, pm, {"normed": np.asarray(outs[0]), "hidden_states_all": np.asarray(outs[1])}


@pytest.fixture(scope="module")
def dit():
    return pair(jax_dit.LTX2VideoTransformer3D, port_dit.LTX2VideoTransformer3D, dict(TINY["transformer"],
                num_layers=2), **F32)


@pytest.mark.parametrize("output", ["normed", "hidden_states_all"])
def test_gemma3_matches_jax(gemma, output):
    """Layers 0 and 2 are local with a window of 3 over 7 tokens, layer 1 global."""
    _, pm, outs = gemma
    assert [layer.is_global for layer in pm.layers] == [False, True, False]
    every = output == "hidden_states_all"
    want = outs[output]
    got = pm(torch.from_numpy(GEMMA_IDS).long(), attention_mask=torch.from_numpy(GEMMA_MASK),
             output_hidden_states=every)
    assert tuple(got.shape) == want.shape == ((2, 7, 32, 4) if every else (2, 7, 32))
    assert_close(got, want, 1e-4)


def test_gemma3_config_reads_the_multimodal_nesting():
    cfg = port_gemma.Gemma3Config.from_dict(GEMMA)
    assert (cfg.hidden_size, cfg.rope_scaling_factor, cfg.sliding_window) == (32, 8.0, 3)
    assert cfg == port_gemma.Gemma3Config(**{
        k: getattr(jax_gemma.Gemma3Config.from_dict(GEMMA), k) for k in cfg.__dataclass_fields__})


@pytest.mark.parametrize("registers", [4, None])
def test_connectors_match_jax(registers):
    cfg = dict(CONNECTORS, video_connector_num_learnable_registers=registers,
               audio_connector_num_learnable_registers=registers)
    jm, pm = pair(jax_conn.LTX2TextConnectors, port_conn.LTX2TextConnectors, cfg, **F32)
    rng = np.random.default_rng(1)
    hidden = rng.normal(size=(2, 8, 16, 3)).astype(np.float32)
    mask = np.asarray([[1] * 8, [1] * 3 + [0] * 5], np.int32)
    want_packed = np.asarray(jax.jit(jax_conn.pack_text_embeds)(hidden, mask))
    packed = port_conn.pack_text_embeds(torch.from_numpy(hidden), torch.from_numpy(mask))
    assert_close(packed, want_packed, 1e-6)
    graphdef, state = nnx.split(jm)
    want_v, want_a = jax.jit(lambda s, p, k: nnx.merge(graphdef, s)(p, k))(state, want_packed, mask.astype(bool))
    got_v, got_a = pm(torch.from_numpy(want_packed), torch.from_numpy(mask).bool())
    assert_close(got_v, np.asarray(want_v), 1e-4)
    assert_close(got_a, np.asarray(want_a), 1e-4)


def test_host_rope_tables_equal_jax_at_published_widths():
    """The video (4096 over three axes, a 4-lane pad), audio (2048) and AV
    cross (2048 over time) tables, on a 17-frame 128×192 grid at 25 fps."""
    cfg = jax_dit.LTX2Config()
    jm = nnx.eval_shape(lambda: jax_dit.LTX2VideoTransformer3D(jax_dit.LTX2Config(num_layers=0), **F32))
    with torch.device("meta"):
        pm = port_dit.LTX2VideoTransformer3D(port_dit.LTX2Config(num_layers=0))
    vc, ac = jm.video_coords(3, 4, 6, 25.0), jm.audio_coords(18)
    np.testing.assert_array_equal(pm.video_coords(3, 4, 6, 25.0), vc)
    np.testing.assert_array_equal(pm.audio_coords(18), ac)
    tables = []
    vmax = (cfg.pos_embed_max_pos, cfg.base_height, cfg.base_width)
    for coords, dim, mp in ((vc, cfg.inner_dim, vmax), (ac, cfg.audio_inner_dim, (20,)),
                            (vc[:, :1], cfg.audio_cross_attention_dim, (20,))):
        want = jax_dit.ltx2_rope(coords, dim, cfg.rope_theta, mp)
        got = port_dit.ltx2_rope(coords, dim, cfg.rope_theta, mp)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        tables.append(got)
    cos, sin = tables[0]
    assert bool((cos[..., :4] == 1).all() and (sin[..., :4] == 0).all())


def dit_inputs():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 2 * 4 * 4, 4)).astype(np.float32)
    xa = rng.normal(size=(2, 5, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 6, 12)).astype(np.float32)
    ctx_a = rng.normal(size=(2, 6, 12)).astype(np.float32)
    # the unconditional row of a request without a negative prompt: every key masked
    mask = np.asarray([[0] * 6, [1, 1, 1, 1, 0, 0]], np.float32)
    t = np.where(np.arange(32) < 16, 0.0, 0.7)[None].repeat(2, 0).astype(np.float32)
    return x, xa, t, ctx, ctx_a, mask


DIT_CASES = {"per_token_t": {},
             # keyframe-style coordinates with the STG skips of block 1 and the isolated-modality pass
             "skips_explicit_coords": {"skip_video_self_attn_blocks": (1,), "skip_audio_self_attn_blocks": (1,),
                                       "skip_av_cross_attn": True, "coords": True}}


@pytest.mark.parametrize("case", list(DIT_CASES))
def test_dit_matches_jax(dit, case):
    jm, pm = dit
    kw = dict(DIT_CASES[case])
    x, xa, t, ctx, ctx_a, mask = dit_inputs()
    coords = None
    if kw.pop("coords", False):  # keyframe-style: the time axis of the second frame shifted
        coords = np.array(jm.video_coords(2, 4, 4, 24.0, batch=2), np.float32)
        coords[:, 0, 16:] += 8.0 / 24.0
    graphdef, state = nnx.split(jm)
    want_v, want_a = jax.jit(lambda s, *a: nnx.merge(graphdef, s)(
        a[0], a[1], a[2], a[3], video_shape=(2, 4, 4), fps=24.0, ctx_audio=a[4], ctx_mask=a[5],
        video_coords=a[6] if coords is not None else None, **kw))(state, x, xa, t, ctx, ctx_a, mask, coords)
    got_v, got_a = pm(*map(torch.from_numpy, (x, xa, t, ctx)), video_shape=(2, 4, 4), fps=24.0,
                      ctx_audio=torch.from_numpy(ctx_a), ctx_mask=torch.from_numpy(mask),
                      video_coords=None if coords is None else torch.from_numpy(coords), **kw)
    assert tuple(got_v.shape) == (2, 32, 4) and tuple(got_a.shape) == (2, 5, 4)
    assert_close(got_v, np.asarray(want_v), 1e-4)
    assert_close(got_a, np.asarray(want_a), 1e-4)


@pytest.fixture(scope="module")
def vae():
    return pair(jax_vae.AutoencoderKLLTX2, port_vae.AutoencoderKLLTX2, VAE)


def test_vae_matches_jax(vae):
    jm, pm = vae
    assert (pm.spatial_compression_ratio, pm.temporal_compression_ratio) == (32, 8)
    x = np.random.default_rng(3).uniform(-1, 1, size=(1, 3, 9, 64, 64)).astype(np.float32)
    want_z = jitted(jm, lambda m, a: m.encode(a), x)
    got_z = pm.encode(torch.from_numpy(x))
    assert tuple(got_z.shape) == want_z.shape == (1, 4, 2, 2, 2)
    assert_close(got_z, want_z, 1e-5)
    want = jitted(jm, lambda m, a: m.decode(a), want_z)
    got = pm.decode(torch.from_numpy(want_z))
    assert tuple(got.shape) == want.shape == (1, 3, 9, 64, 64)
    assert_close(got, want, 1e-5)


def test_audio_vae_and_vocoder_match_jax():
    jm, pm = pair(jax_avae.AutoencoderKLLTX2Audio, port_avae.AutoencoderKLLTX2Audio, AUDIO_VAE)
    mel = np.random.default_rng(4).normal(size=(1, 2, 12, 16)).astype(np.float32)
    want_z = jitted(jm, lambda m, a: m.encode(a), mel)
    got_z = pm.encode(torch.from_numpy(mel))
    assert tuple(got_z.shape) == want_z.shape == (1, 4, 3, 4)
    assert_close(got_z, want_z, 1e-5)
    want = jitted(jm, lambda m, a: m.decode(a), want_z)
    got = pm.decode(torch.from_numpy(want_z))
    assert tuple(got.shape) == want.shape == (1, 2, 9, 16)  # 4·T' − 3 frames
    assert_close(got, want, 1e-5)
    tokens = pm.patchify(torch.from_numpy(want_z))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jm.patchify(jnp.asarray(want_z))))
    np.testing.assert_array_equal(pm.unpatchify(tokens, 4, 4).numpy(), want_z)

    jv, pv = pair(jax_voc.LTX2Vocoder, port_voc.LTX2Vocoder, VOCODER)
    mel = np.random.default_rng(5).normal(size=(1, 2, 6, 4)).astype(np.float32)
    want = jitted(jv, lambda m, a: m(a), mel)
    got = pv(torch.from_numpy(mel))
    assert tuple(got.shape) == want.shape == (1, 2, 60)
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("variant", list(UPSAMPLERS))
def test_upsampler_matches_jax(vae, variant):
    cfg = dict(in_channels=4, mid_channels=32, num_blocks_per_stage=1, **UPSAMPLERS[variant])
    jm, pm = pair(jax_up.LTXLatentUpsampler, port_up.LTXLatentUpsampler, cfg)
    z = np.random.default_rng(6).normal(size=(1, 4, 3, 4, 6)).astype(np.float32)
    want = jitted(jm, lambda m, a: jax_up.upsample_latents(a, vae[0], m), z)
    got = port_up.upsample_latents(torch.from_numpy(z), vae[1], pm)
    assert tuple(got.shape) == want.shape
    assert_close(got, want, 1e-5)


def test_published_names_round_trip(gemma, dit, vae):
    assert_published_round_trip("gemma3", lambda: port_gemma.Gemma3TextEncoder(
        port_gemma.Gemma3Config.from_dict(GEMMA), dtype=torch.float32), gemma[0])
    assert_published_round_trip("ltx2", lambda: port_dit.LTX2VideoTransformer3D(
        port_dit.LTX2Config.from_dict(dict(TINY["transformer"], num_layers=2)), dtype=torch.float32), dit[0])
    assert_published_round_trip("ltx2_vae", lambda: port_vae.AutoencoderKLLTX2(port_vae.LTX2VAEConfig.from_dict(VAE)),
                                vae[0])
    for family, jax_cls, port_cls, cfg in (
            ("ltx2_connectors", jax_conn.LTX2TextConnectors, port_conn.LTX2TextConnectors, CONNECTORS),
            ("ltx2_audio_vae", jax_avae.AutoencoderKLLTX2Audio, port_avae.AutoencoderKLLTX2Audio, AUDIO_VAE),
            ("ltx2_vocoder", jax_voc.LTX2Vocoder, port_voc.LTX2Vocoder, VOCODER),
            ("ltx2_upsampler", jax_up.LTXLatentUpsampler, port_up.LTXLatentUpsampler,
             dict(in_channels=4, mid_channels=32, num_blocks_per_stage=1)),
            ("ltx2_upsampler", jax_up.LTXLatentUpsampler, port_up.LTXLatentUpsampler,
             dict(in_channels=4, mid_channels=32, num_blocks_per_stage=1, temporal_upsample=True))):
        jm = nnx.eval_shape(lambda: jax_cls(jax_cls.config_class.from_dict(cfg), rngs=nnx.Rngs(0)))
        assert_published_round_trip(family, lambda: port_cls(port_cls.config_class.from_dict(cfg),
                                                             dtype=torch.float32), jm)


@pytest.mark.parametrize("manifest", MANIFESTS, ids=lambda p: p.stem)
def test_manifests_resolve_in_the_port(manifest):
    from apex_studio_tpu_torch.engine import ltx2 as port_engine
    from apex_studio_tpu_torch.engine.registry import resolve_engine_class
    from apex_studio_tpu_torch.models.registry import (_load_builtin_families, helper_registry,
                                                       text_encoder_registry, transformer_registry, vae_registry)
    from apex_studio_tpu_torch.schedulers import rectified_flow, scheduler_registry

    doc = yaml.safe_load(manifest.read_text())["spec"]
    types = {"ti2v": port_engine.LTX2TI2VEngine, "multimodal_guidance": port_engine.LTX2MultimodalGuidanceEngine,
             "ic_lora": port_engine.LTX2ICLoraEngine,
             "keyframe_interpolation": port_engine.LTX2KeyframeInterpolationEngine}
    assert resolve_engine_class(doc["engine"], doc["model_type"]) is port_engine.LTX2TI2VEngine
    for model_type, cls in types.items():
        assert resolve_engine_class(doc["engine"], model_type) is cls
    _load_builtin_families()
    named = {c.get("name") or c["type"]: c for c in doc["components"]}
    assert transformer_registry.get(named["transformer"]["base"]) is port_dit.LTX2VideoTransformer3D
    assert vae_registry.get(named["video_vae"]["base"]) is port_vae.AutoencoderKLLTX2
    assert vae_registry.get(named["audio_vae"]["base"]) is port_avae.AutoencoderKLLTX2Audio
    assert text_encoder_registry.get(named["text_encoder"]["base"]) is port_gemma.Gemma3TextEncoder
    assert helper_registry.get(named["connectors"]["base"]) is port_conn.LTX2TextConnectors
    assert helper_registry.get(named["vocoder"]["base"]) is port_voc.LTX2Vocoder
    assert scheduler_registry.get(named["scheduler"]["base"]) is rectified_flow.RectifiedFlowScheduler
    cfg = port_dit.LTX2Config.from_dict(named["transformer"]["config"])
    assert (cfg.inner_dim, cfg.audio_inner_dim, cfg.num_layers) == (4096, 2048, 48)
