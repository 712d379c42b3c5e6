"""The port's HunyuanVideo (original) DiT in both image-condition modes, its
FramePack DiT, and its VAE (with the chunked frame-causal mid attention)
against the JAX package's, on the CPU in f32, weights carried from the JAX
modules (built with seeded numpy values, ``jax_build``) and the JAX forwards
jitted. Also the four new converter families' round trips through
``loaders/export.py``.

Tolerance: max|Δ| ≤ 1e-4·max|ref| (the port's attention runs the flash
kernel's plain version here, JAX its XLA path).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.models.transformers.hunyuanvideo import HunyuanVideoConfig as JaxConfig
from apex_studio_tpu.models.transformers.hunyuanvideo import HunyuanVideoTransformer3DModel as JaxDiT
from apex_studio_tpu.models.transformers.hunyuanvideo_framepack import (
    HunyuanVideoFramepackTransformer3DModel as JaxFramepack,
)
from apex_studio_tpu.models.vaes.hunyuanvideo_vae import AutoencoderKLHunyuanVideo as JaxVAE
from apex_studio_tpu.models.vaes.hunyuanvideo_vae import HunyuanVideoVAEConfig as JaxVAEConfig
from apex_studio_tpu.models.vaes.hunyuanvideo_vae import HVMidAttention as JaxMidAttention
from apex_studio_tpu_torch.loaders.converters import convert_keys
from apex_studio_tpu_torch.loaders.export import published_state_dict
from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict
from apex_studio_tpu_torch.models.transformers.hunyuanvideo import (
    HunyuanVideoConfig,
    HunyuanVideoTransformer3DModel,
)
from apex_studio_tpu_torch.models.transformers.hunyuanvideo_framepack import (
    HunyuanVideoFramepackTransformer3DModel,
)
from apex_studio_tpu_torch.models.vaes import hunyuanvideo_vae
from apex_studio_tpu_torch.models.vaes.hunyuanvideo_vae import (
    AutoencoderKLHunyuanVideo,
    HunyuanVideoVAEConfig,
    HVMidAttention,
    frame_causal_attention,
)
from tests.torch_port_helpers import assert_close, jax_build, port_from_jax

# tests/test_engine_hunyuanvideo.py's tiny DiT at 2 + 2 blocks
TINY = dict(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=24, num_layers=2,
            num_single_layers=2, num_refiner_layers=1, mlp_ratio=2.0, patch_size=2, text_embed_dim=32,
            pooled_projection_dim=24, rope_axes_dim=(8, 8, 8))
VAE = dict(latent_channels=4, block_out_channels=(8, 16, 16), layers_per_block=1, norm_num_groups=4,
           spatial_compression_ratio=4, temporal_compression_ratio=2, scaling_factor=0.476986)


_PAIRS = {}


def dit_pair(jax_cls, port_cls, **overrides):
    """The JAX module and the port module carrying its weights, built once a
    configuration for the module."""
    key = (jax_cls, tuple(sorted(overrides.items())))
    if key not in _PAIRS:
        kw = {**TINY, **overrides}
        jm = jax_build(lambda: jax_cls(JaxConfig(**kw), dtype=jnp.float32, param_dtype=jnp.float32,
                                       rngs=nnx.Rngs(0)))
        _PAIRS[key] = jm, port_from_jax(lambda: port_cls(HunyuanVideoConfig(**kw), dtype=torch.float32), jm)
    return _PAIRS[key]


def normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def dit_inputs(in_channels, b=2, t=3, h=4, w=6, lt=7):
    mask = np.ones((b, lt), np.int32)
    mask[0, 3:] = 0  # the first prompt is padded: the joint key bias bites
    return {"x": normal(b, in_channels, t, h, w, seed=1), "t": np.array([900.0, 250.0], np.float32)[:b],
            "text": normal(b, lt, TINY["text_embed_dim"], seed=2), "text_mask": mask,
            "pooled": normal(b, TINY["pooled_projection_dim"], seed=3),
            "guidance": np.array([6000.0, 3500.0], np.float32)[:b]}


def run_both(jm, pm, arrs, keys):
    fn = nnx.jit(lambda m, *a, **kw: m(*a, **kw))
    kw = {k: jnp.asarray(arrs[k]) for k in keys}
    ref = fn(jm, jnp.asarray(arrs["x"]), jnp.asarray(arrs["t"]), jnp.asarray(arrs["text"]), **kw)
    with torch.inference_mode():
        out = pm(torch.from_numpy(arrs["x"]), torch.from_numpy(arrs["t"]), torch.from_numpy(arrs["text"]),
                 **{k: torch.from_numpy(arrs[k]) for k in keys})
    return out, np.asarray(ref)


# (image_condition_type, input channels, keys passed to the forward)
DIT_CASES = [
    ("t2v", None, 4, ("text_mask", "pooled", "guidance")),
    ("token_replace", "token_replace", 4, ("text_mask", "pooled", "guidance")),
    ("latent_concat", "latent_concat", 9, ("text_mask", "pooled", "guidance")),
    ("unmasked_no_pooled_no_guidance", None, 4, ()),
]


class TestDiT:
    @pytest.mark.parametrize("name,ctype,cin,keys", DIT_CASES, ids=[c[0] for c in DIT_CASES])
    def test_forward_matches_jax(self, name, ctype, cin, keys):
        jm, pm = dit_pair(JaxDiT, HunyuanVideoTransformer3DModel, in_channels=cin, image_condition_type=ctype)
        out, ref = run_both(jm, pm, dit_inputs(cin), keys)
        assert tuple(out.shape) == ref.shape == (2, 4, 3, 4, 6)
        assert_close(out, ref)

    def test_token_replace_modulates_the_first_frame_only(self):
        """token_replace changes the first latent frame's tokens' modulation:
        the output differs from the plain DiT's with the same weights, and the
        difference starts in frame 0's tokens (later ones follow through the
        attention)."""
        _, plain = dit_pair(JaxDiT, HunyuanVideoTransformer3DModel, in_channels=4, image_condition_type=None)
        tr = HunyuanVideoTransformer3DModel(HunyuanVideoConfig(**TINY, image_condition_type="token_replace"),
                                            dtype=torch.float32)
        tr.load_state_dict(plain.state_dict())
        arrs = dit_inputs(4)
        args = [torch.from_numpy(arrs[k]) for k in ("x", "t", "text", "text_mask", "pooled", "guidance")]
        with torch.inference_mode():
            a, b = plain(*args), tr(*args)
            t0 = torch.zeros(2)
            a0, b0 = plain(args[0], t0, *args[2:]), tr(args[0], t0, *args[2:])
        assert not torch.allclose(a, b)
        torch.testing.assert_close(a0, b0, rtol=0, atol=0)  # at t = 0 the two embeddings coincide


class TestFramepackDiT:
    @pytest.mark.parametrize("history", [False, True], ids=["section_only", "clean_2x_4x_history"])
    def test_forward_matches_jax(self, history):
        jm, pm = dit_pair(JaxFramepack, HunyuanVideoFramepackTransformer3DModel)
        arrs = dit_inputs(4, b=1, t=2, h=8, w=8)
        arrs["image_embeds"] = normal(1, 5, 1152, seed=4)
        kw = {"image_embeds": arrs["image_embeds"], "indices_latents": np.array([3, 4])}
        if history:
            kw.update(latents_clean=normal(1, 4, 2, 8, 8, seed=5), indices_latents_clean=np.array([0, 5]),
                      latents_history_2x=normal(1, 4, 2, 8, 8, seed=6), indices_latents_history_2x=np.array([6, 7]),
                      latents_history_4x=normal(1, 4, 4, 8, 8, seed=7),
                      indices_latents_history_4x=np.arange(8, 12))
        fn = nnx.jit(lambda m, x, t, text, mask, pooled, g, arrays: m(
            x, t, text, mask, pooled=pooled, guidance=g, **arrays,
            **{k: v for k, v in kw.items() if k.startswith("indices")}))
        arrays = {k: jnp.asarray(v) for k, v in kw.items() if not k.startswith("indices")}
        ref = np.asarray(fn(jm, *(jnp.asarray(arrs[k]) for k in ("x", "t", "text", "text_mask", "pooled",
                                                                 "guidance")), arrays))
        with torch.inference_mode():
            out = pm(*(torch.from_numpy(arrs[k]) for k in ("x", "t", "text", "text_mask")),
                     pooled=torch.from_numpy(arrs["pooled"]), guidance=torch.from_numpy(arrs["guidance"]),
                     **{k: (torch.from_numpy(v) if not k.startswith("indices") else v) for k, v in kw.items()})
        assert tuple(out.shape) == ref.shape == (1, 4, 2, 8, 8)
        assert_close(out, ref)


@pytest.fixture(scope="module")
def vae_pair():
    jm = jax_build(lambda: JaxVAE(JaxVAEConfig(**VAE), rngs=nnx.Rngs(0)))
    return jm, port_from_jax(lambda: AutoencoderKLHunyuanVideo(HunyuanVideoVAEConfig(**VAE)), jm)


class TestVAE:
    def test_encode_decode_match_jax(self, vae_pair):
        jm, pm = vae_pair
        video = np.tanh(normal(1, 3, 5, 16, 16, seed=8))
        ref_z = np.array(nnx.jit(lambda m, v: m.encode(v))(jm, jnp.asarray(video)))
        ref = np.asarray(nnx.jit(lambda m, z: m.decode(z))(jm, jnp.asarray(ref_z)))
        with torch.inference_mode():
            z = pm.encode(torch.from_numpy(video))
            out = pm.decode(torch.from_numpy(ref_z))
        assert tuple(z.shape) == ref_z.shape == (1, 4, 3, 4, 4)
        assert tuple(out.shape) == ref.shape == (1, 3, 5, 16, 16)
        assert_close(z, ref_z)
        assert_close(out, ref)

    def test_chunked_conv_equals_whole(self, vae_pair, monkeypatch):
        """A decode whose convolutions run in chunks of output frames (each
        padding only what it reads) equals the whole-call decode."""
        _, pm = vae_pair
        z = torch.from_numpy(normal(1, 4, 4, 4, 4, seed=9))
        with torch.inference_mode():
            whole = pm.decode(z)
            monkeypatch.setattr(hunyuanvideo_vae, "CONV_CHUNK_ELEMENTS", 2 * 16 * 18 * 18)
            chunked = pm.decode(z)
        torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-6)

    def test_chunked_group_norm_of_half_inputs(self, monkeypatch):
        """A bf16 input past the chunk size is normalised over chunks of
        frames with f32 statistics: it equals the whole f32 group norm of
        the input, cast to bf16, within one bf16 step."""
        from apex_studio_tpu_torch.models.vaes.hunyuanvideo_vae import GroupNormCh

        norm = GroupNormCh(4, 16)
        with torch.no_grad():
            norm.weight.copy_(torch.from_numpy(1 + 0.1 * normal(16, seed=14)))
            norm.bias.copy_(torch.from_numpy(0.1 * normal(16, seed=15)))
        x = (3.0 + torch.from_numpy(normal(2, 16, 5, 6, 7, seed=16))).to(torch.bfloat16)
        whole = torch.nn.functional.group_norm(x.float(), 4, norm.weight, norm.bias, 1e-6).to(torch.bfloat16)
        monkeypatch.setattr(hunyuanvideo_vae, "GROUP_NORM_CHUNK_ELEMENTS", 2 * 16 * 6 * 7 * 2)
        with torch.no_grad():
            chunked = norm(x)
        assert chunked.dtype == torch.bfloat16
        torch.testing.assert_close(chunked.float(), whole.float(), rtol=2 ** -7, atol=2 ** -7)

    @pytest.mark.parametrize("rows", [1, 5, 16, 4096])
    def test_chunked_mid_attention_matches_jax(self, rows):
        """The frame-causal mid attention in query-row chunks (row chunks that
        cut frames, and one chunk) against the JAX whole-matrix version."""
        jm = jax_build(lambda: JaxMidAttention(16, 4, dtype=jnp.float32, rngs=nnx.Rngs(0)))
        pm = port_from_jax(lambda: HVMidAttention(16, 4, dtype=torch.float32), jm)
        x = normal(1, 3, 2, 3, 16, seed=10)  # [B, T, H, W, C]: 3 frames of 6 tokens
        ref = np.asarray(nnx.jit(lambda m, x: m(x))(jm, jnp.asarray(x)))
        original = hunyuanvideo_vae.frame_causal_attention
        with torch.inference_mode(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(hunyuanvideo_vae, "frame_causal_attention",
                       lambda q, k, v, n: original(q, k, v, n, rows=rows))
            out = pm(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
        assert_close(out.permute(0, 2, 3, 4, 1), ref)

    def test_frame_causal_attention_is_causal_in_frames(self):
        q, k, v = (torch.from_numpy(normal(1, 12, 8, seed=s)) for s in (11, 12, 13))
        out = frame_causal_attention(q, k, v, 4, rows=3)
        k2, v2 = k.clone(), v.clone()
        k2[:, 8:], v2[:, 8:] = 5.0, -5.0  # the last frame's keys and values
        out2 = frame_causal_attention(q, k2, v2, 4, rows=3)
        torch.testing.assert_close(out[:, :8], out2[:, :8], rtol=0, atol=0)
        assert not torch.allclose(out[:, 8:], out2[:, 8:])


# the converter round trips: builders of modules whose published names differ from the port's
def _framepack():
    return HunyuanVideoFramepackTransformer3DModel(HunyuanVideoConfig(**TINY), dtype=torch.float32)


def _humo():
    from apex_studio_tpu_torch.models.transformers.wan_humo import HumoWanTransformerModel, WanHuMoConfig
    from tests.test_engine_wan_humo import _TF_CFG

    return HumoWanTransformerModel(WanHuMoConfig(**_TF_CFG), dtype=torch.float32)


def _wav2vec2():
    from apex_studio_tpu_torch.models.audio.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model

    return Wav2Vec2Model(Wav2Vec2Config(hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                                        intermediate_size=32, conv_dim=(4,) * 7))


ROUND_TRIPS = [
    ("hunyuanvideo", lambda: HunyuanVideoTransformer3DModel(
        HunyuanVideoConfig(**TINY, image_condition_type="token_replace"), dtype=torch.float32)),
    ("hunyuanvideo", _framepack),
    ("hunyuanvideo_vae", lambda: AutoencoderKLHunyuanVideo(HunyuanVideoVAEConfig(**VAE))),
    ("wan_humo", _humo),
    ("wav2vec2", _wav2vec2),
]


class TestConverters:
    @pytest.mark.parametrize("family,build", ROUND_TRIPS,
                             ids=["hunyuanvideo", "hunyuanvideo_framepack", "hunyuanvideo_vae", "wan_humo",
                                  "wav2vec2"])
    def test_published_names_round_trip(self, family, build):
        """A module's state under the published names loads back through
        the family's converter, strictly and bit-equal."""
        from apex_studio_tpu_torch.engine.base import materialize_random

        src = materialize_random(build, torch.device("cpu"), seed=3)
        published = published_state_dict(family, src.state_dict())
        assert set(published) != set(src.state_dict())  # the published names differ
        dst = materialize_random(build, torch.device("cpu"), seed=4)
        apply_state_dict(dst, convert_keys(family, published), strict=True)
        for name, value in src.state_dict().items():
            assert torch.equal(dst.state_dict()[name], value), name

    def test_published_key_examples(self):
        """Spot checks against the diffusers / transformers names."""
        sd = published_state_dict("hunyuanvideo", _framepack().state_dict())
        for key in ("x_embedder.proj.weight", "time_text_embed.guidance_embedder.linear_1.weight",
                    "context_embedder.token_refiner.refiner_blocks.0.attn.to_out.0.weight",
                    "context_embedder.token_refiner.refiner_blocks.0.norm_out.linear.bias",
                    "transformer_blocks.0.attn.add_q_proj.weight", "transformer_blocks.0.attn.norm_added_k.weight",
                    "transformer_blocks.0.ff_context.net.0.proj.weight", "transformer_blocks.0.norm1.linear.weight",
                    "single_transformer_blocks.1.norm.linear.weight", "single_transformer_blocks.1.attn.to_q.weight",
                    "single_transformer_blocks.1.proj_mlp.weight", "norm_out.linear.weight",
                    "clean_x_embedder.proj_4x.weight", "image_projection.up.weight"):
            assert key in sd, key
        vae = published_state_dict("hunyuanvideo_vae",
                                   AutoencoderKLHunyuanVideo(HunyuanVideoVAEConfig(**VAE)).state_dict())
        for key in ("encoder.conv_in.conv.weight", "encoder.down_blocks.0.downsamplers.0.conv.conv.weight",
                    "decoder.up_blocks.0.resnets.0.conv1.conv.bias", "decoder.mid_block.attentions.0.to_out.0.weight",
                    "decoder.mid_block.attentions.0.group_norm.weight", "quant_conv.weight",
                    "encoder.down_blocks.1.resnets.0.conv_shortcut.conv.weight"):
            assert key in vae, key
