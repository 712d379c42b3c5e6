"""The port's wav2vec2 audio encoder, HuMo's audio projection and the HuMo
DiT against the JAX package's, on the CPU in f32, weights carried from the
JAX modules (built with seeded numpy values, ``jax_build``; wav2vec2's conv
kernels WIO → OIW) and the JAX forwards jitted.

Tolerance: max|Δ| ≤ 1e-4·max|ref| for every hidden state and output;
1e-5 for the linear resampling alone (each framework's f32 ``linspace``
rounds the sample positions in its own way).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.models.audio.wav2vec2 import Wav2Vec2Config as JaxW2VConfig
from apex_studio_tpu.models.audio.wav2vec2 import Wav2Vec2Model as JaxW2V
from apex_studio_tpu.models.audio.wav2vec2 import interpolate_linear as jax_interpolate
from apex_studio_tpu.models.transformers.wan_humo import HuMoAudioProj as JaxAudioProj
from apex_studio_tpu.models.transformers.wan_humo import HumoWanTransformerModel as JaxHuMo
from apex_studio_tpu.models.transformers.wan_humo import WanHuMoConfig as JaxHuMoConfig
from apex_studio_tpu_torch.models.audio.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model, interpolate_linear
from apex_studio_tpu_torch.models.transformers.wan_humo import HuMoAudioProj, HumoWanTransformerModel, WanHuMoConfig
from tests.test_engine_wan_humo import _TF_CFG
from tests.torch_port_helpers import assert_close, jax_build, port_from_jax

# tests/test_audio_wav2vec2.py's tiny encoder
W2V = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64, conv_dim=(8,) * 7,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


class TestWav2Vec2:
    @pytest.mark.parametrize("variant,seq_len", [
        ("group_norm_post_norm", None), ("group_norm_post_norm", 17),
        ("layer_norm_stable", 9)], ids=["group", "group_resampled_to_17", "stable_resampled_to_9"])
    def test_hidden_states_match_jax(self, variant, seq_len):
        kw = dict(W2V) if variant.startswith("group") else dict(W2V, feat_extract_norm="layer",
                                                                 do_stable_layer_norm=True)
        jm = jax_build(lambda: JaxW2V(JaxW2VConfig(**kw), rngs=nnx.Rngs(0)))
        pm = port_from_jax(lambda: Wav2Vec2Model(Wav2Vec2Config(**kw)), jm)
        wav = 0.1 * normal(1, 4000, seed=1)
        ref = nnx.jit(lambda m, w: m(w, seq_len=seq_len))(jm, jnp.asarray(wav))
        with torch.inference_mode():
            out = pm(torch.from_numpy(wav), seq_len=seq_len)
        assert len(out) == len(ref) == 3
        for o, r in zip(out, ref):
            assert tuple(o.shape) == r.shape and o.dtype == torch.float32
            assert_close(o, np.asarray(r))

    def test_attention_takes_the_flash_route(self, monkeypatch):
        """The encoder's attention goes to the flash wrapper, as the JAX
        module's goes to the Pallas kernel (its default route): on the CPU
        the wrapper's plain version runs, once a layer."""
        from apex_studio_tpu_torch.ops.attention import flash

        calls = []
        plain = flash.flash_attention_reference

        def counted(q, k, v, **kw):
            calls.append((tuple(q.shape), q.dtype))
            return plain(q, k, v, **kw)

        monkeypatch.setattr(flash, "flash_attention_reference", counted)
        jm = jax_build(lambda: JaxW2V(JaxW2VConfig(**W2V), rngs=nnx.Rngs(0)))
        pm = port_from_jax(lambda: Wav2Vec2Model(Wav2Vec2Config(**W2V)), jm)
        with torch.inference_mode():
            pm(torch.from_numpy(0.1 * normal(1, 4000, seed=3)), seq_len=9)
        assert calls == [((1, 9, 2, 16), torch.float32)] * W2V["num_hidden_layers"]

    @pytest.mark.parametrize("n,out_len", [(12, 97), (40, 33), (1, 5), (7, 7)])
    def test_interpolate_linear_matches_jax(self, n, out_len):
        feats = normal(2, n, 3, seed=2)
        assert_close(interpolate_linear(torch.from_numpy(feats), out_len),
                     np.asarray(jax_interpolate(jnp.asarray(feats), out_len)), rel=1e-5)


def humo_pair(**overrides):
    kw = {**_TF_CFG, **overrides}
    jm = jax_build(lambda: JaxHuMo(JaxHuMoConfig(**kw), dtype=jnp.float32, param_dtype=jnp.float32,
                                   rngs=nnx.Rngs(0)))
    return jm, port_from_jax(lambda: HumoWanTransformerModel(WanHuMoConfig(**kw), dtype=torch.float32), jm)


class TestHuMo:
    def test_audio_proj_matches_jax(self):
        cfg = JaxHuMoConfig(**_TF_CFG)
        jm = jax_build(lambda: JaxAudioProj(cfg, rngs=nnx.Rngs(0)))
        pm = port_from_jax(lambda: HuMoAudioProj(WanHuMoConfig(**_TF_CFG)), jm)
        windows = normal(1, 4, 6, 2, 16, seed=3)
        ref = nnx.jit(lambda m, w: m(w))(jm, jnp.asarray(windows))
        with torch.inference_mode():
            out = pm(torch.from_numpy(windows))
        assert tuple(out.shape) == ref.shape == (1, 4, 4, 16)
        assert_close(out, np.asarray(ref))

    # audio frames against the 3 latent frames: equal, longer (truncated),
    # shorter (the tail zero-filled), none
    @pytest.mark.parametrize("audio_frames", [3, 5, 2, None], ids=["equal", "longer", "shorter", "no_audio"])
    def test_forward_matches_jax(self, audio_frames):
        jm, pm = humo_pair()
        x, ctx, y = normal(1, 4, 3, 8, 8, seed=4), normal(1, 5, 32, seed=5), normal(1, 6, 3, 8, 8, seed=6)
        t = np.array([700.0], np.float32)
        audio = None if audio_frames is None else normal(1, audio_frames, 6, 2, 16, seed=7)
        fn = nnx.jit(lambda m, x, t, c, a, y: m(x, t, c, a, y))
        ref = np.asarray(fn(jm, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                            None if audio is None else jnp.asarray(audio), jnp.asarray(y)))
        with torch.inference_mode():
            out = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                     None if audio is None else torch.from_numpy(audio), torch.from_numpy(y))
        assert tuple(out.shape) == ref.shape == (1, 4, 3, 8, 8)
        assert_close(out, ref)

    def test_one_frames_audio_moves_that_frame_first(self):
        """A change to latent frame 1's audio window changes frame 1's
        tokens in the first block's audio attention and no other frame's."""
        _, pm = humo_pair(num_layers=1)
        blk = pm.blocks[0]
        x = torch.from_numpy(normal(1, 3 * 16, 24, seed=8))
        audio = torch.from_numpy(normal(1, 3, 4, 16, seed=9))
        changed = audio.clone()
        changed[:, 1] = changed[:, 1] * 3.0 + 1.0
        with torch.inference_mode():
            a, b = blk._audio_attn(x, audio, 3), blk._audio_attn(x, changed, 3)
        diff = (a - b).abs().reshape(3, 16, 24).amax(dim=(1, 2))
        assert diff[1] > 0 and diff[0] == 0 and diff[2] == 0
