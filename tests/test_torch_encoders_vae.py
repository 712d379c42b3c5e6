"""The port's CLIP and T5 text encoders and the AutoencoderKL against the JAX
package's, on the CPU in f32, with weights carried from the JAX modules.
Tolerance: max|Δ| ≤ 1e-4·max|ref|."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.models.text_encoders.clip import CLIPTextConfig as JaxCLIPConfig
from apex_studio_tpu.models.text_encoders.clip import CLIPTextEncoder as JaxCLIP
from apex_studio_tpu.models.text_encoders.t5 import T5Config as JaxT5Config
from apex_studio_tpu.models.text_encoders.t5 import T5Encoder as JaxT5
from apex_studio_tpu.models.vaes.autoencoder_kl import AutoencoderKL as JaxVAE
from apex_studio_tpu.models.vaes.autoencoder_kl import AutoencoderKLConfig as JaxVAEConfig
from apex_studio_tpu_torch.models.text_encoders.clip import CLIPTextConfig, CLIPTextEncoder
from apex_studio_tpu_torch.models.text_encoders.t5 import T5Config, T5Encoder
from apex_studio_tpu_torch.models.vaes.autoencoder_kl import AutoencoderKL, AutoencoderKLConfig
from tests.torch_port_helpers import assert_close, port_from_jax

F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32, rngs=nnx.Rngs(0))
CLIP = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, max_position_embeddings=16)
T5 = dict(vocab_size=64, d_model=48, d_kv=8, d_ff=64, num_layers=2, num_heads=4)
VAE = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4,
           scaling_factor=0.5, shift_factor=0.1)


def ids_and_mask():
    """Three prompts: full, padded, and empty (every key masked for CLIP)."""
    ids = np.zeros((3, 12), np.int32)
    mask = np.zeros((3, 12), np.int32)
    ids[0] = np.arange(1, 13)
    mask[0] = 1
    ids[1, :5] = [5, 9, 2, 63, 7]
    mask[1, :5] = 1
    return ids, mask


class TestCLIP:
    def test_hidden_and_pooled_match_jax(self):
        jm = JaxCLIP(JaxCLIPConfig(**CLIP), **F32)
        pm = port_from_jax(lambda: CLIPTextEncoder(CLIPTextConfig(**CLIP), dtype=torch.float32), jm)
        ids, mask = ids_and_mask()
        ref_h, ref_p = jm(jnp.asarray(ids), attention_mask=jnp.asarray(mask))
        with torch.no_grad():
            h, p = pm(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))
        assert torch.isfinite(h).all()  # the empty prompt averages, it does not NaN
        assert_close(h, ref_h)
        assert_close(p, ref_p)


class TestT5:
    @pytest.mark.parametrize("umt5", [False, True])
    def test_encoder_matches_jax(self, umt5):
        jm = JaxT5(JaxT5Config(**T5, per_layer_relative_bias=umt5), **F32)
        pm = port_from_jax(lambda: T5Encoder(T5Config(**T5, per_layer_relative_bias=umt5),
                                             dtype=torch.float32), jm)
        ids, mask = ids_and_mask()
        ref = jm(jnp.asarray(ids), attention_mask=jnp.asarray(mask))
        with torch.no_grad():
            out = pm(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))
        assert_close(out, ref)


class TestAutoencoderKL:
    @pytest.fixture(scope="class")
    def pair(self):
        jm = JaxVAE(JaxVAEConfig(**VAE), **F32)
        pm = port_from_jax(lambda: AutoencoderKL(AutoencoderKLConfig(**VAE), dtype=torch.float32), jm)
        return jm, pm

    def test_decode_matches_jax(self, pair):
        jm, pm = pair
        z = np.random.default_rng(0).normal(size=(2, 4, 6, 8)).astype(np.float32)
        ref = jm.decode(jnp.asarray(z))
        with torch.no_grad():
            out = pm.decode(torch.from_numpy(z))
        assert tuple(out.shape) == (2, 3, 12, 16)
        assert_close(out, ref)

    def test_encode_matches_jax(self, pair):
        jm, pm = pair
        x = np.random.default_rng(1).uniform(-1, 1, size=(1, 3, 16, 12)).astype(np.float32)
        ref = jm.encode(jnp.asarray(x))
        with torch.no_grad():
            out = pm.encode(torch.from_numpy(x))
        assert_close(out, ref)
