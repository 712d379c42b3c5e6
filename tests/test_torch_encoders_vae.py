"""The port's CLIP and T5 text encoders and the AutoencoderKL against the JAX
package's, on the CPU in f32, with weights carried from the JAX modules.
Tolerance: max|Δ| ≤ 1e-4·max|ref|."""

import numpy as np
import pytest
import torch

import jax
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
from tests.torch_port_helpers import assert_close, jax_build, jitted, port_from_jax

def f32():
    """f32 JAX build arguments with a fresh ``Rngs`` each build."""
    return dict(dtype=jnp.float32, param_dtype=jnp.float32, rngs=nnx.Rngs(0))
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
        jm = jax_build(lambda: JaxCLIP(JaxCLIPConfig(**CLIP), **f32()))
        pm = port_from_jax(lambda: CLIPTextEncoder(CLIPTextConfig(**CLIP), dtype=torch.float32), jm)
        ids, mask = ids_and_mask()
        graphdef, state = nnx.split(jm)
        ref_h, ref_p = jax.jit(lambda s, i, m: nnx.merge(graphdef, s)(i, attention_mask=m))(
            state, jnp.asarray(ids), jnp.asarray(mask))
        with torch.no_grad():
            h, p = pm(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))
        assert torch.isfinite(h).all()  # the empty prompt averages, it does not NaN
        assert_close(h, ref_h)
        assert_close(p, ref_p)


class TestT5:
    @pytest.mark.parametrize("umt5", [False, True])
    def test_encoder_matches_jax(self, umt5):
        jm = jax_build(lambda: JaxT5(JaxT5Config(**T5, per_layer_relative_bias=umt5), **f32()))
        pm = port_from_jax(lambda: T5Encoder(T5Config(**T5, per_layer_relative_bias=umt5),
                                             dtype=torch.float32), jm)
        ids, mask = ids_and_mask()
        ref = jitted(jm, lambda m, i, k: m(i, attention_mask=k), ids, mask)
        with torch.no_grad():
            out = pm(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))
        assert_close(out, ref)


class TestAutoencoderKL:
    @pytest.fixture(scope="class")
    def pair(self):
        jm = jax_build(lambda: JaxVAE(JaxVAEConfig(**VAE), **f32()))
        pm = port_from_jax(lambda: AutoencoderKL(AutoencoderKLConfig(**VAE), dtype=torch.float32), jm)
        return jm, pm

    def test_decode_matches_jax(self, pair):
        jm, pm = pair
        z = np.random.default_rng(0).normal(size=(2, 4, 6, 8)).astype(np.float32)
        ref = jitted(jm, lambda m, a: m.decode(a), z)
        with torch.no_grad():
            out = pm.decode(torch.from_numpy(z))
        assert tuple(out.shape) == (2, 3, 12, 16)
        assert_close(out, ref)

    def test_encode_matches_jax(self, pair):
        jm, pm = pair
        x = np.random.default_rng(1).uniform(-1, 1, size=(1, 3, 16, 12)).astype(np.float32)
        ref = jitted(jm, lambda m, a: m.encode(a), x)
        with torch.no_grad():
            out = pm.encode(torch.from_numpy(x))
        assert_close(out, ref)


FLUX2_VAE = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4,
                 scaling_factor=1.0, shift_factor=None, use_quant_conv=True, use_post_quant_conv=True,
                 packed_batch_norm=True)


class TestFlux2VAE:
    """The FLUX.2 variant: quant convs, and the packed latents normalized by
    BatchNorm running statistics (16 = 2·2·4 of them here, carried as 1-D
    parameters), as ``AutoencoderKLFlux2`` / ``flux2`` name it."""

    @pytest.fixture(scope="class")
    def pair(self):
        jm = jax_build(lambda: JaxVAE(JaxVAEConfig(**FLUX2_VAE), **f32()), seed=2)
        pm = port_from_jax(lambda: AutoencoderKL(AutoencoderKLConfig(**FLUX2_VAE), dtype=torch.float32), jm)
        return jm, pm

    def test_statistics_and_quant_convs_are_carried(self, pair):
        _, pm = pair
        assert tuple(pm.bn_mean.shape) == tuple(pm.bn_var.shape) == (16,)
        assert pm.quant_conv is not None and pm.post_quant_conv is not None
        assert float(pm.bn_var.min()) > 0 and not torch.all(pm.bn_mean == 0)

    def test_encode_normalize_match_jax(self, pair):
        from apex_studio_tpu.models.transformers.flux2 import Flux2Transformer2DModel as JaxFlux2
        from apex_studio_tpu_torch.models.transformers.flux2 import Flux2Transformer2DModel

        jm, pm = pair
        x = np.random.default_rng(3).uniform(-1, 1, size=(1, 3, 16, 24)).astype(np.float32)
        ref = jitted(jm, lambda m, a: m.normalize_packed(JaxFlux2.pack_latents(m.encode(a))), x)
        with torch.no_grad():
            out = pm.normalize_packed(Flux2Transformer2DModel.pack_latents(pm.encode(torch.from_numpy(x))))
        assert tuple(out.shape) == (1, 24, 16)
        assert_close(out, ref)

    def test_denormalize_decode_match_jax(self, pair):
        jm, pm = pair
        tokens = np.random.default_rng(4).normal(size=(1, 12, 16)).astype(np.float32)
        ref = jm.denormalize_packed(jnp.asarray(tokens))
        with torch.no_grad():
            out = pm.denormalize_packed(torch.from_numpy(tokens))
            back = pm.normalize_packed(out)
        assert_close(out, ref)
        assert_close(back, tokens)
        z = np.random.default_rng(5).normal(size=(1, 4, 6, 8)).astype(np.float32)
        with torch.no_grad():
            img = pm.decode(torch.from_numpy(z))
        assert tuple(img.shape) == (1, 3, 12, 16)
        assert_close(img, jitted(jm, lambda m, a: m.decode(a), z))

    def test_registered_under_the_manifest_names(self):
        from apex_studio_tpu_torch.models.registry import _load_builtin_families, vae_registry

        _load_builtin_families()
        for name in ("AutoencoderKLFlux2", "flux2", "flux2.vae", "auto"):
            assert vae_registry.get(name) is AutoencoderKL

    def test_synthetic_running_statistics_are_reset(self):
        """Random synthetic weights leave the running statistics at a fresh
        BatchNorm's (mean 0, variance 1): a variance drawn as a weight may be
        negative, and the normalization would be NaN."""
        from apex_studio_tpu_torch.engine.base import materialize_random

        pm = materialize_random(lambda: AutoencoderKL(AutoencoderKLConfig(**FLUX2_VAE), dtype=torch.float32),
                                torch.device("cpu"), seed=0)
        assert float(pm.bn_var.min()) < 0  # drawn like a weight
        pm.reset_running_stats()
        assert torch.equal(pm.bn_mean, torch.zeros(16)) and torch.equal(pm.bn_var, torch.ones(16))
