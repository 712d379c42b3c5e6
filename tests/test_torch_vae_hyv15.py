"""The port's HunyuanVideo 1.5 causal 3D VAE, its tiled decode and the TAEHV
preview decoder against the JAX package's, on the CPU in f32, with weights
carried from the JAX modules (DHWIO / HWIO kernels become OIDHW / OIHW). The
JAX modules are built with seeded numpy values (``jax_build``) and run
jitted.
Tolerance: max|Δ| ≤ 1e-4·max|ref|. The tiled decode rounds each tile to f16
before the f32 blend on both sides; where the two f32 decodes sit on either
side of an f16 rounding boundary they land one f16 step apart, so it is held
to max|Δ| ≤ 2e-3·max|ref| (one step is 2^-10 of its binade, at most twice the
value).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.models.vaes.hunyuanvideo15_vae import AutoencoderKLHunyuanVideo15 as JaxVAE
from apex_studio_tpu.models.vaes.hunyuanvideo15_vae import HYV15VAEConfig as JaxVAEConfig
from apex_studio_tpu.models.vaes.tae_vae import TAEVAE as JaxTAE
from apex_studio_tpu.models.vaes.tae_vae import TAEConfig as JaxTAEConfig
from apex_studio_tpu.models.vaes.tiling import decode_tiled_3d as jax_decode_tiled_3d
from apex_studio_tpu_torch.models.vaes.hunyuanvideo15_vae import AutoencoderKLHunyuanVideo15, HYV15VAEConfig
from apex_studio_tpu_torch.models.vaes.tae_vae import TAEVAE, TAEConfig
from apex_studio_tpu_torch.models.vaes.tiling import decode_tiled_3d
from tests.torch_port_helpers import assert_close, jax_build, port_from_jax

# tests/test_models_hyv15.py's tiny VAE: 4× space, 2× time
VAE = dict(latent_channels=4, block_out_channels=(8, 16, 32), layers_per_block=1,
           spatial_compression_ratio=4, temporal_compression_ratio=2, scaling_factor=1.03682)
# its 16× / 4× shape at small widths: two temporal and four spatial shuffles
VAE_DEEP = dict(latent_channels=4, block_out_channels=(8, 8, 16, 16, 16), layers_per_block=1,
                spatial_compression_ratio=16, temporal_compression_ratio=4, scaling_factor=1.03682)
# the manifest's light_vae_config at small widths, with latent statistics
TAE = dict(latent_channels=4, channels=(8, 8, 8, 8), act="leaky_relu", out_range="sym",
           scaling_factor=0.7, latents_mean=(0.1, -0.2, 0.0, 0.3), latents_std=(1.5, 0.5, 1.0, 2.0))


def vae_pair(cfg):
    jm = jax_build(lambda: JaxVAE(JaxVAEConfig(**cfg), rngs=nnx.Rngs(0)))
    return jm, port_from_jax(lambda: AutoencoderKLHunyuanVideo15(HYV15VAEConfig(**cfg)), jm)


def jitted(method):
    """``jm.<method>`` as one jitted program (eager JAX compiles op by op)."""
    fn = nnx.jit(lambda m, *a, **kw: getattr(m, method)(*a, **kw))
    return lambda jm, *a, **kw: fn(jm, *a, **kw)


@pytest.fixture(scope="module")
def tiny():
    return vae_pair(VAE)


def normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


class TestHYV15VAE:
    @pytest.mark.parametrize("cfg,video_shape,latent_shape", [
        (VAE, (2, 3, 5, 16, 12), (2, 4, 3, 4, 3)),
        (VAE, (1, 3, 1, 8, 8), (1, 4, 1, 2, 2)),
        (VAE_DEEP, (1, 3, 9, 32, 48), (1, 4, 3, 2, 3)),
    ], ids=["tiny_5f", "tiny_one_frame", "deep_9f"])
    def test_encode_decode_match_jax(self, cfg, video_shape, latent_shape):
        jm, pm = vae_pair(cfg)
        video = normal(*video_shape)
        ref_z = jitted("encode")(jm, jnp.asarray(video))
        with torch.no_grad():
            z = pm.encode(torch.from_numpy(video))
            assert tuple(z.shape) == latent_shape
            assert_close(z, ref_z)
            ref = jitted("decode")(jm, ref_z)
            out = pm.decode(torch.from_numpy(np.array(ref_z)))
        assert tuple(out.shape) == video_shape
        assert_close(out, ref)

    def test_encode_is_causal_in_time(self, tiny):
        """A change in the last frame leaves the first latent frame alone
        (tests/test_models_hyv15.py test_causality)."""
        _, pm = tiny
        v1 = torch.zeros(1, 3, 5, 16, 16)
        v2 = v1.clone()
        v2[:, :, 4] = 1.0
        with torch.no_grad():
            z1, z2 = pm.encode(v1), pm.encode(v2)
        torch.testing.assert_close(z1[:, :, 0], z2[:, :, 0], atol=1e-5, rtol=0)
        assert (z1[:, :, -1] - z2[:, :, -1]).abs().max() > 1e-4

    def test_sampled_encode_matches_jax(self, tiny):
        jm, pm = tiny
        video, noise = normal(1, 3, 3, 8, 8), normal(1, 4, 2, 2, 2, seed=1)
        ref = nnx.jit(lambda m, v, n: m.encode(v, sample=True, noise=n))(jm, jnp.asarray(video), jnp.asarray(noise))
        with torch.no_grad():
            out = pm.encode(torch.from_numpy(video), sample=True, noise=torch.from_numpy(noise))
        assert_close(out, ref)


class TestTiledDecode:
    @pytest.mark.parametrize("h,w,tile", [(10, 14, 4), (9, 6, 4), (6, 6, 8)],
                             ids=["ragged_both", "one_column_of_tiles", "untiled"])
    def test_matches_jax(self, tiny, h, w, tile):
        jm, pm = tiny
        z = normal(1, 4, 2, h, w, seed=2)
        decode = jitted("decode")
        ref = jax_decode_tiled_3d(lambda t: decode(jm, t), jnp.asarray(z), 4, tile=tile)
        with torch.no_grad():
            out = decode_tiled_3d(pm.decode, torch.from_numpy(z), 4, tile=tile)
        assert out.dtype == torch.float32 and tuple(out.shape) == (1, 3, 3, 4 * h, 4 * w)
        assert_close(out, ref, rel=2e-3 if max(h, w) > tile else 1e-4)

    def test_tiles_are_rounded_to_f16(self, tiny):
        """Away from the seams (weight 1) the blend is the f16-rounded tile."""
        _, pm = tiny
        z = torch.from_numpy(normal(1, 4, 2, 10, 14, seed=3))
        with torch.no_grad():
            out = decode_tiled_3d(pm.decode, z, 4, tile=4)
            first = pm.decode(z[..., :4, :4])
        core = out[..., :8, :8]  # the first tile's pixels before the first seam ramp
        assert torch.equal(core, first[..., :8, :8].half().float())
        assert not torch.equal(core, first[..., :8, :8])

    @pytest.mark.parametrize("h,w", [(10, 14), (8, 21)])
    def test_weights_sum_to_one(self, h, w):
        """With a decoder that agrees with itself across tiles (a nearest
        upsample), the ramp blend gives back the whole decode: the seam
        weights sum to one everywhere."""
        def upsample(z):
            return z.repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1)

        z = torch.from_numpy(normal(1, 3, 2, h, w, seed=4)).half().float()  # exact in f16
        out = decode_tiled_3d(upsample, z, 4, tile=4)
        torch.testing.assert_close(out, upsample(z), atol=1e-6, rtol=1e-6)


class TestTAE:
    @pytest.fixture(scope="class")
    def pair(self):
        jm = jax_build(lambda: JaxTAE(JaxTAEConfig(**TAE), rngs=nnx.Rngs(0)))
        return jm, port_from_jax(lambda: TAEVAE(TAEConfig(**TAE)), jm)

    def test_decode_matches_jax(self, pair):
        jm, pm = pair
        z = normal(2, 4, 3, 4, 5, seed=5)
        ref = jitted("decode")(jm, jnp.asarray(z))
        with torch.no_grad():
            out = pm.decode(torch.from_numpy(z))
        # 4(T−1)+1 frames, 8× space, clamped to [-1, 1] ("sym")
        assert tuple(out.shape) == (2, 3, 9, 32, 40) and pm.frames_to_trim == 3
        assert out.abs().max() <= 1.0
        assert_close(out, ref)

    def test_denormalize_matches_jax(self, pair):
        jm, pm = pair
        z = normal(1, 4, 2, 3, 3, seed=6)
        assert_close(pm._denormalize(torch.from_numpy(z)), jm._denormalize(jnp.asarray(z)), rel=1e-6)

    def test_encode_matches_jax(self, pair):
        """Seven frames pad at the end to eight by repeating the last."""
        jm, pm = pair
        video = np.tanh(normal(1, 3, 7, 16, 24, seed=7))
        ref = jitted("encode")(jm, jnp.asarray(video))
        with torch.no_grad():
            out = pm.encode(torch.from_numpy(video))
        assert tuple(out.shape) == (1, 4, 2, 2, 3)
        assert_close(out, ref)

    @pytest.mark.parametrize("overrides", [dict(out_range="unit", act="relu"), dict(patch_size=2)],
                             ids=["unit_range_relu", "patch_2"])
    def test_variants_match_jax(self, overrides):
        cfg = {**TAE, **overrides}
        jm = jax_build(lambda: JaxTAE(JaxTAEConfig(**cfg), rngs=nnx.Rngs(1)), seed=1)
        pm = port_from_jax(lambda: TAEVAE(TAEConfig(**cfg)), jm)
        z = normal(1, 4, 2, 3, 4, seed=8)
        with torch.no_grad():
            assert_close(pm.decode(torch.from_numpy(z)), jitted("decode")(jm, jnp.asarray(z)))
