"""The port's Wan causal VAE against the JAX package's ``AutoencoderKLWan``, on
the CPU in f32, with weights carried from the JAX module (DHWIO / HWIO kernels
become OIDHW / OIHW, the attention's raw ``[in, out]`` matrices ``[out, in]``).

Configurations: QwenImage's layout at small widths (8× space, 4× time, a
mid-block attention, latent statistics) at T = 1, where every causal conv runs
as its last time tap, and at T = 5, where the time convs of ``downsample3d``
and ``upsample3d`` run; and Wan 2.2's ``is_residual`` + ``patch_size`` 2
layout (avg-pool / duplicate shortcuts, pixel patchify). The JAX modules are
built with seeded numpy values (``jax_build``) and run jitted. Tolerance: rel
L2 ≤ 1e-5 for latents and pixels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.models.vaes.wan_vae import AutoencoderKLWan as JaxWanVAE
from apex_studio_tpu.models.vaes.wan_vae import WanVAEConfig as JaxWanVAEConfig
from apex_studio_tpu_torch.models.registry import _load_builtin_families, vae_registry
from apex_studio_tpu_torch.models.vaes.wan_vae import AutoencoderKLWan, CausalConv3d, WanVAEConfig
from tests.torch_port_helpers import assert_rel_l2, jax_build, port_from_jax

QWEN = dict(base_dim=8, z_dim=4, dim_mult=(1, 2, 2, 2), num_res_blocks=1,
            temperal_downsample=(False, True, True),
            latents_mean=(0.1, -0.2, 0.0, 0.3), latents_std=(1.5, 0.5, 1.0, 2.0))
WAN22 = dict(base_dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1, temperal_downsample=(False, True),
             is_residual=True, patch_size=2)


def pair(cfg):
    jm = jax_build(lambda: JaxWanVAE(JaxWanVAEConfig(**cfg), rngs=nnx.Rngs(0)))
    return jm, port_from_jax(lambda: AutoencoderKLWan(WanVAEConfig(**cfg)), jm)


@pytest.fixture(scope="module")
def qwen():
    return pair(QWEN)


@pytest.fixture(scope="module")
def wan22():
    return pair(WAN22)


def normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name,video_shape,latent_shape", [
    ("qwen", (1, 3, 1, 16, 16), (1, 4, 1, 2, 2)),
    ("qwen", (2, 3, 5, 16, 24), (2, 4, 2, 2, 3)),
    ("wan22", (1, 3, 5, 32, 32), (1, 4, 3, 4, 4)),
], ids=["qwen_t1", "qwen_t5", "wan22_t5"])
def test_encode_decode_match_jax(request, name, video_shape, latent_shape):
    jm, pm = request.getfixturevalue(name)
    video = normal(*video_shape)
    ref_z = nnx.jit(lambda m, v: m.encode(v))(jm, jnp.asarray(video))
    with torch.no_grad():
        z = pm.encode(torch.from_numpy(video))
        assert tuple(z.shape) == latent_shape
        assert_rel_l2(z, ref_z, 1e-5)
        ref = nnx.jit(lambda m, z: m.decode(z))(jm, ref_z)
        out = pm.decode(torch.from_numpy(np.array(ref_z)))
    assert out.shape[:2] == video_shape[:2] and tuple(out.shape[3:]) == video_shape[3:]
    assert_rel_l2(out, ref, 1e-5)


def test_single_frame_conv_is_the_last_time_tap():
    """At T = 1 a causal conv runs as a 2-D conv with its last time tap; the
    full causal conv over the zero-padded frames gives the same values."""
    conv = CausalConv3d(3, 5, dtype=torch.float32)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(normal(5, 3, 3, 3, 3)))
        conv.bias.copy_(torch.from_numpy(normal(5, seed=1)))
        x = torch.from_numpy(normal(2, 3, 1, 6, 7, seed=2))
        full = torch.nn.functional.conv3d(torch.nn.functional.pad(x, (1, 1, 1, 1, 2, 0)), conv.weight, conv.bias)
        assert_rel_l2(conv(x), full.numpy(), 1e-6)


def test_encode_is_causal_in_time(qwen):
    _, pm = qwen
    v1 = torch.zeros(1, 3, 5, 16, 16)
    v2 = v1.clone()
    v2[:, :, 4] = 1.0
    with torch.no_grad():
        z1, z2 = pm.encode(v1), pm.encode(v2)
    assert torch.equal(z1[:, :, 0], z2[:, :, 0])
    assert not torch.equal(z1[:, :, -1], z2[:, :, -1])


def test_config_and_registry():
    cfg = WanVAEConfig.from_dict({"dim": 96, "z_dim": 16, "dim_mult": [1, 2, 4, 4],
                                  "temperal_downsample": [False, True, True], "latents_mean": [0.0] * 16,
                                  "latents_std": [1.0] * 16, "dropout": 0.0})
    assert cfg.base_dim == 96 and cfg.spatial_scale == 8 and cfg.temporal_scale == 4
    assert cfg.latents_mean == (0.0,) * 16
    assert WanVAEConfig(**WAN22).spatial_scale == 8 and WanVAEConfig(**WAN22).pixel_channels == 12
    _load_builtin_families()
    for name in ("wan.base", "wan", "AutoencoderKLWan", "qwenimage", "AutoencoderKLQwenImage"):
        assert vae_registry.get(name) is AutoencoderKLWan
