"""The port's checkpoint loaders against the JAX package's, on the CPU.

Each family's tiny module is written to disk in its published key naming
(``loaders/export.py``), then loaded twice from the same file: by the JAX
package (its safetensors reader, converters and ``apply_state_dict``) and by
the port (built on ``meta``, filled tensor by tensor). Both run the same numpy
inputs in f32: max|Δ| ≤ 1e-4·max|ref|. Loaded parameters equal what was
written bit for bit. The port's safetensors reader needs neither ``ml_dtypes``
nor the ``safetensors`` package.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from apex_studio_tpu.loaders import converters as jax_converters
from apex_studio_tpu.loaders import safetensors_io as jax_io
from apex_studio_tpu.loaders.state_mapping import apply_state_dict as jax_apply_state_dict
from apex_studio_tpu.models.text_encoders.clip import CLIPTextConfig as JaxCLIPConfig
from apex_studio_tpu.models.text_encoders.clip import CLIPTextEncoder as JaxCLIP
from apex_studio_tpu.models.text_encoders.t5 import T5Config as JaxT5Config
from apex_studio_tpu.models.text_encoders.t5 import T5Encoder as JaxT5
from apex_studio_tpu.models.transformers.flux import FluxConfig as JaxFluxConfig
from apex_studio_tpu.models.transformers.flux import FluxTransformer2DModel as JaxFlux
from apex_studio_tpu.models.vaes.autoencoder_kl import AutoencoderKL as JaxVAE
from apex_studio_tpu.models.vaes.autoencoder_kl import AutoencoderKLConfig as JaxVAEConfig
from apex_studio_tpu.models.transformers.hunyuanvideo15 import HYV15Config as JaxHYV15Config
from apex_studio_tpu.models.transformers.hunyuanvideo15 import HunyuanVideo15Transformer3DModel as JaxHYV15
from apex_studio_tpu.models.vaes.hunyuanvideo15_vae import AutoencoderKLHunyuanVideo15 as JaxHYV15VAE
from apex_studio_tpu.models.vaes.hunyuanvideo15_vae import HYV15VAEConfig as JaxHYV15VAEConfig
from apex_studio_tpu.models.vaes.tae_vae import TAEVAE as JaxTAE
from apex_studio_tpu.models.vaes.tae_vae import TAEConfig as JaxTAEConfig
from apex_studio_tpu.models.text_encoders.qwen3 import Qwen3Config as JaxQwen3Config
from apex_studio_tpu.models.text_encoders.qwen3 import Qwen3TextEncoder as JaxQwen3
from apex_studio_tpu.models.transformers import qwenimage as jax_qwenimage
from apex_studio_tpu.models.transformers import zimage as jax_zimage
from apex_studio_tpu.models.transformers import wan as jax_wan
from apex_studio_tpu.models.transformers import flux2 as jax_flux2
from apex_studio_tpu.models.text_encoders import llama as jax_llama
from apex_studio_tpu.models.vaes.wan_vae import AutoencoderKLWan as JaxWanVAE
from apex_studio_tpu.models.vaes.wan_vae import WanVAEConfig as JaxWanVAEConfig
from apex_studio_tpu.quantize.writers import write_gguf
from apex_studio_tpu_torch.engine.base import materialize_random
from apex_studio_tpu_torch.loaders import converters, safetensors_io
from apex_studio_tpu_torch.loaders.export import flux_bfl_state_dict, published_state_dict
from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict
from apex_studio_tpu_torch.models.text_encoders.clip import CLIPTextConfig, CLIPTextEncoder
from apex_studio_tpu_torch.models.text_encoders.t5 import T5Config, T5Encoder
from apex_studio_tpu_torch.models.transformers.flux import FluxConfig, FluxTransformer2DModel
from apex_studio_tpu_torch.models.transformers.hunyuanvideo15 import HunyuanVideo15Transformer3DModel, HYV15Config
from apex_studio_tpu_torch.models.vaes.autoencoder_kl import AutoencoderKL, AutoencoderKLConfig
from apex_studio_tpu_torch.models.vaes.hunyuanvideo15_vae import AutoencoderKLHunyuanVideo15, HYV15VAEConfig
from apex_studio_tpu_torch.models.vaes.tae_vae import TAEVAE, TAEConfig
from apex_studio_tpu_torch.models.text_encoders.qwen3 import Qwen3Config, Qwen3TextEncoder
from apex_studio_tpu_torch.models.transformers import flux2, qwenimage, wan, zimage
from apex_studio_tpu_torch.models.text_encoders import llama
from apex_studio_tpu_torch.models.vaes.wan_vae import AutoencoderKLWan, WanVAEConfig
from apex_studio_tpu_torch.quantize.gguf import load_gguf_state_dict
from tests.torch_port_helpers import assert_close

REPO = Path(__file__).resolve().parents[1]
def f32():
    """f32 JAX build arguments with a fresh ``Rngs`` each build."""
    return dict(dtype=jnp.float32, param_dtype=jnp.float32, rngs=nnx.Rngs(0))
FLUX = dict(in_channels=16, out_channels=16, num_layers=2, num_single_layers=2,
            attention_head_dim=32, num_attention_heads=2, joint_attention_dim=48,
            pooled_projection_dim=24, axes_dims_rope=(8, 12, 12))
CLIP = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, max_position_embeddings=16)
T5 = dict(vocab_size=64, d_model=48, d_kv=8, d_ff=64, num_layers=2, num_heads=4)
UMT5 = dict(T5, per_layer_relative_bias=True)  # a relative-position table in every layer
VAE = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4,
           scaling_factor=0.5, shift_factor=0.1)
HYV15 = dict(in_channels=9, out_channels=4, num_attention_heads=2, attention_head_dim=32, num_layers=2,
             num_refiner_layers=2, mlp_ratio=2.0, text_embed_dim=32, text_embed_2_dim=16,
             image_embed_dim=16, rope_axes_dim=(8, 12, 12))
HYV15_VAE = dict(latent_channels=4, block_out_channels=(8, 16, 32), layers_per_block=1,
                 spatial_compression_ratio=4, temporal_compression_ratio=2, scaling_factor=1.03682)
TAE = dict(latent_channels=4, channels=(8, 8, 8, 8), act="leaky_relu", out_range="sym")
ZIMAGE = dict(dim=64, n_layers=2, n_refiner_layers=1, n_heads=2, n_kv_heads=2, in_channels=4,
              cap_feat_dim=48, axes_dims=(8, 12, 12), axes_lens=(64, 32, 32))
ZIMAGE_CONTROL = dict(ZIMAGE, control_layers_places=(0,), control_refiner_layers_places=(0,), control_in_dim=9)
QWENIMAGE = dict(in_channels=16, out_channels=4, num_layers=2, attention_head_dim=16, num_attention_heads=2,
                 joint_attention_dim=32, axes_dims_rope=(4, 6, 6))
# QwenImage's VAE layout at small widths, with an attention block in the encoder
WAN_VAE = dict(base_dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1, temperal_downsample=(False, True),
               attn_scales=(0.5,), latents_mean=(0.1, -0.2, 0.0, 0.3), latents_std=(1.5, 0.5, 1.0, 2.0))
WAN = dict(num_attention_heads=2, attention_head_dim=16, in_channels=4, out_channels=4, text_dim=24,
           freq_dim=16, ffn_dim=48, num_layers=2)
QWEN3 = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16)
FLUX2 = dict(in_channels=16, num_layers=2, num_single_layers=2, attention_head_dim=16, num_attention_heads=2,
             joint_attention_dim=48, mlp_ratio=2.0, axes_dims_rope=(4, 4, 4, 4))
FLUX2_CONTROL = dict(FLUX2, control_layers=(0, 1), control_in_dim=36)
FLUX2_VAE = dict(VAE, scaling_factor=1.0, shift_factor=None, use_quant_conv=True, use_post_quant_conv=True,
                 packed_batch_norm=True)
LLAMA = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=8, stack_layers=(1, 2))


# -- safetensors ---------------------------------------------------------------------------


def sample_tensors():
    rng = np.random.default_rng(0)
    f32 = torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32))
    return {
        "a.f32": f32,
        "b.bf16": f32.to(torch.bfloat16),
        "c.f16": f32.to(torch.float16),
        "d.i8": torch.from_numpy(rng.integers(-100, 100, size=(3, 4), dtype=np.int8)),
        "e.odd_u8": torch.arange(5, dtype=torch.uint8),  # leaves the next payload unaligned
        "f.i64": torch.arange(6).reshape(2, 3),
        "g.scalar": torch.tensor(2.5),
        "h.empty": torch.zeros(0, 4),
    }


class TestSafetensors:
    def test_round_trip_keeps_dtype_shape_and_bits(self, tmp_path):
        tensors = sample_tensors()
        safetensors_io.save_safetensors(tmp_path / "x.safetensors", tensors, metadata={"format": "pt"})
        back = safetensors_io.load_safetensors(tmp_path / "x.safetensors")
        assert sorted(back) == sorted(tensors)
        assert sorted(safetensors_io.safetensors_keys(tmp_path / "x.safetensors")) == sorted(tensors)
        for k, t in tensors.items():
            assert back[k].dtype == t.dtype and back[k].shape == t.shape and back[k].device.type == "cpu"
            assert torch.equal(back[k], t), k

    def test_reads_what_the_jax_package_writes_and_back(self, tmp_path):
        import ml_dtypes  # the JAX package's side only

        rng = np.random.default_rng(1)
        arrays = {"w": rng.normal(size=(4, 6)).astype(np.float32),
                  "h": rng.normal(size=(3, 2)).astype(ml_dtypes.bfloat16),
                  "n": np.arange(7, dtype=np.int32)}
        jax_io.save_safetensors(tmp_path / "j.safetensors", arrays)
        ours = safetensors_io.load_safetensors(tmp_path / "j.safetensors")
        assert ours["h"].dtype == torch.bfloat16
        for k, a in arrays.items():
            np.testing.assert_array_equal(ours[k].float().numpy(), a.astype(np.float32))
        safetensors_io.save_safetensors(tmp_path / "p.safetensors", ours)
        theirs = jax_io.load_safetensors(tmp_path / "p.safetensors")
        for k, a in arrays.items():
            assert theirs[k].dtype == a.dtype
            np.testing.assert_array_equal(np.asarray(theirs[k], np.float32), a.astype(np.float32))

    def test_keys_filter_and_cast(self, tmp_path):
        safetensors_io.save_safetensors(tmp_path / "x.safetensors", sample_tensors())
        got = safetensors_io.load_safetensors(tmp_path / "x.safetensors", keys=["b.bf16"],
                                              dtype=torch.float32)
        assert list(got) == ["b.bf16"] and got["b.bf16"].dtype == torch.float32

    @pytest.mark.parametrize("fp8", [torch.float8_e4m3fn, torch.float8_e5m2], ids=["e4m3", "e5m2"])
    def test_fp8_scaled_dequant_equals_jax(self, fp8, tmp_path):
        rng = np.random.default_rng(2)
        w = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32)).to(fp8)
        sd = {"blk.weight": w, "blk.scale_weight": torch.tensor([0.25]),
              "plain.weight": torch.from_numpy(rng.normal(size=(2, 2)).astype(np.float32)),
              "noscale.weight": w[:2].clone(),
              "fp4.weight": torch.from_numpy(rng.integers(-7, 8, size=(4, 4), dtype=np.int8)),
              "fp4.weight_scale": torch.tensor([[0.5], [1.0], [2.0], [4.0]]),
              "codes.weight": torch.arange(4, dtype=torch.uint8)}
        safetensors_io.save_safetensors(tmp_path / "q.safetensors", sd)
        loaded = safetensors_io.load_safetensors(tmp_path / "q.safetensors")
        assert loaded["blk.weight"].dtype == fp8
        ours = safetensors_io.dequantize_fp8_scaled(loaded)
        ref = jax_io.dequantize_fp8_scaled(jax_io.load_safetensors(tmp_path / "q.safetensors"))
        assert sorted(ours) == sorted(ref) == ["blk.weight", "codes.weight", "fp4.weight",
                                               "noscale.weight", "plain.weight"]
        assert ours["codes.weight"].dtype == torch.uint8  # no scale: passes through
        for k in ours:
            np.testing.assert_array_equal(ours[k].float().numpy(), np.asarray(ref[k], np.float32))
        torch.testing.assert_close(ours["blk.weight"], w.float() * 0.25, rtol=0, atol=0)

    def test_sharded_directory_with_and_without_index(self, tmp_path):
        tensors = sample_tensors()
        names = sorted(tensors)
        shards = {"model-00001-of-00002.safetensors": names[:3], "model-00002-of-00002.safetensors": names[3:]}
        for fname, ks in shards.items():
            safetensors_io.save_safetensors(tmp_path / fname, {k: tensors[k] for k in ks})
        plain = safetensors_io.load_sharded_safetensors(tmp_path)
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
            {"weight_map": {k: f for f, ks in shards.items() for k in ks}}))
        indexed = safetensors_io.load_sharded_safetensors(tmp_path)
        for got in (plain, indexed):
            assert sorted(got) == names and all(torch.equal(got[k], tensors[k]) for k in names)
        with pytest.raises(FileNotFoundError, match="no safetensors"):
            safetensors_io.load_sharded_safetensors(tmp_path / "nothing_here")

    def test_unknown_dtype_is_refused(self, tmp_path):
        hdr = json.dumps({"x": {"dtype": "C64", "shape": [1], "data_offsets": [0, 8]}}).encode()
        (tmp_path / "bad.safetensors").write_bytes(len(hdr).to_bytes(8, "little") + hdr + bytes(8))
        with pytest.raises(ValueError, match="unsupported safetensors dtype"):
            safetensors_io.load_safetensors(tmp_path / "bad.safetensors")

    def test_torch_checkpoint(self, tmp_path):
        sd = {"w": torch.ones(2, 3, dtype=torch.bfloat16), "step": 7}
        torch.save({"state_dict": sd}, tmp_path / "m.ckpt")
        got = safetensors_io.load_torch_checkpoint(tmp_path / "m.ckpt")
        assert list(got) == ["w"] and got["w"].dtype == torch.bfloat16

    def test_needs_neither_ml_dtypes_nor_safetensors(self, tmp_path):
        """In a process where both imports fail, bf16 and fp8 still round-trip."""
        code = (
            "import sys\n"
            "sys.modules['ml_dtypes'] = None; sys.modules['safetensors'] = None\n"
            "import torch\n"
            "from apex_studio_tpu_torch.loaders import safetensors_io as io\n"
            f"p = {str(tmp_path / 'n.safetensors')!r}\n"
            "t = {'b': torch.randn(3, 5).to(torch.bfloat16), 'f': torch.randn(4).to(torch.float8_e4m3fn)}\n"
            "io.save_safetensors(p, t); back = io.load_safetensors(p)\n"
            "assert all(back[k].dtype == t[k].dtype and torch.equal(back[k].float(), t[k].float()) for k in t)\n"
            "print('ok')\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# -- families ------------------------------------------------------------------------------


def run_flux(model, is_jax):
    rng = np.random.default_rng(0)
    args = [rng.normal(size=s).astype(np.float32) for s in ((1, 16, 16), (1, 5, 48), (1, 24))]
    args += [np.array([0.7], np.float32), np.array([3.5], np.float32)]
    if is_jax:
        return model(*map(jnp.asarray, args), grid_hw=(4, 4))
    return model(*map(torch.from_numpy, args), grid_hw=(4, 4))


def run_encoder(model, is_jax):
    ids = np.array([[1, 5, 9, 2, 63, 7, 0, 0]], np.int32)
    mask = np.array([[1, 1, 1, 1, 1, 1, 0, 0]], np.int32)
    if is_jax:
        out = model(jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    else:
        out = model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))
    return out[0] if isinstance(out, tuple) else out


def run_vae(model, is_jax):
    z = np.random.default_rng(0).normal(size=(1, 4, 4, 6)).astype(np.float32)
    return model.decode(jnp.asarray(z)) if is_jax else model.decode(torch.from_numpy(z))


def run_hyv15(model, is_jax):
    rng = np.random.default_rng(0)
    args = [rng.normal(size=(1, 9, 2, 4, 4)), np.array([600.0]), rng.normal(size=(1, 6, 32)),
            np.array([[1, 1, 1, 1, 0, 0]]), rng.normal(size=(1, 3, 16)), np.ones((1, 3)),
            rng.normal(size=(1, 4, 16))]
    args = [a.astype(np.int32 if i in (3, 5) else np.float32) for i, a in enumerate(args)]
    return model(*map(jnp.asarray if is_jax else torch.from_numpy, args))


def run_vae3d(model, is_jax):
    z = np.random.default_rng(0).normal(size=(1, 4, 2, 3, 4)).astype(np.float32)
    return model.decode(jnp.asarray(z)) if is_jax else model.decode(torch.from_numpy(z))


def run_zimage(model, is_jax):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 4, 1, 6, 8)).astype(np.float32)
    t = np.array([0.4], np.float32)
    cap = rng.normal(size=(1, 32, 48)).astype(np.float32)
    mask = np.arange(32)[None] < 19
    kw = {}
    if model.cfg.__class__.__name__ == "ZImageControlConfig":
        cc = rng.normal(size=(1, 9, 1, 6, 8)).astype(np.float32)
        kw = {"control_context": jnp.asarray(cc) if is_jax else torch.from_numpy(cc), "control_context_scale": 0.7}
    if is_jax:
        return model(jnp.asarray(x), jnp.asarray(t), jnp.asarray(cap), jnp.asarray(mask), **kw)
    return model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cap), torch.from_numpy(mask), **kw)


def run_qwenimage(model, is_jax):
    rng = np.random.default_rng(0)
    x, cond = (rng.normal(size=(1, 12, 16)).astype(np.float32) for _ in range(2))
    txt = rng.normal(size=(1, 5, 32)).astype(np.float32)
    t = np.array([0.6], np.float32)
    wrap, stack = (jnp.asarray, jnp.stack) if is_jax else (torch.from_numpy, torch.stack)
    if "ControlNet" in type(model).__name__:
        return stack(model(wrap(x), wrap(cond), wrap(txt), wrap(t), grid_hw=(3, 4), conditioning_scale=0.5))
    return model(wrap(x), wrap(txt), wrap(t), grid_hw=(3, 4))


def run_wan_vae(model, is_jax):
    video = np.random.default_rng(0).normal(size=(1, 3, 1, 16, 16)).astype(np.float32)
    wrap = jnp.asarray if is_jax else torch.from_numpy
    return model.decode(model.encode(wrap(video)))


def run_wan(model, is_jax):
    rng = np.random.default_rng(0)
    args = [rng.normal(size=(1, 4, 2, 4, 6)), np.array([420.0]), rng.normal(size=(1, 5, 24))]
    return model(*(jnp.asarray(a, jnp.float32) if is_jax else torch.from_numpy(a.astype(np.float32))
                   for a in args))


def run_flux2(model, is_jax):
    rng = np.random.default_rng(0)
    args = [rng.normal(size=(1, 12, 16)), rng.normal(size=(1, 5, 48)), np.array([0.6]), np.array([4.0])]
    cc = rng.normal(size=(1, 12, 36))
    wrap = (lambda a: jnp.asarray(a, jnp.float32)) if is_jax else (lambda a: torch.from_numpy(a.astype(np.float32)))
    kw = {"control_context": wrap(cc)} if hasattr(model, "control_img_in") else {}
    return model(*map(wrap, args), grid_hw=(3, 4), **kw)


def run_flux2_vae(model, is_jax):
    """Packed tokens denormalized by the running statistics, unpacked and decoded."""
    tokens = np.random.default_rng(0).normal(size=(1, 6, 16)).astype(np.float32)
    if is_jax:
        z = jax_flux2.Flux2Transformer2DModel.unpack_latents(model.denormalize_packed(jnp.asarray(tokens)), 4, 6)
    else:
        z = flux2.Flux2Transformer2DModel.unpack_latents(model.denormalize_packed(torch.from_numpy(tokens)), 4, 6)
    return model.decode(z)


def zimage_single_file(sd):
    """The Comfy single-file naming under a ``model.diffusion_model.`` prefix,
    which the converter strips."""
    return {"model.diffusion_model." + k: v for k, v in published_state_dict("zimage", sd).items()}


# name: (converter family, port constructor, JAX constructor, exporter, forward)
FAMILIES = {
    "flux_bfl": ("flux", lambda: FluxTransformer2DModel(FluxConfig(**FLUX), dtype=torch.float32),
                 lambda: JaxFlux(JaxFluxConfig(**FLUX), **f32()), flux_bfl_state_dict, run_flux),
    "flux_diffusers": ("flux", lambda: FluxTransformer2DModel(FluxConfig(**FLUX), dtype=torch.float32),
                       lambda: JaxFlux(JaxFluxConfig(**FLUX), **f32()),
                       lambda sd: published_state_dict("flux", sd), run_flux),
    "t5": ("t5", lambda: T5Encoder(T5Config(**T5), dtype=torch.float32),
           lambda: JaxT5(JaxT5Config(**T5), **f32()), lambda sd: published_state_dict("t5", sd), run_encoder),
    "clip": ("clip", lambda: CLIPTextEncoder(CLIPTextConfig(**CLIP), dtype=torch.float32),
             lambda: JaxCLIP(JaxCLIPConfig(**CLIP), **f32()), lambda sd: published_state_dict("clip", sd),
             run_encoder),
    "autoencoder_kl": ("autoencoder_kl", lambda: AutoencoderKL(AutoencoderKLConfig(**VAE), dtype=torch.float32),
                       lambda: JaxVAE(JaxVAEConfig(**VAE), **f32()),
                       lambda sd: published_state_dict("autoencoder_kl", sd), run_vae),
    "hunyuanvideo15": ("hunyuanvideo15",
                       lambda: HunyuanVideo15Transformer3DModel(HYV15Config(**HYV15), dtype=torch.float32),
                       lambda: JaxHYV15(JaxHYV15Config(**HYV15), **f32()),
                       lambda sd: published_state_dict("hunyuanvideo15", sd), run_hyv15),
    "hunyuanvideo15_vae": ("hunyuanvideo15_vae", lambda: AutoencoderKLHunyuanVideo15(HYV15VAEConfig(**HYV15_VAE)),
                           lambda: JaxHYV15VAE(JaxHYV15VAEConfig(**HYV15_VAE), rngs=nnx.Rngs(0)),
                           lambda sd: published_state_dict("hunyuanvideo15_vae", sd), run_vae3d),
    "tae_vae": ("tae_vae", lambda: TAEVAE(TAEConfig(**TAE)), lambda: JaxTAE(JaxTAEConfig(**TAE), rngs=nnx.Rngs(0)),
                lambda sd: published_state_dict("tae_vae", sd), run_vae3d),
    "zimage_single_file": ("zimage", lambda: zimage.ZImageTransformer2DModel(zimage.ZImageConfig(**ZIMAGE),
                                                                             dtype=torch.float32),
                           lambda: jax_zimage.ZImageTransformer2DModel(jax_zimage.ZImageConfig(**ZIMAGE), **f32()),
                           zimage_single_file, run_zimage),
    "zimage_control": ("zimage", lambda: zimage.ZImageControlTransformer2DModel(
                           zimage.ZImageControlConfig(**ZIMAGE_CONTROL), dtype=torch.float32),
                       lambda: jax_zimage.ZImageControlTransformer2DModel(
                           jax_zimage.ZImageControlConfig(**ZIMAGE_CONTROL), **f32()),
                       lambda sd: published_state_dict("zimage", sd), run_zimage),
    "qwenimage": ("qwenimage", lambda: qwenimage.QwenImageTransformer2DModel(
                      qwenimage.QwenImageConfig(**QWENIMAGE), dtype=torch.float32),
                  lambda: jax_qwenimage.QwenImageTransformer2DModel(jax_qwenimage.QwenImageConfig(**QWENIMAGE),
                                                                    **f32()),
                  lambda sd: published_state_dict("qwenimage", sd), run_qwenimage),
    "qwenimage_controlnet": ("qwenimage", lambda: qwenimage.QwenImageControlNetModel(
                                 qwenimage.QwenImageControlNetConfig(**QWENIMAGE), dtype=torch.float32),
                             lambda: jax_qwenimage.QwenImageControlNetModel(
                                 jax_qwenimage.QwenImageControlNetConfig(**QWENIMAGE), **f32()),
                             lambda sd: published_state_dict("qwenimage", sd), run_qwenimage),
    "wan_vae": ("wan_vae", lambda: AutoencoderKLWan(WanVAEConfig(**WAN_VAE)),
                lambda: JaxWanVAE(JaxWanVAEConfig(**WAN_VAE), rngs=nnx.Rngs(0)),
                lambda sd: published_state_dict("wan_vae", sd), run_wan_vae),
    "umt5": ("t5", lambda: T5Encoder(T5Config(**UMT5), dtype=torch.float32),
             lambda: JaxT5(JaxT5Config(**UMT5), **f32()), lambda sd: published_state_dict("t5", sd), run_encoder),
    "wan": ("wan", lambda: wan.WanTransformer3DModel(wan.WanConfig(**WAN), dtype=torch.float32),
            lambda: jax_wan.WanTransformer3DModel(jax_wan.WanConfig(**WAN), **f32()),
            lambda sd: published_state_dict("wan", sd), run_wan),
    "qwen3": ("qwen3", lambda: Qwen3TextEncoder(Qwen3Config(**QWEN3), dtype=torch.float32),
              lambda: JaxQwen3(JaxQwen3Config(**QWEN3), **f32()), lambda sd: published_state_dict("qwen3", sd),
              run_encoder),
    "flux2": ("flux2", lambda: flux2.Flux2Transformer2DModel(flux2.Flux2Config(**FLUX2), dtype=torch.float32),
              lambda: jax_flux2.Flux2Transformer2DModel(jax_flux2.Flux2Config(**FLUX2), **f32()),
              lambda sd: published_state_dict("flux2", sd), run_flux2),
    "flux2_control": ("flux2_control", lambda: flux2.Flux2ControlTransformer2DModel(
                          flux2.Flux2ControlConfig(**FLUX2_CONTROL), dtype=torch.float32),
                      lambda: jax_flux2.Flux2ControlTransformer2DModel(jax_flux2.Flux2ControlConfig(**FLUX2_CONTROL),
                                                                       **f32()),
                      lambda sd: published_state_dict("flux2", sd), run_flux2),
    "flux2_vae": ("flux2_vae", lambda: AutoencoderKL(AutoencoderKLConfig(**FLUX2_VAE), dtype=torch.float32),
                  lambda: JaxVAE(JaxVAEConfig(**FLUX2_VAE), **f32()),
                  lambda sd: published_state_dict("flux2_vae", sd), run_flux2_vae),
    "llama": ("llama", lambda: llama.LlamaTextEncoder(llama.LlamaConfig(**LLAMA), dtype=torch.float32),
              lambda: jax_llama.LlamaTextEncoder(jax_llama.LlamaConfig(**LLAMA), **f32()),
              lambda sd: published_state_dict("llama", sd), run_encoder),
}


def meta(build):
    with torch.device("meta"):
        return build()


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request, tmp_path_factory):
    """The source module (random, seeded), its checkpoint file, and the port
    module loaded back from that file."""
    fam, build, build_jax, export, forward = FAMILIES[request.param]
    source = materialize_random(build, torch.device("cpu"), seed=3, std=0.1)
    if getattr(source, "bn_var", None) is not None:  # a variance, drawn like a weight
        source.bn_var.data.abs_()
    path = tmp_path_factory.mktemp(request.param) / "model.safetensors"
    safetensors_io.save_safetensors(path, export(source.state_dict()))
    loaded = meta(build)
    mapped = converters.convert_keys(fam, safetensors_io.load_safetensors(path))
    missing, unexpected = apply_state_dict(loaded, mapped, device="cpu", strict=True)
    assert not missing and not unexpected
    return request.param, source, path, loaded.eval()


class TestFamilies:
    def test_published_names(self, family):
        name, _, path, _ = family
        keys = safetensors_io.safetensors_keys(path)
        marker = {"flux_bfl": "model.diffusion_model.double_blocks.0.img_attn.qkv.weight",
                  "flux_diffusers": "transformer_blocks.0.ff_context.net.0.proj.weight",
                  "t5": "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
                  "clip": "text_model.encoder.layers.1.self_attn.out_proj.bias",
                  "autoencoder_kl": "decoder.mid_block.attentions.0.to_out.0.weight",
                  "hunyuanvideo15": "context_embedder.token_refiner.refiner_blocks.1.attn.to_out.0.weight",
                  "hunyuanvideo15_vae": "decoder.up_blocks.0.upsamplers.0.conv.conv.weight",
                  "tae_vae": "decoder.3.conv.4.weight",
                  "zimage_single_file": "model.diffusion_model.all_final_layer.2-1.adaLN_modulation.1.weight",
                  "zimage_control": "control_noise_refiner.0.adaLN_modulation.0.weight",
                  "qwen3": "model.layers.1.mlp.gate_proj.weight",
                  "qwenimage": "transformer_blocks.1.attn.norm_added_k.weight",
                  "qwenimage_controlnet": "controlnet_blocks.1.weight",
                  "wan_vae": "decoder.up_blocks.0.upsamplers.0.resample.1.weight",
                  "umt5": "encoder.block.1.layer.0.SelfAttention.relative_attention_bias.weight",
                  "wan": "condition_embedder.time_embedder.linear_2.weight",
                  "flux2": "single_transformer_blocks.1.attn.to_qkv_mlp_proj.weight",
                  "flux2_control": "control_transformer_blocks.0.before_proj.weight",
                  "flux2_vae": "bn.running_var",
                  "llama": "language_model.model.layers.1.mlp.gate_proj.weight"}[name]
        assert marker in keys
        if name == "flux2":  # diffusers' Flux2Transformer2DModel names
            assert {"time_guidance_embed.timestep_embedder.linear_1.weight",
                    "time_guidance_embed.guidance_embedder.linear_2.weight",
                    "double_stream_modulation_txt.linear.weight", "single_stream_modulation.linear.weight",
                    "transformer_blocks.0.attn.to_out.0.weight", "transformer_blocks.0.attn.norm_added_k.weight",
                    "transformer_blocks.1.ff_context.linear_in.weight", "single_transformer_blocks.0.attn.to_out.weight",
                    "single_transformer_blocks.0.attn.norm_q.weight", "norm_out.linear.weight"} <= set(keys)
        if name == "wan":  # the published Conv3d weight [O, C, 1, 2, 2] and diffusers' block names
            assert safetensors_io.load_safetensors(path)["patch_embedding.weight"].shape == (32, 4, 1, 2, 2)
            assert {"blocks.1.attn2.to_out.0.weight", "blocks.1.norm2.bias", "blocks.1.ffn.net.2.weight",
                    "blocks.0.scale_shift_table", "condition_embedder.time_proj.weight"} <= set(keys)

    def test_loaded_parameters_equal_what_was_written(self, family):
        _, source, _, loaded = family
        want, got = source.state_dict(), loaded.state_dict()
        assert sorted(want) == sorted(got)
        assert not any(t.is_meta for t in got.values())
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k

    def test_outputs_equal_the_jax_loader(self, family):
        name, source, path, loaded = family
        fam, _, build_jax, _, forward = FAMILIES[name]
        # built abstractly: the checkpoint fills every parameter, so no
        # initialiser needs to run; the forward runs jitted
        jm = nnx.eval_shape(build_jax)
        mapped = jax_converters.convert_keys(fam, jax_io.load_safetensors(path))
        jax_apply_state_dict(jm, mapped, strict=True)
        ref = np.asarray(nnx.jit(lambda m: forward(m, True))(jm))
        with torch.inference_mode():
            out, direct = forward(loaded, False), forward(source, False)
        assert torch.equal(out, direct)  # the loaded module is the written module
        assert_close(out, ref)

    def test_converted_keys_equal_jax(self, family):
        name, _, path, _ = family
        fam = FAMILIES[name][0]
        ours = converters.convert_keys(fam, safetensors_io.load_safetensors(path))
        ref = jax_converters.convert_keys(fam, jax_io.load_safetensors(path))
        assert sorted(ours) == sorted(ref)
        for k in ours:
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


class TestHYV15EngineLoad:
    """The tiny HunyuanVideo 1.5 DiT and VAE written by ``export.py`` in their
    published naming and read back by the engine from the manifest's
    ``model_path`` (converter, strict apply onto a ``meta``-built module):
    every tensor bit-equal to what was written."""

    def test_engine_loads_what_was_written(self, tmp_path, monkeypatch):
        import copy

        import yaml

        from apex_studio_tpu_torch.engine import UniversalEngine
        from tests.test_engine_hyv15 import HYV_TINY

        doc = copy.deepcopy(HYV_TINY)
        written = {}
        for comp in doc["spec"]["components"]:
            if comp["type"] == "transformer":
                cfg, fam = HYV15Config.from_dict(comp["config"]), "hunyuanvideo15"
                source = materialize_random(lambda: HunyuanVideo15Transformer3DModel(cfg, dtype=torch.float32),
                                            torch.device("cpu"), seed=5, std=0.1)
            elif comp["type"] == "vae":
                cfg, fam = HYV15VAEConfig.from_dict(comp["config"]), "hunyuanvideo15_vae"
                source = materialize_random(lambda: AutoencoderKLHunyuanVideo15(cfg), torch.device("cpu"),
                                            seed=6, std=0.1)
            else:
                continue
            comp["precision"] = "fp32"
            comp["model_path"] = f"hyv15-tiny/{comp['type']}.safetensors"
            path = tmp_path / "components" / comp["model_path"]
            path.parent.mkdir(parents=True, exist_ok=True)
            safetensors_io.save_safetensors(path, published_state_dict(fam, source.state_dict()))
            written[comp["type"]] = source
        (tmp_path / "m.yml").write_text(yaml.safe_dump(doc))
        monkeypatch.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path))
        engine = UniversalEngine(tmp_path / "m.yml", device="cpu")
        for ctype, source in written.items():
            loaded = engine.load_component_by_type(ctype).state_dict()
            want = source.state_dict()
            assert sorted(loaded) == sorted(want)
            for k in want:
                assert loaded[k].dtype == want[k].dtype and torch.equal(loaded[k], want[k]), (ctype, k)


class TestFlux2EngineLoad:
    """FLUX.2's transformer (diffusers naming), VAE (``AutoencoderKLFlux2``,
    with ``bn.running_*``) and Mistral3 text tower (``language_model.model.``,
    a sharded directory) written by ``export.py`` and named by a manifest's
    ``model_path``, with a manifest LoRA in the published PEFT naming (as
    the Turbo manifest names one): both engines load them through their
    converters (strict), merge the LoRA and run the same request; the port's
    VAE and encoder tensors are bit-equal to what was written, all five
    adapters merge, and its latents are within 1e-3·max|ref| of the JAX
    engine's."""

    def test_engines_load_and_agree(self, tmp_path, monkeypatch):
        import copy

        import yaml

        from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
        from apex_studio_tpu_torch.engine import UniversalEngine
        from tests.test_engine_flux2 import FLUX2_TINY
        from tests.test_engine_zimage import make_tokenizer
        from tests.torch_port_helpers import fast_jax_engine

        doc = copy.deepcopy(FLUX2_TINY)
        builds = {
            "transformer": ("flux2", lambda c: flux2.Flux2Transformer2DModel(flux2.Flux2Config.from_dict(c),
                                                                              dtype=torch.float32)),
            "vae": ("flux2_vae", lambda c: AutoencoderKL(AutoencoderKLConfig.from_dict(c), dtype=torch.float32)),
            "text_encoder": ("llama", lambda c: llama.LlamaTextEncoder(llama.LlamaConfig.from_dict(c),
                                                                       dtype=torch.float32)),
        }
        written = {}
        for i, comp in enumerate(doc["spec"]["components"]):
            if comp["type"] not in builds:
                continue
            fam, build = builds[comp["type"]]
            source = materialize_random(lambda: build(comp["config"]), torch.device("cpu"), seed=10 + i, std=0.1)
            if fam == "flux2_vae":
                source.bn_var.data.abs_()
            sd = published_state_dict(fam, source.state_dict())
            comp["precision"] = "fp32"
            if fam == "flux2_vae":
                comp["base"] = "flux2"  # the manifests' name, which both engines route to flux2_vae
            root = tmp_path / "components" / "flux2-tiny" / comp["type"]
            root.mkdir(parents=True)
            names = sorted(sd)
            for j, shard in enumerate((names[::2], names[1::2])):
                safetensors_io.save_safetensors(root / f"model-0000{j + 1}-of-00002.safetensors",
                                                {k: sd[k] for k in shard})
            comp["model_path"] = f"flux2-tiny/{comp['type']}"
            written[comp["type"]] = source
        # a rank-4 PEFT LoRA over the dual block's attention and the single
        # block's fused projections, merged by both engines at load
        rng, lora = np.random.default_rng(0), {}
        d, inner = 32, 64
        for module, (n_in, n_out) in {"transformer_blocks.0.attn.to_q": (d, d),
                                      "transformer_blocks.0.attn.to_out.0": (d, d),
                                      "transformer_blocks.0.attn.add_k_proj": (d, d),
                                      "single_transformer_blocks.0.attn.to_qkv_mlp_proj": (d, 3 * d + 2 * inner),
                                      "single_transformer_blocks.0.attn.to_out": (d + inner, d)}.items():
            lora[f"transformer.{module}.lora_A.weight"] = rng.normal(size=(4, n_in)).astype(np.float32) * 0.3
            lora[f"transformer.{module}.lora_B.weight"] = rng.normal(size=(n_out, 4)).astype(np.float32) * 0.3
        safetensors_io.save_safetensors(tmp_path / "turbo.safetensors", lora)
        doc["spec"]["loras"] = [{"source": str(tmp_path / "turbo.safetensors"), "scale": 0.8}]
        path = tmp_path / "flux2.yml"
        path.write_text(yaml.safe_dump(doc))
        run = dict(prompt="a red kite", height=32, width=32, num_inference_steps=2, seed=3,
                   max_sequence_length=32, return_latents=True)
        monkeypatch.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        monkeypatch.setenv("APEX_COMPONENTS_PATH", str(tmp_path / "components"))
        lats = {}
        for name, make in (("jax", lambda: fast_jax_engine(JaxUniversalEngine(path))),
                           ("port", lambda: UniversalEngine(path, device="cpu"))):
            monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / f"home_{name}"))
            eng = make()
            eng._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
            lats[name] = eng.run(**run)
        assert [(r["applied"], r["skipped"]) for r in eng.lora_results] == [(5, [])]
        for ctype, source in written.items():
            if ctype == "transformer":  # merged with the LoRA
                continue
            got = (eng.text_encoder.model if ctype == "text_encoder" else getattr(eng, ctype)).state_dict()
            want = source.state_dict()
            assert sorted(got) == sorted(want)
            for k in want:
                assert torch.equal(got[k], want[k]), (ctype, k)
        assert_close(lats["port"], np.asarray(lats["jax"]), rel=1e-3)


class TestQwenImageVAERouting:
    """Departure from the JAX engine: its ``_load_vae`` maps a VAE whose base is
    ``qwenimage`` through the DiT's ``qwenimage`` converter (there is no
    ``qwenimage_vae``), which renames none of the Wan VAE's published keys;
    the port routes that VAE to ``wan_vae``."""

    @pytest.fixture(scope="class")
    def written(self, tmp_path_factory):
        import copy

        import yaml

        from tests.test_engine_qwenimage import QWEN_TINY

        tmp = tmp_path_factory.mktemp("qwenimage_vae")
        source = materialize_random(lambda: AutoencoderKLWan(WanVAEConfig(**WAN_VAE)), torch.device("cpu"),
                                    seed=9, std=0.1)
        path = tmp / "components" / "qwen-tiny" / "vae.safetensors"
        path.parent.mkdir(parents=True)
        safetensors_io.save_safetensors(path, published_state_dict("wan_vae", source.state_dict()))
        doc = copy.deepcopy(QWEN_TINY)
        vae = next(c for c in doc["spec"]["components"] if c["type"] == "vae")
        vae.update(base="qwenimage", precision="fp32", model_path="qwen-tiny/vae.safetensors",
                   config={k: list(v) if isinstance(v, tuple) else v for k, v in WAN_VAE.items()})
        (tmp / "qwenimage.yml").write_text(yaml.safe_dump(doc))
        return tmp, source, path

    def test_published_file_keeps_diffusers_shapes(self, written):
        _, source, path = written
        sd = safetensors_io.load_safetensors(path)
        assert tuple(sd["decoder.mid_block.attentions.0.to_qkv.weight"].shape) == (48, 16, 1, 1)
        assert tuple(sd["decoder.mid_block.attentions.0.norm.gamma"].shape) == (16, 1, 1)
        assert tuple(sd["encoder.norm_out.gamma"].shape) == (16, 1, 1, 1)

    def test_engines_pick_their_converters(self, written, monkeypatch):
        from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
        from apex_studio_tpu_torch.engine import UniversalEngine

        tmp, _, _ = written
        monkeypatch.setenv("APEX_HOME_DIR", str(tmp))
        picked = {}
        for name, engine in (("jax", JaxUniversalEngine(tmp / "qwenimage.yml")),
                             ("port", UniversalEngine(tmp / "qwenimage.yml", device="cpu"))):
            monkeypatch.setattr(engine, "_instantiate_family",
                                lambda registry, spec, family, name=name: picked.setdefault(name, family))
            engine._load_vae(engine._spec_for_type("vae"))
        assert picked == {"jax": "qwenimage", "port": "wan_vae"}

    def test_published_file_does_not_load_through_the_dit_converter(self, written):
        _, _, path = written
        with pytest.raises(KeyError, match="not in model"):
            jax_apply_state_dict(nnx.eval_shape(lambda: JaxWanVAE(JaxWanVAEConfig(**WAN_VAE), rngs=nnx.Rngs(0))),
                                 jax_converters.convert_keys("qwenimage", jax_io.load_safetensors(path)),
                                 strict=True)
        with pytest.raises(KeyError, match="not in model"):
            apply_state_dict(meta(lambda: AutoencoderKLWan(WanVAEConfig(**WAN_VAE))),
                             converters.convert_keys("qwenimage", safetensors_io.load_safetensors(path)),
                             device="cpu")

    def test_port_engine_loads_it_strictly(self, written, monkeypatch):
        from apex_studio_tpu_torch.engine import UniversalEngine

        tmp, source, _ = written
        monkeypatch.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        monkeypatch.setenv("APEX_HOME_DIR", str(tmp))
        loaded = UniversalEngine(tmp / "qwenimage.yml", device="cpu").load_component_by_type("vae")
        assert isinstance(loaded, AutoencoderKLWan)
        want, got = source.state_dict(), loaded.state_dict()
        assert sorted(want) == sorted(got)
        for k in want:
            assert torch.equal(got[k], want[k]), k


class TestStrictApply:
    def state(self):
        source = materialize_random(FAMILIES["t5"][1], torch.device("cpu"), seed=1)
        return converters.convert_keys("t5", published_state_dict("t5", source.state_dict()))

    def test_missing_key_raises(self):
        sd = self.state()
        sd.pop("final_layer_norm.weight")
        with pytest.raises(KeyError, match="missing from checkpoint.*final_layer_norm"):
            apply_state_dict(meta(FAMILIES["t5"][1]), sd, device="cpu")

    def test_unexpected_key_raises(self):
        sd = self.state()
        sd["blocks.9.ff.wo.kernel"] = torch.zeros(2, 2)
        with pytest.raises(KeyError, match="not in model.*blocks.9"):
            apply_state_dict(meta(FAMILIES["t5"][1]), sd, device="cpu")

    def test_shape_mismatch_raises(self):
        sd = self.state()
        sd["blocks.0.ff.wo.kernel"] = sd["blocks.0.ff.wo.kernel"].t().contiguous()
        with pytest.raises(ValueError, match="shape mismatch"):
            apply_state_dict(meta(FAMILIES["t5"][1]), sd, device="cpu")

    def test_non_strict_reports(self):
        sd = self.state()
        sd.pop("final_layer_norm.weight")
        sd["extra"] = torch.zeros(1)
        missing, unexpected = apply_state_dict(meta(FAMILIES["t5"][1]), sd, device="cpu", strict=False)
        assert missing == ["final_layer_norm.weight"] and unexpected == ["extra"]

    def test_meta_module_needs_a_device(self):
        with pytest.raises(ValueError, match="device="):
            apply_state_dict(meta(FAMILIES["t5"][1]), self.state())

    def test_casts_to_the_target_dtype_and_copies_in_place(self):
        target = materialize_random(lambda: T5Encoder(T5Config(**T5), dtype=torch.bfloat16),
                                    torch.device("cpu"), seed=2)
        before = target.shared
        sd = self.state()
        apply_state_dict(target, sd)
        assert target.shared is before and target.shared.dtype == torch.bfloat16
        assert torch.equal(target.shared, sd["shared"].to(torch.bfloat16))

    def test_conv_weight_flattens_into_linear(self):
        """[O, C, kh, kw] → the port's Linear [O, C·kh·kw]; the JAX loader makes
        the transpose of the same matrix."""
        from apex_studio_tpu.models.layers import Linear as JaxLinear
        from apex_studio_tpu_torch.models.layers import Linear

        w = np.random.default_rng(0).normal(size=(6, 3, 2, 2)).astype(np.float32)
        lin = meta(lambda: Linear(12, 6, use_bias=False, dtype=torch.float32))
        apply_state_dict(lin, {"kernel": w}, device="cpu")
        jl = JaxLinear(12, 6, use_bias=False, **f32())
        jax_apply_state_dict(jl, {"kernel": w}, strict=False)
        np.testing.assert_array_equal(lin.weight.numpy(), np.asarray(jl.kernel.value).T)

    def test_rank_fix_by_reshape(self):
        from apex_studio_tpu_torch.models.layers import RMSNorm

        norm = meta(lambda: RMSNorm(8))
        apply_state_dict(norm, {"weight": np.arange(8, dtype=np.float32).reshape(8, 1, 1)}, device="cpu")
        assert norm.weight.shape == (8,) and norm.weight[3] == 3


class TestGGUF:
    def test_q8_0_file_loads_like_the_jax_reader(self, tmp_path):
        from apex_studio_tpu.quantize.gguf import load_gguf_state_dict as jax_load_gguf

        rng = np.random.default_rng(0)
        tensors = {"blk.0.weight": rng.normal(size=(8, 64)).astype(np.float32),
                   "blk.0.norm.weight": rng.normal(size=(64,)).astype(np.float32)}
        used = write_gguf(tmp_path / "m.gguf", tensors, qtype="Q8_0", skip_quant=("norm",))
        assert used == {"blk.0.weight": "Q8_0", "blk.0.norm.weight": "F32"}
        ours, ref = load_gguf_state_dict(tmp_path / "m.gguf"), jax_load_gguf(tmp_path / "m.gguf")
        assert sorted(ours) == sorted(ref)
        for k in ours:
            np.testing.assert_array_equal(ours[k], ref[k])
        np.testing.assert_array_equal(ours["blk.0.norm.weight"], tensors["blk.0.norm.weight"])
        assert np.abs(ours["blk.0.weight"] - tensors["blk.0.weight"]).max() < 0.02  # Q8_0 step

    def test_bf16_tensor_without_ml_dtypes(self, tmp_path):
        """A BF16 tensor (ggml type 30) widens to f32 from its bits."""
        import struct

        vals = torch.tensor([1.0, -2.5, 3.140625, 0.0]).to(torch.bfloat16)
        name = b"x"
        with open(tmp_path / "b.gguf", "wb") as f:
            f.write(b"GGUF" + struct.pack("<IQQ", 3, 1, 0))
            f.write(struct.pack("<Q", len(name)) + name + struct.pack("<IQIQ", 1, 4, 30, 0))
            f.write(b"\x00" * ((-f.tell()) % 32))
            f.write(vals.view(torch.uint8).numpy().tobytes())
        got = load_gguf_state_dict(tmp_path / "b.gguf")
        np.testing.assert_array_equal(got["x"], vals.float().numpy())


class TestZImageEngineLoad:
    """The tiny ZImage DiT of tests/test_engine_zimage.py written as the
    manifest's two transformer variants, a Comfy single file (``default``)
    and a GGUF Q8_0 file (``GGUF_Q8_0``, made by the JAX package's writer),
    and read back by both engines: the single file bit-equal to what was
    written, the GGUF file within half a Q8_0 step; the port's forward on
    what it loaded within 1e-4·max|ref| of the JAX engine's."""

    VARIANTS = [{"path": "zimage-tiny/z_image_turbo_bf16.safetensors", "variant": "default",
                 "precision": "bf16", "type": "safetensors"},
                {"path": "zimage-tiny/z_image_turbo-Q8_0.gguf", "variant": "GGUF_Q8_0",
                 "precision": "q8_0", "type": "gguf"}]

    @pytest.fixture(scope="class")
    def written(self, tmp_path_factory):
        import copy

        import yaml

        from tests.test_engine_zimage import TINY_MANIFEST

        tmp = tmp_path_factory.mktemp("zimage_engine_load")
        doc = copy.deepcopy(TINY_MANIFEST)
        comp = next(c for c in doc["spec"]["components"] if c["type"] == "transformer")
        comp.update(precision="fp32", model_path=self.VARIANTS)
        cfg = zimage.ZImageConfig.from_dict(comp["config"])
        source = materialize_random(lambda: zimage.ZImageTransformer2DModel(cfg, dtype=torch.float32),
                                    torch.device("cpu"), seed=8, std=0.1)
        root = tmp / "components" / "zimage-tiny"
        root.mkdir(parents=True)
        safetensors_io.save_safetensors(root / "z_image_turbo_bf16.safetensors",
                                        zimage_single_file(source.state_dict()))
        comfy = published_state_dict("zimage", source.state_dict())
        used = write_gguf(root / "z_image_turbo-Q8_0.gguf", {k: v.numpy() for k, v in comfy.items()},
                          qtype="Q8_0", skip_quant=("norm", "bias", "pad_token"))
        assert "Q8_0" in used.values() and "F32" in used.values()
        (tmp / "zimage.yml").write_text(yaml.safe_dump(doc))
        return tmp, source

    @pytest.mark.parametrize("variant", ["default", "GGUF_Q8_0"])
    def test_engines_load_the_variant(self, written, variant, monkeypatch):
        from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
        from apex_studio_tpu_torch.engine import UniversalEngine

        tmp, source = written
        monkeypatch.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        monkeypatch.setenv("APEX_HOME_DIR", str(tmp))
        selected = {"transformer": {"variant": variant}}
        loaded = UniversalEngine(tmp / "zimage.yml", device="cpu",
                                 selected_components=selected).load_component_by_type("transformer")
        want, got = source.state_dict(), loaded.state_dict()
        assert sorted(want) == sorted(got)
        for k in want:
            if variant == "default" or any(s in k for s in ("norm", "bias", "pad_token")):
                assert torch.equal(got[k], want[k]), k
            else:
                step = float(want[k].abs().max()) / 127
                assert float((got[k] - want[k]).abs().max()) <= 0.6 * step, k
        jm = JaxUniversalEngine(tmp / "zimage.yml", selected_components=selected).load_component_by_type(
            "transformer")
        with torch.inference_mode():
            out = run_zimage(loaded, False)
        assert_close(out, np.asarray(run_zimage(jm, True)))
