"""The port's HunyuanVideo 1.5 encoders against the JAX package's, on the CPU in
f32, with weights carried from the JAX modules: Qwen2.5-VL's text path (GQA,
causal + padding mask, ``num_hidden_layers_to_skip``), byT5 through the T5
stack, the SigLIP vision tower with its preprocessing, the rotate-half RoPE
and SwiGLU they use, and how ``text_encoder.py`` routes a Qwen2.5-VL
component. Tolerance: max|Δ| ≤ 1e-4·max|ref|; preprocessing bit-equal (both
packages resize through OpenCV).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.models.layers import SwiGLU as JaxSwiGLU
from apex_studio_tpu.models.text_encoders.qwen2 import Qwen2Config as JaxQwenConfig
from apex_studio_tpu.models.text_encoders.qwen2 import Qwen2TextEncoder as JaxQwen
from apex_studio_tpu.models.text_encoders.siglip import SiglipVisionConfig as JaxSiglipConfig
from apex_studio_tpu.models.text_encoders.siglip import SiglipVisionEncoder as JaxSiglip
from apex_studio_tpu.models.text_encoders.siglip import preprocess_siglip_image as jax_preprocess
from apex_studio_tpu.models.text_encoders.t5 import T5Config as JaxT5Config
from apex_studio_tpu.models.text_encoders.t5 import T5Encoder as JaxT5
from apex_studio_tpu.ops.rope import apply_rope_half as jax_rope_half
from apex_studio_tpu.ops.rope import rope_freqs_1d as jax_rope_freqs
from apex_studio_tpu.text_encoder import TextEncoder as JaxTextEncoder
from apex_studio_tpu_torch.loaders.converters import convert_keys
from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict
from apex_studio_tpu_torch.models.layers import SwiGLU
from apex_studio_tpu_torch.models.text_encoders.qwen2 import Qwen2Config, Qwen2TextEncoder
from apex_studio_tpu_torch.models.text_encoders.siglip import (
    SiglipVisionConfig,
    SiglipVisionEncoder,
    preprocess_siglip_image,
)
from apex_studio_tpu_torch.models.text_encoders.t5 import T5Config, T5Encoder
from apex_studio_tpu_torch.ops.rope import apply_rope_half, rope_freqs_1d
from apex_studio_tpu_torch.text_encoder import TextEncoder
from tests.torch_port_helpers import assert_close, jax_params, port_from_jax

F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32, rngs=nnx.Rngs(0))
# tests/test_models_hyv15.py's tiny Qwen2: 3 layers, 4 query heads sharing 2 KV heads
QWEN = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2)
# byT5-small's shape, cut: gated-GELU FFN, relative position buckets, 6 heads
BYT5 = dict(vocab_size=384, d_model=24, d_kv=4, d_ff=40, num_layers=2, num_heads=6)
SIGLIP = dict(hidden_size=32, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
              image_size=44, patch_size=14)


def ids_and_mask(vocab, seq=10):
    rng = np.random.default_rng(0)
    ids = rng.integers(1, vocab, size=(2, seq)).astype(np.int32)
    mask = np.ones((2, seq), np.int32)
    mask[1, 6:] = 0  # the second prompt is padded
    ids[1, 6:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def qwen_pair():
    jm = JaxQwen(JaxQwenConfig(**QWEN), **F32)
    pm = port_from_jax(lambda: Qwen2TextEncoder(Qwen2Config(**QWEN), dtype=torch.float32), jm)
    return jm, pm


class TestQwen2:
    @pytest.mark.parametrize("skip", [0, 2])
    @pytest.mark.parametrize("normalize_last", [False, True])
    def test_hidden_states_match_jax(self, qwen_pair, skip, normalize_last):
        jm, pm = qwen_pair
        ids, mask = ids_and_mask(QWEN["vocab_size"])
        ref = jm(jnp.asarray(ids), attention_mask=jnp.asarray(mask), num_hidden_layers_to_skip=skip,
                 normalize_last=normalize_last)
        with torch.no_grad():
            out = pm(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask),
                     num_hidden_layers_to_skip=skip, normalize_last=normalize_last)
        assert_close(out, ref)

    def test_skip_two_runs_all_but_the_last_layer(self, qwen_pair):
        """skip 2 is HF ``hidden_states[-3]``: the first n − 1 layers (27 of 28
        at 7B), so dropping the last layer changes nothing."""
        _, pm = qwen_pair
        ids, mask = ids_and_mask(QWEN["vocab_size"])
        args = (torch.from_numpy(ids).long(),)
        with torch.no_grad():
            skipped = pm(*args, attention_mask=torch.from_numpy(mask), num_hidden_layers_to_skip=2)
            last = pm.layers[-1]
            pm.layers = pm.layers[:-1]
            try:
                shorter = pm(*args, attention_mask=torch.from_numpy(mask))
            finally:
                pm.layers.append(last)
        assert torch.equal(skipped, shorter)

    def test_gqa_repeats_kv_heads(self, qwen_pair):
        _, pm = qwen_pair
        attn = pm.layers[0].self_attn
        assert (attn.heads, attn.kv_heads) == (4, 2)
        assert tuple(attn.k_proj.weight.shape) == (2 * 8, 32)

    def test_text_config_nesting(self):
        cfg = Qwen2Config.from_dict({"text_config": {"hidden_size": 16, "num_hidden_layers": 1}})
        assert cfg.hidden_size == 16 and cfg.num_hidden_layers == 1

    def test_published_naming_loads_through_the_qwen2_converter(self, qwen_pair, tmp_path):
        """A Qwen2.5-VL checkpoint in its published naming (language model
        under ``model.``, a vision tower and ``lm_head`` beside it) loads
        strictly through the ``qwen2`` converter that ``text_encoder.py``
        routes a ``Qwen2_5_VLForConditionalGeneration`` base to."""
        jm, pm = qwen_pair
        sd = {}
        for key, value in pm.state_dict().items():
            name = {"embed_tokens": "embed_tokens.weight"}.get(key, key)
            for port, hf in (("mlp.w1.", "mlp.gate_proj."), ("mlp.w3.", "mlp.up_proj."),
                             ("mlp.w2.", "mlp.down_proj.")):
                name = name.replace(port, hf)
            sd["model." + name] = value.clone()
        sd["lm_head.weight"] = torch.zeros(1)
        sd["visual.blocks.0.attn.qkv.weight"] = torch.zeros(1)
        with torch.device("meta"):
            loaded = Qwen2TextEncoder(Qwen2Config(**QWEN), dtype=torch.float32)
        apply_state_dict(loaded, convert_keys("qwen2", sd), device="cpu", strict=True)
        for key, value in pm.state_dict().items():
            assert torch.equal(loaded.state_dict()[key], value), key


class TestTextEncoderRouting:
    class _Engine:
        components_root = None

    def test_qwen25vl_routes_to_qwen2(self):
        """The port maps a ``Qwen2_5_VL…`` base to the ``qwen2`` family and
        converter. The JAX package lower-cases the base name instead, which
        names no converter, so it would apply a published Qwen2.5-VL file with
        its keys unconverted."""
        spec = {"base": "Qwen2_5_VLForConditionalGeneration"}
        assert TextEncoder(self._Engine(), spec)._converter_family() == "qwen2"
        assert JaxTextEncoder(self._Engine(), spec)._converter_family() == "qwen2_5_vlforconditionalgeneration"
        for base, family in (("T5EncoderModel", "t5"), ("CLIPTextModel", "clip")):
            assert TextEncoder(self._Engine(), {"base": base})._converter_family() == family
            assert JaxTextEncoder(self._Engine(), {"base": base})._converter_family() == family

    def test_tokenize_with_crop_matches_jax(self):
        from apex_studio_tpu_torch.engine.hunyuanvideo15 import mllm_text
        from tests.test_engine_zimage import make_tokenizer

        spec = {"base": "Qwen2_5_VLForConditionalGeneration", "tokenizer": make_tokenizer()}
        text = mllm_text('a sign that reads "OPEN"')
        ids, mask = TextEncoder(self._Engine(), spec).tokenize([text], 1000 + 108)
        ref_ids, ref_mask = JaxTextEncoder(self._Engine(), spec).tokenize([text], 1000 + 108)
        assert ids.shape == (1, 1108)
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(mask, ref_mask)


class TestByT5:
    def test_encoder_matches_jax(self):
        jm = JaxT5(JaxT5Config(**BYT5), **F32)
        pm = port_from_jax(lambda: T5Encoder(T5Config(**BYT5), dtype=torch.float32), jm)
        ids, mask = ids_and_mask(BYT5["vocab_size"], seq=16)
        ref = jm(jnp.asarray(ids), attention_mask=jnp.asarray(mask))
        with torch.no_grad():
            out = pm(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))
        assert tuple(out.shape) == (2, 16, 24)
        assert_close(out, ref)


class TestSiglip:
    def test_preprocess_matches_jax(self):
        img = np.random.default_rng(3).integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
        out = preprocess_siglip_image(img, 44)
        assert out.shape == (1, 3, 44, 44) and out.dtype == np.float32
        np.testing.assert_array_equal(out, jax_preprocess(img, 44))

    def test_vision_tower_matches_jax(self):
        """44 px at patch 14 is 3×3 patches: the strided conv's 2 remainder
        rows and columns are cropped, as torch's Conv2d drops them."""
        jm = JaxSiglip(JaxSiglipConfig(**SIGLIP), **F32)
        pm = port_from_jax(lambda: SiglipVisionEncoder(SiglipVisionConfig(**SIGLIP), dtype=torch.float32), jm)
        img = np.random.default_rng(4).integers(0, 256, size=(40, 60, 3), dtype=np.uint8)
        px = np.concatenate([preprocess_siglip_image(img, 44), preprocess_siglip_image(img[::-1], 44)])
        ref = jm(jnp.asarray(px))
        with torch.no_grad():
            out = pm(torch.from_numpy(px))
        assert tuple(out.shape) == (2, 9, 32)
        assert_close(out, ref)

    def test_tower_attention_takes_the_plain_route(self, monkeypatch):
        """so400m's 16 heads of 72 are not a head dim of the flash kernel (its
        dispatch raises for them on the card: tests/test_torch_cuda.py); the
        tower's attention is the plain route, as the JAX module's is XLA."""
        import importlib

        attention = importlib.import_module("apex_studio_tpu_torch.ops.attention")

        def refuse(*a, **k):
            raise AssertionError("SigLIP reached the flash backend")

        monkeypatch.setitem(attention.attention_registry._entries, "flash", refuse)
        cfg = SiglipVisionConfig()
        assert cfg.hidden_size // cfg.num_attention_heads == 72
        pm = port_from_jax(lambda: SiglipVisionEncoder(SiglipVisionConfig(**SIGLIP), dtype=torch.float32),
                           JaxSiglip(JaxSiglipConfig(**SIGLIP), **F32))
        with torch.no_grad():
            assert torch.isfinite(pm(torch.zeros(1, 3, 44, 44))).all()


class TestRopeHalfAndSwiGLU:
    def test_rope_half_matches_jax(self):
        rng = np.random.default_rng(5)
        x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
        cos, sin = rope_freqs_1d(np.arange(7)[None], 16, 1e6)
        jc, js = jax_rope_freqs(np.arange(7)[None], 16, 1e6)
        np.testing.assert_array_equal(cos, jc)
        out = apply_rope_half(torch.from_numpy(x), torch.from_numpy(cos)[:, :, None], torch.from_numpy(sin)[:, :, None])
        assert_close(out, jax_rope_half(jnp.asarray(x), jc[:, :, None], js[:, :, None]), rel=1e-6)

    def test_swiglu_matches_jax(self):
        jm = JaxSwiGLU(12, 20, **F32)
        pm = port_from_jax(lambda: SwiGLU(12, 20, dtype=torch.float32), jm)
        x = np.random.default_rng(6).normal(size=(3, 5, 12)).astype(np.float32)
        with torch.no_grad():
            assert_close(pm(torch.from_numpy(x)), jm(jnp.asarray(x)))
        assert set(jax_params(jm)) == {"w1.kernel", "w2.kernel", "w3.kernel"}
