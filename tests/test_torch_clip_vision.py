"""The port's CLIP vision tower against the JAX package's, on the CPU in f32.

A toy encoder (hidden 64, 2 layers, 4 heads of 16, FFN 96, 28 px in patches
of 14: 4 patches + the class token), built from seeded numpy values
(``jax_build``) and carried with ``loaders/from_jax.py``; JAX jitted. Both
attend causally (the shared ``CLIPLayer`` gets no mask; a fault of the
reference the port mirrors), which the test shows by changing the last
patch and seeing the class token unchanged. Hidden states: rel L2 ≤ 1e-4,
penultimate (Wan's) and final. ``preprocess_clip_image``: equal. The
``clip_vision`` converter: a state dict in transformers' naming (from
``loaders/export.py``) loads back bit-equal, and converts as JAX's converter
does once the ``.mlp.`` level is taken out (JAX keeps it, so it cannot load
a published file).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from apex_studio_tpu.loaders.converters import convert_keys as jax_convert_keys
from apex_studio_tpu.models.text_encoders import clip_vision as jax_cv
from apex_studio_tpu_torch.engine.base import materialize_random
from apex_studio_tpu_torch.loaders.converters import convert_keys
from apex_studio_tpu_torch.loaders.export import published_state_dict
from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict
from apex_studio_tpu_torch.models.registry import _load_builtin_families, text_encoder_registry
from apex_studio_tpu_torch.models.text_encoders import clip_vision
from tests.torch_port_helpers import assert_rel_l2, jax_build, port_from_jax

TOY = dict(hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4, image_size=28,
           patch_size=14)


@pytest.fixture(scope="module")
def models():
    ref = jax_build(lambda: jax_cv.CLIPVisionEncoder(jax_cv.CLIPVisionConfig(**TOY), dtype=jnp.float32,
                                                     param_dtype=jnp.float32, rngs=nnx.Rngs(0)), seed=5)
    port = port_from_jax(lambda: clip_vision.CLIPVisionEncoder(clip_vision.CLIPVisionConfig(**TOY),
                                                               dtype=torch.float32), ref)
    return ref, port


def pixels(seed=0):
    return np.random.default_rng(seed).normal(size=(2, 3, 28, 28)).astype(np.float32)


@pytest.mark.parametrize("penultimate", [True, False], ids=["penultimate", "final"])
def test_forward_matches_jax(models, penultimate):
    ref, port = models
    px = pixels()
    want = nnx.jit(lambda m, p: m(p, penultimate=penultimate))(ref, jnp.asarray(px))
    with torch.no_grad():
        got = port(torch.from_numpy(px), penultimate=penultimate)
    assert tuple(got.shape) == (2, 5, 64)
    assert_rel_l2(got, want, 1e-4)


def test_attention_is_causal_as_in_jax(models):
    """The class token (position 0) sees only itself: a change in the last
    patch leaves it as it was, in both packages."""
    ref, port = models
    a = pixels(1)
    b = a.copy()
    b[:, :, 14:, 14:] += 1.0  # the last of the 4 patches
    with torch.no_grad():
        ga, gb = port(torch.from_numpy(a)), port(torch.from_numpy(b))
    ja, jb = (np.asarray(ref(jnp.asarray(x))) for x in (a, b))
    torch.testing.assert_close(ga[:, :4], gb[:, :4], rtol=0, atol=0)
    np.testing.assert_array_equal(ja[:, :4], jb[:, :4])
    assert (ga[:, 4] - gb[:, 4]).abs().max() > 1e-3


def test_preprocess_matches_jax():
    img = np.random.default_rng(2).integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    got = clip_vision.preprocess_clip_image(img, size=28)
    np.testing.assert_array_equal(got, jax_cv.preprocess_clip_image(img, size=28))
    assert got.shape == (1, 3, 28, 28) and got.dtype == np.float32


def test_converter_round_trip_through_published_names():
    port = materialize_random(lambda: clip_vision.CLIPVisionEncoder(clip_vision.CLIPVisionConfig(**TOY),
                                                                    dtype=torch.float32),
                              torch.device("cpu"), seed=3)
    sd = published_state_dict("clip_vision", port.state_dict())
    assert "vision_model.encoder.layers.1.mlp.fc2.weight" in sd
    assert tuple(sd["vision_model.embeddings.patch_embedding.weight"].shape) == (64, 3, 14, 14)
    sd["vision_model.embeddings.position_ids"] = torch.arange(5)[None]  # dropped, as in published files
    sd["visual_projection.weight"] = torch.zeros(32, 64)
    with torch.device("meta"):
        back = clip_vision.CLIPVisionEncoder(clip_vision.CLIPVisionConfig(**TOY), dtype=torch.float32)
    converted = convert_keys("clip_vision", sd)
    apply_state_dict(back, converted, device="cpu", strict=True)
    for name, value in port.state_dict().items():
        assert torch.equal(back.state_dict()[name], value), name
    # JAX's converter keeps ``.mlp.``; without that level both name every key alike
    flat = {k.replace(".mlp.", "."): v for k, v in sd.items()}
    assert sorted(jax_convert_keys("clip_vision", flat)) == sorted(converted)


def test_registry_names():
    _load_builtin_families()
    for name in ("CLIPVisionModel", "CLIPVisionModelWithProjection", "clip_vision"):
        assert text_encoder_registry.get(name) is clip_vision.CLIPVisionEncoder
    cfg = clip_vision.CLIPVisionConfig.from_dict({"vision_config": {"hidden_size": 1280, "patch_size": 14}})
    assert cfg.num_patches == 256 and clip_vision.CLIPVisionConfig().hidden_size == 1280
