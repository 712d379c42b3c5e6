"""The port's Hugging Face delegates (``depth_hf``: midas, normal_midas, zoe,
depth_anything, zoe_depth_anything; ``segmentation``: segmentation /
uniformer, oneformer), the gated stubs and the registry, against the JAX
package's, on the CPU.

Each delegate's model is built from ``transformers``' config classes at toy
widths (DPT and Depth Anything with 4 layers of 32, ZoeDepth on a 4-layer
BEiT, SegFormer with 2 stages, OneFormer on a 4-stage Swin of width 16 with a
local byte-level CLIP tokenizer and class file) and saved with
``save_pretrained`` to one directory, which both packages get as
``model_name``: their outputs on a 90 × 120 frame are bit-equal (the same
torch models on the same inputs; the port moves them to its ``device``, here
the CPU). The port loads with ``local_files_only`` from that directory, the
preprocessor models dir's ``<name>/`` or ``<Hub id>/``; a name with no local
directory raises ``RuntimeError`` and nothing is fetched. The gated stubs
raise as JAX's, and the registry lists the JAX registry's 54 names in its
order.
"""

import json
import os
import sys

import numpy as np
import pytest

os.environ.setdefault("USE_TF", "0")  # transformers would import TensorFlow (seconds) to save a model

from apex_studio_tpu.preprocess import depth_hf as jax_depth_hf  # noqa: E402
from apex_studio_tpu.preprocess import segmentation as jax_segmentation  # noqa: E402
from apex_studio_tpu_torch.preprocess import depth_hf, preprocessor_registry, run_preprocessor, segmentation  # noqa: E402

FRAME = np.random.default_rng(0).integers(0, 256, (90, 120, 3), dtype=np.uint8)


def clip_tokenizer(path):
    """A byte-level CLIP tokenizer (every byte a token, no merges) written
    as vocab.json / merges.txt: OneFormer's task-text tokenizer."""
    import transformers
    from transformers.models.clip.tokenization_clip import bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": len(chars) + i for i, c in enumerate(chars)})
    vocab.update({"<|startoftext|>": len(vocab), "<|endoftext|>": len(vocab) + 1})
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n")
    return transformers.CLIPTokenizer(str(path / "vocab.json"), str(path / "merges.txt"))


def build_models(root):
    """{kind: directory} of the toy models, each saved with its processor."""
    import torch
    import transformers as T

    torch.manual_seed(0)
    out = {}

    def save(kind, model, processor):
        out[kind] = root / kind
        model.eval().save_pretrained(out[kind])
        processor.save_pretrained(out[kind])

    vit = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=2, intermediate_size=64)
    neck = dict(neck_hidden_sizes=[8, 16, 32, 32], fusion_hidden_size=16)
    save("dpt", T.DPTForDepthEstimation(T.DPTConfig(**vit, **neck, image_size=64, patch_size=16,
                                                    backbone_out_indices=[0, 1, 2, 3])),
         T.DPTImageProcessor(size={"height": 64, "width": 64}, keep_aspect_ratio=False))
    stages = ["stage1", "stage2", "stage3", "stage4"]
    dino = T.Dinov2Config(**vit, image_size=56, patch_size=14, out_features=stages, reshape_hidden_states=False)
    save("depth_anything", T.DepthAnythingForDepthEstimation(T.DepthAnythingConfig(
        backbone_config=dino, reassemble_hidden_size=32, head_hidden_size=8, patch_size=14, **neck)),
         T.DPTImageProcessor(size={"height": 56, "width": 56}, keep_aspect_ratio=False, ensure_multiple_of=14))
    beit = T.BeitConfig(**vit, image_size=64, patch_size=16, out_features=stages, reshape_hidden_states=False,
                        use_relative_position_bias=True)
    bins = [{"n_bins": 8, "min_depth": 1e-3, "max_depth": 10.0, "name": "nyu"},
            {"n_bins": 8, "min_depth": 1e-3, "max_depth": 80.0, "name": "kitti"}]
    save("zoe", T.ZoeDepthForDepthEstimation(T.ZoeDepthConfig(
        backbone_config=beit, bottleneck_features=16, num_attractors=[4, 4, 2, 1], bin_embedding_dim=8,
        num_relative_features=8, bin_configurations=bins, num_patch_transformer_layers=4,
        patch_transformer_hidden_size=128, patch_transformer_intermediate_size=64,
        patch_transformer_num_attention_heads=2, **neck)),
         T.ZoeDepthImageProcessor(size={"height": 64, "width": 64}, keep_aspect_ratio=False))
    save("segformer", T.SegformerForSemanticSegmentation(T.SegformerConfig(
        num_encoder_blocks=2, depths=[1, 1], sr_ratios=[2, 1], hidden_sizes=[16, 32], num_attention_heads=[1, 2],
        patch_sizes=[7, 3], strides=[4, 2], mlp_ratios=[2, 2], decoder_hidden_size=32, num_labels=150)),
         T.SegformerImageProcessor(size={"height": 64, "width": 64}))
    d = root / "oneformer"
    d.mkdir()
    tok = clip_tokenizer(root / "clip_tokenizer")
    classes = {str(i): {"name": f"class_{i}", "isthing": i % 2} for i in range(150)}
    (d / "ade20k_panoptic.json").write_text(json.dumps(classes))
    image_processor = T.OneFormerImageProcessor(
        size={"shortest_edge": 64, "longest_edge": 96}, num_labels=150, repo_path=None,
        class_info_file=str(d / "ade20k_panoptic.json"), num_text=8)
    swin = T.SwinConfig(embed_dim=16, depths=[1, 1, 1, 1], num_heads=[1, 1, 2, 2], window_size=4, image_size=64,
                        out_features=stages)
    save("oneformer", T.OneFormerForUniversalSegmentation(T.OneFormerConfig(
        backbone_config=swin, num_labels=150, num_queries=8, conv_dim=32, mask_dim=32, hidden_dim=32,
        encoder_feedforward_dim=64, encoder_layers=1, decoder_layers=2, num_attention_heads=2, dim_feedforward=64,
        text_encoder_width=32, text_encoder_num_layers=1, text_encoder_vocab_size=len(tok), query_dec_layers=1,
        num_hidden_layers=2, text_encoder_n_ctx=4)),
         T.OneFormerProcessor(image_processor=image_processor, tokenizer=tok))
    return out


@pytest.fixture(scope="module", autouse=True)
def no_stub_modules():
    """An earlier file in the process may have left spec-less stand-in
    modules in ``sys.modules`` (the torch-oracle helper's ``timm``), on which
    ``transformers``' package probes fail: hidden while this file runs."""
    def stand_in(name):  # a top-level module without a spec or a file; it may answer any getattr
        attrs = getattr(sys.modules.get(name), "__dict__", {})
        return name != "__main__" and attrs.get("__spec__", 0) is None and attrs.get("__file__") is None

    with pytest.MonkeyPatch.context() as mp:
        for name in [n for n in sys.modules if stand_in(n.split(".")[0])]:
            mp.delitem(sys.modules, name)
        yield


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return build_models(tmp_path_factory.mktemp("hf_delegates"))


CASES = {  # case: (registry name, model kind, params)
    "midas": ("midas", "dpt", {"detect_resolution": 64}),
    "midas_depth_and_normal": ("midas", "dpt", {"detect_resolution": 64, "depth_and_normal": True}),
    "normal_midas": ("normal_midas", "dpt", {"detect_resolution": 48, "bg_th": 0.2}),
    "zoe": ("zoe", "zoe", {"detect_resolution": 64}),
    "zoe_gamma": ("zoe", "zoe", {"detect_resolution": 64, "gamma_corrected": True}),
    "depth_anything": ("depth_anything", "depth_anything", {"detect_resolution": 56}),
    "zoe_depth_anything": ("zoe_depth_anything", "zoe", {"detect_resolution": 64}),
    "segmentation": ("segmentation", "segformer", {"detect_resolution": 64}),
    "uniformer": ("uniformer", "segformer", {"detect_resolution": 48}),
    "oneformer": ("oneformer", "oneformer", {"detect_resolution": 64}),
}


def jax_class(name):
    from apex_studio_tpu.preprocess import preprocessor_registry as jax_registry

    return jax_registry.get(name)


@pytest.mark.parametrize("case", list(CASES))
def test_delegate_equals_jax(models, case):
    name, kind, params = CASES[case]
    want = jax_class(name)(model_name=str(models[kind]))([FRAME], **params)[0]
    port = preprocessor_registry.get(name)(model_name=str(models[kind]))
    got = port([FRAME], device="cpu", **params)[0]
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (90, 120, 3)
    np.testing.assert_array_equal(got, want)
    assert port._dev.type == "cpu" and next(port._model.parameters()).device.type == "cpu"


def test_delegates_share_the_jax_classes_defaults():
    assert depth_hf.ZoeDepthAnythingPreprocessor.model_name == jax_depth_hf.ZoeDepthAnythingPreprocessor.model_name
    for name in ("midas", "normal_midas", "zoe", "depth_anything", "zoe_depth_anything", "segmentation",
                 "oneformer"):
        port, ref = preprocessor_registry.get(name), jax_class(name)
        assert (port.name, port.model_name, port.params_schema) == (ref.name, ref.model_name, ref.params_schema)
    np.testing.assert_array_equal(segmentation.ade20k_palette(), jax_segmentation.ade20k_palette())
    depth = np.random.default_rng(1).uniform(0, 5, (40, 50)).astype(np.float32)
    np.testing.assert_array_equal(depth_hf.depth_to_normal(depth), jax_depth_hf.depth_to_normal(depth))


@pytest.mark.parametrize("layout", ["name", "hub_id"])
def test_models_dir_lookup(models, tmp_path, monkeypatch, layout):
    """``run_preprocessor`` finds the model under the preprocessor models dir
    by the preprocessor's name or by its Hub id's folders."""
    import shutil

    root = tmp_path / "preprocessor_models"
    dest = root / ("zoe_depth_anything" if layout == "name" else "Intel/zoedepth-nyu-kitti")
    shutil.copytree(models["zoe"], dest)
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(root))
    got = run_preprocessor("zoe_depth_anything", FRAME, {"detect_resolution": 64}, device="cpu")[0]
    want = jax_class("zoe")(model_name=str(models["zoe"]))([FRAME], detect_resolution=64)[0]
    np.testing.assert_array_equal(got, want)
    assert depth_hf.local_model_dir("zoe_depth_anything", "Intel/zoedepth-nyu-kitti") == dest


@pytest.mark.parametrize("name", ["midas", "zoe", "depth_anything", "segmentation", "oneformer"])
def test_missing_model_raises_and_fetches_nothing(name, tmp_path, monkeypatch):
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="nothing is fetched"):
        run_preprocessor(name, FRAME, device="cpu")
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("name", ["mediapipe_face", "diffusion_edge", "mesh_graphormer"])
def test_gated_stubs_raise_as_jax(name):
    with pytest.raises(RuntimeError) as want:
        jax_class(name)().setup()
    with pytest.raises(RuntimeError) as got:
        run_preprocessor(name, FRAME, device="cpu")
    assert str(got.value) == str(want.value) and "requires the optional" in str(got.value)


def test_registry_names_are_the_jax_ones():
    from apex_studio_tpu.preprocess import preprocessor_registry as jax_registry

    assert preprocessor_registry.names() == jax_registry.names()
    assert len(preprocessor_registry.names()) == 54
    assert set(preprocessor_registry._entries) == set(jax_registry._entries)
    assert preprocessor_registry.get("uniformer") is segmentation.SegmentationPreprocessor
