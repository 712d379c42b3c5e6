"""The port's torchvision-op shim, DensePose, SigLIP's MAP head and the Cosmos
guardrail against the JAX package's on the CPU.

- The shim: ``nms`` and ``roi_align`` against the JAX shim's functions on
  seeded boxes and maps (both thresholds' sides, empty input, aligned and
  legacy ROIs, fixed and adaptive sampling), bit for bit; the ops resolved
  by TorchScript whichever registration came first in the process.
- DensePose on the JAX test's scripted stand-in (the export's output
  contract, calling both ops from TorchScript): the frames equal.
- SigLIP's MAP head and the encoder with ``use_head`` (``pooled=True``) at
  toy widths, f32, carried from the JAX modules: within 1e-5 rel L2; the
  ``siglip_pooled`` converter on transformers' names against the JAX one.
- The classifier (a torch ``Sequential`` with running statistics as the
  reference's checkpoint, and the default weights), the keyword blocklist,
  the runner and ``cosmos.guardrail`` end to end over a 9-frame clip
  sampled every 4 frames, safe and blocked, against the JAX postprocessor:
  the same frames or the same empty result; the pass-through without an
  encoder and the face blur's no-op without a detector (a Haar cascade where
  OpenCV ships one).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from apex_studio_tpu.models.text_encoders import siglip as jax_siglip
from apex_studio_tpu.postprocess import guardrail as jax_guard
from apex_studio_tpu.preprocess import torch_shim as jax_shim
from apex_studio_tpu_torch.models.text_encoders import siglip
from apex_studio_tpu_torch.postprocess import guardrail, run_postprocessor
from apex_studio_tpu_torch.preprocess import torch_shim
from tests.torch_port_helpers import assert_rel_l2, jax_build, port_from_jax


@pytest.fixture(scope="module", autouse=True)
def ops():
    """The JAX shim registers first: with this torch it does not recognise
    an op another registration made (the duplicate's error no longer says
    "already"), where the port's takes it."""
    assert jax_shim.install_torchvision_ops()
    assert torch_shim.install_torchvision_ops()
    assert torch_shim.install_torchvision_ops()  # idempotent


def boxes(n, seed):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(n, 2, generator=g) * 80
    wh = torch.rand(n, 2, generator=g) * 30 + 1
    return torch.cat([xy, xy + wh], dim=1), torch.rand(n, generator=g)


@pytest.mark.parametrize("n,thr", [(0, 0.5), (1, 0.5), (60, 0.3), (60, 0.7), (200, 0.5)])
def test_nms_is_the_jax_shims(n, thr):
    b, s = boxes(n, seed=n)
    got = torch.ops.torchvision.nms(b, s, thr)
    assert torch.equal(got, jax_shim._nms_impl(b, s, thr)) and got.dtype == torch.int64
    assert torch.equal(torch_shim._nms_impl(b, s, thr), got)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sampling_ratio", [2, 0])
def test_roi_align_is_the_jax_shims(aligned, sampling_ratio):
    g = torch.Generator().manual_seed(3)
    feat = torch.randn(2, 5, 24, 32, generator=g)
    b, _ = boxes(12, seed=4)
    rois = torch.cat([torch.tensor([0.0, 1.0] * 6)[:, None], b], dim=1)
    rois[3, 1:] = torch.tensor([10.0, 10.0, 10.0, 10.0])  # a degenerate box (the legacy clamp)
    args = (feat, rois, 0.25, 7, 5, sampling_ratio, aligned)
    want = jax_shim._roi_align_impl(*args)
    assert torch.equal(torch_shim._roi_align_impl(*args), want)
    assert torch.equal(torch.ops.torchvision.roi_align(*args), want)
    assert torch_shim._roi_align_impl(feat, rois[:0], 0.25, 7, 5, 2, True).shape == (0, 5, 7, 5)


class _TinyDensePose(torch.nn.Module):
    """The JAX test's stand-in (tests/test_preprocess_densepose.py): the
    export's outputs (boxes, coarse and fine segmentation, u, v), with both
    shim ops called from TorchScript."""

    def forward(self, img: torch.Tensor):
        h = img.shape[1]
        w = img.shape[2]
        cx0 = float(w) * 0.25
        cy0 = float(h) * 0.25
        boxes = torch.tensor([
            [cx0, cy0, cx0 + float(w) * 0.5, cy0 + float(h) * 0.5],
            [cx0 + 1.0, cy0 + 1.0, cx0 + float(w) * 0.5, cy0 + float(h) * 0.5],
        ])
        scores = torch.tensor([0.9, 0.5])
        keep = torch.ops.torchvision.nms(boxes, scores, 0.5)
        boxes = boxes[keep]
        feat = img.unsqueeze(0).to(torch.float32) / 255.0
        rois = torch.cat([torch.zeros((boxes.shape[0], 1)), boxes], dim=1)
        pooled = torch.ops.torchvision.roi_align(feat, rois, 1.0, 28, 28, 2, True)
        n = boxes.shape[0]
        coarse = torch.ones((n, 2, 28, 28))
        coarse[:, 0] = 0.0
        fine = pooled[:, :1].repeat(1, 25, 1, 1)
        fine[:, 3] += 10.0
        fine[:, 7] += 20.0 * (pooled[:, 1] > 0.5).to(torch.float32)  # a second part where green is high
        u = torch.linspace(0, 1, 28).expand(n, 25, 28, 28)
        v = torch.linspace(0, 1, 28).reshape(-1, 1).expand(n, 25, 28, 28)
        return boxes, coarse, fine, u, v


@pytest.mark.parametrize("cmap", ["viridis", "parula"])
def test_densepose_matches_jax(cmap, tmp_path, monkeypatch):
    from apex_studio_tpu.preprocess.base import preprocessor_registry as jax_registry
    from apex_studio_tpu_torch.preprocess import run_preprocessor

    path = tmp_path / "densepose_r50_fpn_dl.torchscript"
    torch.jit.save(torch.jit.script(_TinyDensePose()), str(path))
    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    rng = np.random.default_rng(0)
    frame = (rng.integers(0, 255, size=(96, 128, 3))).astype(np.uint8)
    frame[30:70, 40:90, 1] = 220
    params = {"detect_resolution": 64, "cmap": cmap}
    jax_proc = jax_registry.get("densepose")(model_path=str(path))
    jax_proc.setup()
    want = jax_proc.process_frame(frame, **params)
    got = run_preprocessor("DenseposeDetector", [frame], dict(params), device="cpu")[0]
    assert got.shape == (96, 128, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) >= 3


def test_densepose_missing_export_raises(tmp_path, monkeypatch):
    from apex_studio_tpu_torch.preprocess import run_preprocessor

    monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="densepose_r50_fpn_dl.torchscript") as err:
        run_preprocessor("densepose", np.zeros((32, 32, 3), np.uint8), device="cpu")
    assert str(tmp_path) in str(err.value)


# -- SigLIP's MAP head ---------------------------------------------------------------------

CFG = dict(hidden_size=32, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4, image_size=56,
           patch_size=14, use_head=True)


def test_map_head_matches_jax():
    jcfg, pcfg = jax_siglip.SiglipVisionConfig(**CFG), siglip.SiglipVisionConfig(**CFG)
    head = jax_build(lambda: jax_siglip.SiglipMAPHead(jcfg, dtype=jnp.float32, param_dtype=jnp.float32,
                                                      rngs=nnx.Rngs(0)))
    port = port_from_jax(lambda: siglip.SiglipMAPHead(pcfg, dtype=torch.float32), head)
    x = np.random.default_rng(1).normal(size=(2, 9, 32)).astype(np.float32)
    with torch.no_grad():
        assert_rel_l2(port(torch.from_numpy(x)), np.asarray(head(jnp.asarray(x))), 1e-5)


def encoder_pair():
    jcfg, pcfg = jax_siglip.SiglipVisionConfig(**CFG), siglip.SiglipVisionConfig(**CFG)
    enc = jax_build(lambda: jax_siglip.SiglipVisionEncoder(jcfg, dtype=jnp.float32, param_dtype=jnp.float32,
                                                           rngs=nnx.Rngs(0)))
    return enc, port_from_jax(lambda: siglip.SiglipVisionEncoder(pcfg, dtype=torch.float32), enc)


def test_encoder_pooled_matches_jax():
    enc, port = encoder_pair()
    px = np.random.default_rng(2).uniform(-1, 1, size=(2, 3, 56, 56)).astype(np.float32)
    with torch.no_grad():
        assert_rel_l2(port(torch.from_numpy(px), pooled=True), np.asarray(enc(jnp.asarray(px), pooled=True)), 1e-5)
        assert_rel_l2(port(torch.from_numpy(px)), np.asarray(enc(jnp.asarray(px))), 1e-5)
    no_head = siglip.SiglipVisionEncoder(siglip.SiglipVisionConfig(**{**CFG, "use_head": False}), dtype=torch.float32)
    assert no_head.head is None
    with pytest.raises(ValueError):
        no_head(torch.zeros(1, 3, 56, 56), pooled=True)


def test_siglip_pooled_converter_matches_jax():
    """transformers' ``SiglipVisionModel`` names, the head's included,
    through both ``siglip_pooled`` converters."""
    from apex_studio_tpu.loaders.converters import convert_keys as jax_convert
    from apex_studio_tpu.loaders.state_mapping import apply_state_dict as jax_apply
    from apex_studio_tpu_torch.loaders.converters import convert_keys
    from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict

    enc, port = encoder_pair()
    sd = {}
    for k, v in port.state_dict().items():
        if k.startswith("head."):
            name = {"head.in_proj_weight": "attention.in_proj_weight", "head.in_proj_bias": "attention.in_proj_bias",
                    "head.probe": "probe"}.get(k, k[len("head."):].replace("out_proj.", "attention.out_proj.")
                                                .replace("fc1.", "mlp.fc1.").replace("fc2.", "mlp.fc2."))
            sd[f"vision_model.head.{name}"] = v
        elif k == "patch_embedding.weight":
            sd["vision_model.embeddings.patch_embedding.weight"] = v.reshape(32, 3, 14, 14)
        elif k == "patch_embedding.bias":
            sd["vision_model.embeddings.patch_embedding.bias"] = v
        elif k == "position_embedding":
            sd["vision_model.embeddings.position_embedding.weight"] = v
        elif k.startswith("layers."):
            sd["vision_model.encoder." + k.replace(".fc1.", ".mlp.fc1.").replace(".fc2.", ".mlp.fc2.")] = v
        else:
            sd["vision_model." + k] = v
    sd["logit_scale"] = torch.ones(1)
    with torch.device("meta"):
        got = siglip.SiglipVisionEncoder(siglip.SiglipVisionConfig(**CFG), dtype=torch.float32)
    apply_state_dict(got, convert_keys("siglip_pooled", sd), device="cpu", strict=True)
    ref = nnx.eval_shape(lambda: jax_siglip.SiglipVisionEncoder(jax_siglip.SiglipVisionConfig(**CFG),
                                                                 dtype=jnp.float32, param_dtype=jnp.float32,
                                                                 rngs=nnx.Rngs(0)))
    jax_apply(ref, jax_convert("siglip_pooled", {k: v.numpy() for k, v in sd.items()}), strict=True)
    want = port_from_jax(lambda: siglip.SiglipVisionEncoder(siglip.SiglipVisionConfig(**CFG), dtype=torch.float32),
                         ref).state_dict()
    assert set(got.state_dict()) == set(want)
    for k, v in want.items():
        assert torch.equal(got.state_dict()[k], v), k


# -- the guardrail -------------------------------------------------------------------------


def classifier_state(input_size=32, safe=True, seed=0):
    """The reference's classifier checkpoint (``network.layers.*``) from a
    torch ``Sequential`` with running statistics; class 0 (safe) or class 3
    made to win by the last bias."""
    torch.manual_seed(seed)
    seq = torch.nn.Sequential(torch.nn.Linear(input_size, 512), torch.nn.BatchNorm1d(512), torch.nn.ReLU(),
                              torch.nn.Linear(512, 256), torch.nn.BatchNorm1d(256), torch.nn.ReLU(),
                              torch.nn.Linear(256, 7)).eval()
    with torch.no_grad():
        for bn in (seq[1], seq[4]):
            bn.running_mean.uniform_(-1, 1)
            bn.running_var.uniform_(0.5, 2.0)
        seq[6].bias.zero_()
        seq[6].bias[0 if safe else 3] = 50.0
    return {f"network.layers.{k}": v for k, v in seq.state_dict().items()}


def test_classifier_matches_jax():
    x = np.random.default_rng(3).normal(size=(4, 32)).astype(np.float32)
    sd = classifier_state(seed=1)
    sd["network.layers.6.bias"] = torch.randn(7)
    jax_clf = jax_guard.SafetyClassifier(jax_guard.SafetyClassifierConfig(input_size=32))
    jax_clf.load_torch_state({k: v.numpy() for k, v in sd.items()})
    port = guardrail.SafetyClassifier(guardrail.SafetyClassifierConfig(input_size=32))
    port.load_torch_state(sd)
    with torch.no_grad():
        assert_rel_l2(port(torch.from_numpy(x)), jax_clf(x), 1e-5)
        # the default weights: the JAX module's seeded draws
        assert_rel_l2(guardrail.SafetyClassifier()(torch.from_numpy(np.tile(x, (1, 36)))),
                      jax_guard.SafetyClassifier()(np.tile(x, (1, 36))), 1e-5)
    with pytest.raises(KeyError):
        port.load_torch_state({k: v for k, v in sd.items() if "running_var" not in k})


def test_keyword_blocklist_is_the_jax_one(tmp_path):
    (tmp_path / "a.txt").write_text("forbidden\n\ntwo words\n")
    (tmp_path / "b.txt").write_text("Naughty\n")
    words = guardrail.read_keyword_list_from_dir(tmp_path)
    assert words == jax_guard.read_keyword_list_from_dir(tmp_path) == ["forbidden", "two words", "Naughty"]
    port, ref = guardrail.KeywordBlocklist(words), jax_guard.KeywordBlocklist(words)
    for prompt in ("a nice prompt", "very Forbidden thing", "contains two words here", "unforbiddenish",
                   "naughty café", "twowords", "FORBIDDEN!"):
        assert port.is_safe(prompt) == ref.is_safe(prompt), prompt


def clip(n=9, h=48, w=64):
    rng = np.random.default_rng(5)
    return [(rng.random((h, w, 3)) * 255).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("safe", [True, False], ids=["safe", "blocked"])
def test_cosmos_guardrail_matches_jax(safe):
    """The clip through the SigLIP filter (frames 0, 4, 8) and the face blur
    (no detector: a no-op), on both sides."""
    enc, port_enc = encoder_pair()
    sd = classifier_state(safe=safe)
    frames = clip()
    want = jax_guard.CosmosGuardrailPostprocessor(encoder=enc, classifier_state={k: v.numpy() for k, v in sd.items()},
                                                  sample_every=4)(frames)
    port = guardrail.CosmosGuardrailPostprocessor(device="cpu", encoder=port_enc, classifier_state=sd, sample_every=4)
    got = port(frames)
    assert len(got) == len(want) == (len(frames) if safe else 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the embeddings behind the decision
    jax_filter = jax_guard.VideoContentSafetyFilter(enc, sample_every=4)
    port_filter = port.runner.safety_models[0]
    for i in (0, 4, 8):
        assert_rel_l2(port_filter.embed(frames[i]), jax_filter._embed(frames[i]), 1e-5)
    assert port_filter.is_safe(frames)[0] == safe


def test_cosmos_guardrail_without_encoder_passes_frames():
    frames = clip(3)
    got = run_postprocessor("cosmos.guardrail", frames, device="cpu")
    want = jax_guard.CosmosGuardrailPostprocessor()(frames)
    assert len(got) == len(want) == 3
    for g, w, f in zip(got, want, frames):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, f)


def test_face_pixelator_is_the_jax_one():
    import cv2

    face = np.arange(64 * 3, dtype=np.uint8).reshape(8, 8, 3)
    np.testing.assert_array_equal(guardrail.pixelate_face(face, 2), jax_guard.pixelate_face(face, 2))
    frames = clip(2, 96, 96)
    for pp in (guardrail.FacePixelator(), jax_guard.FacePixelator()):
        assert pp._detect(frames[0]) is None and all(a is b for a, b in zip(pp.postprocess(frames), frames))
    cascade = getattr(getattr(cv2, "data", None), "haarcascades", None)
    if cascade:
        path = f"{cascade}haarcascade_frontalface_default.xml"
        got, want = guardrail.FacePixelator(path).postprocess(frames), jax_guard.FacePixelator(path).postprocess(frames)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_runner_blocks_and_postprocesses():
    class Block:
        def is_safe(self, _):
            return False, "nope"

    class Pass:
        def is_safe(self, _):
            return True, "ok"

    class MarkPP:
        def postprocess(self, frames):
            return [f + 1 for f in frames]

    frames = [np.zeros((4, 4, 3), np.uint8)]
    for runner_cls in (guardrail.GuardrailRunner, jax_guard.GuardrailRunner):
        assert runner_cls([Pass(), Block()]).run_safety_check(frames) == (False, "BLOCK: nope")
        assert runner_cls([]).run_safety_check(frames)[0]
        assert runner_cls([], [MarkPP()]).postprocess(frames)[0].max() == 1
