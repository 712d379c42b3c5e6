"""The port's FLUX.2 engines end to end against the JAX package's, on the CPU.

The tiny manifest of tests/test_engine_flux2.py (``FLUX2_TINY``: a 3-layer
Mistral-architecture encoder stacked 3 × 16 wide, a 1 + 1-block DiT, a
packed-BatchNorm VAE that halves the size), set to fp32, runs through both
``UniversalEngine``s with the same seed: the JAX engine builds its components
without flax's initialisers (``fast_jax_engine``) and every component is
carried into the port. Each engine has its own ``APEX_HOME_DIR``. Latents
after 2 steps: max|Δ| ≤ 1e-3·max|ref|; frames within 1 LSB. The requests:

- ``ti2i``: text to image at 32² (64 noise tokens, a 64-token prompt);
- ``edit``: the same with one reference image (64 more tokens at RoPE
  time 10);
- ``klein``: the klein model type, whose Mistral tower is stacked at other
  layers;
- ``control``: the control DiT (one chain block) with a control image, an
  inpaint image and a mask.

Also here: the two reference faults the port mirrors (a klein manifest with
a Qwen3 encoder hands the DiT one layer's width in both packages; synthetic
weights draw the VAE's running variance like a weight in JAX, where the port
resets it).
"""

import copy

import numpy as np
import pytest
import torch
import yaml

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from tests.test_engine_flux2 import FLUX2_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import assert_close, fast_jax_engine, jax_params

SIZE = 32
RUN = dict(prompt="a blue bird on a branch", height=SIZE, width=SIZE, num_inference_steps=2, seed=7,
           guidance_scale=4.0, max_sequence_length=64)


def manifest(model_type="ti2i", precision="fp32"):
    doc = copy.deepcopy(FLUX2_TINY)
    doc["spec"]["model_type"] = model_type
    for comp in doc["spec"]["components"]:
        if comp["type"] != "scheduler":
            comp["precision"] = precision
        if model_type == "klein" and comp["type"] == "text_encoder":
            comp["config"]["stack_layers"] = [0, 3, 2]
        if model_type == "control" and comp["type"] == "transformer":
            comp["base"] = "flux2.control"
            comp["config"] = {**comp["config"], "num_layers": 2, "control_layers": [1], "control_in_dim": 36}
    return doc


def write(doc, tmp):
    path = tmp / f"flux2-{doc['spec']['model_type']}-tiny.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


def inject_tokenizer(engine):
    engine._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()


def load_all(engine):
    engine.load_components()
    return {"vae": engine.vae, "transformer": engine.transformer, "text_encoder": engine.text_encoder._ensure_model()}


def media():
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, size=(40, 36, 3)).astype(np.uint8)
    mask = np.zeros((SIZE, SIZE), np.uint8)
    mask[:, 16:] = 255
    return img, mask


CASES = {  # name: (model type, run inputs)
    "ti2i": ("ti2i", lambda img, mask: {}),
    "edit": ("ti2i", lambda img, mask: {"images": [img]}),
    "klein": ("klein", lambda img, mask: {}),
    "control": ("control", lambda img, mask: {"control_image": img, "inpaint_image": 255 - img,
                                               "mask_image": mask, "control_context_scale": 0.7}),
}


@pytest.fixture(scope="module", params=list(CASES))
def engines(request, tmp_path_factory):
    name = request.param
    model_type, make_inputs = CASES[name]
    tmp = tmp_path_factory.mktemp(name)
    path = write(manifest(model_type), tmp)
    run = dict(RUN, **make_inputs(*media()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_HOME_DIR", str(tmp / "home_jax"))
        jeng = fast_jax_engine(JaxUniversalEngine(path))
        inject_tokenizer(jeng)
        jax_parts = load_all(jeng)
        ref_lat = np.asarray(jeng.run(return_latents=True, **run))
        ref_frames = jeng.run(**run)
        mp.setenv("APEX_HOME_DIR", str(tmp / "home_port"))
        peng = UniversalEngine(path, device="cpu")
        inject_tokenizer(peng)
        for part, module in load_all(peng).items():
            load_from_jax(module, jax_params(jax_parts[part]))
        lat = peng.run(return_latents=True, **run)
        frames = peng.run(**run)
    return name, peng, ref_lat, ref_frames, lat, frames, run


class TestFlux2Engines:
    def test_registered(self, engines):
        name, peng = engines[:2]
        assert type(peng).__name__ == ("Flux2ControlEngine" if name == "control" else "Flux2TI2IEngine")

    def test_latents_match_jax(self, engines):
        _, _, ref_lat, _, lat, _, _ = engines
        assert lat.dtype == torch.float32 and tuple(lat.shape) == ref_lat.shape == (1, 64, 16)
        assert_close(lat, ref_lat, rel=1e-3)

    def test_frames_within_one_lsb(self, engines):
        _, _, _, ref_frames, _, frames, _ = engines
        assert len(frames) == 1 and frames[0].shape == (SIZE, SIZE, 3) and frames[0].dtype == np.uint8
        assert np.abs(frames[0].astype(np.int16) - ref_frames[0].astype(np.int16)).max() <= 1

    def test_seed_repeats_and_other_seed_differs(self, engines):
        name, peng, _, _, lat, _, run = engines
        torch.testing.assert_close(peng.run(return_latents=True, **run), lat, rtol=0, atol=0)
        assert not torch.allclose(peng.run(return_latents=True, **dict(run, seed=8)), lat)


def test_t2i_and_klein_model_types_share_the_engine(tmp_path):
    for model_type in ("t2i", "klein", "ti2i"):
        eng = UniversalEngine(write(manifest(model_type), tmp_path), device="cpu")
        assert type(eng).__name__ == "Flux2TI2IEngine"


def test_prompt_template_and_width(tmp_path, monkeypatch):
    """Mistral's system/instruction template, the stacked width 3 × 16."""
    monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
    seen = []
    tok = make_tokenizer()

    class Recording:
        def encode(self, text, add_special_tokens=False):
            seen.append(text)
            return tok.encode(text, add_special_tokens=add_special_tokens)

    eng = UniversalEngine(write(manifest(), tmp_path), device="cpu")
    eng._spec_for_type("text_encoder")["tokenizer"] = Recording()
    eng.load_component_by_type("text_encoder")
    seq = eng.encode_prompt("a cat", 40)
    assert tuple(seq.shape) == (1, 40, 48)
    assert seen == ["[SYSTEM_PROMPT]You are an AI that processes image generation requests. Follow the user's "
                    "instruction precisely and describe the target image faithfully.[/SYSTEM_PROMPT]"
                    "[INST]a cat[/INST]"]


def test_empirical_mu_matches_jax():
    from apex_studio_tpu.engine.flux2 import compute_empirical_mu as jax_mu
    from apex_studio_tpu_torch.engine.flux2 import compute_empirical_mu

    for n, steps in ((64, 2), (4096, 4), (4096, 50), (4608, 8), (16384, 28)):
        assert compute_empirical_mu(n, steps) == jax_mu(n, steps)


# -- reference faults the port mirrors or departs from ----------------------------------


QWEN3_TINY = {"vocab_size": 64, "hidden_size": 16, "intermediate_size": 32, "num_hidden_layers": 3,
              "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 8}


def test_klein_with_qwen3_fails_in_both_packages(tmp_path, monkeypatch):
    """The klein 4B / 9B manifests name a Qwen3 encoder with ``stack_layers``.
    Neither package's Qwen3 reads that key: the encode returns the last
    layer's 16 features, where the DiT's context embedder takes 3 × 16. Both
    engines fail at the DiT's first step."""
    doc = manifest("klein")
    te = doc["spec"]["components"][2]
    te.update(base="Qwen3ForCausalLM", config=QWEN3_TINY, extra_kwargs={"stack_layers": [1, 2, 3]})
    path = write(doc, tmp_path)
    widths = []
    for name, build in (("jax", lambda: fast_jax_engine(JaxUniversalEngine(path))),
                        ("port", lambda: UniversalEngine(path, device="cpu"))):
        monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / name))
        eng = build()
        inject_tokenizer(eng)
        eng.load_components()
        widths.append(tuple(np.shape(eng.encode_prompt("a cat", 24))))
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            eng.run(**dict(RUN, max_sequence_length=24))
    assert widths == [(1, 24, 16), (1, 24, 16)]


def test_synthetic_running_variance(tmp_path, monkeypatch):
    """With synthetic weights the JAX engine draws the VAE's running variance
    like a weight (normal, some negative: its normalization is NaN); the port
    resets the statistics to a fresh BatchNorm's."""
    monkeypatch.setenv("APEX_SYNTHETIC_WEIGHTS", "bf16")
    monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
    doc = manifest(precision="bf16")
    doc["spec"]["components"][1]["config"].update(block_out_channels=[8], mid_block_add_attention=False)
    path = write(doc, tmp_path)  # a one-level VAE: fewer parameters to draw
    jvae = JaxUniversalEngine(path).load_component_by_type("vae")
    assert float(np.asarray(jvae.bn_var.value).min()) < 0
    assert np.isnan(np.asarray(jvae.normalize_packed(np.ones((1, 4, 16), np.float32)))).any()
    pvae = UniversalEngine(path, device="cpu").load_component_by_type("vae")
    assert torch.equal(pvae.bn_var, torch.ones(16)) and torch.equal(pvae.bn_mean, torch.zeros(16))
    assert torch.isfinite(pvae.normalize_packed(torch.ones(1, 4, 16))).all()
