"""The port's Flux t2i engine end to end against the JAX package's, on the CPU.

The tiny Flux manifest of tests/test_engine_flux.py, set to fp32, runs through
both ``UniversalEngine``s with the same seed; every component's weights are
carried from the JAX engine into the port. Each engine gets its own
``APEX_HOME_DIR``: text encodes are disk-cached by prompt and config, so a
shared home would hand the port the JAX embeddings. Latents after 2 steps:
max|Δ| ≤ 1e-4·max|ref|; frames: within 1 LSB.

Three more ways through the same manifest, each against the JAX engine:

- ``int8_carried``: the JAX transformer made int8-resident, its quantized
  weights carried over; both compute W8A8. Latents ‖Δ‖₂ ≤ 5e-3·‖ref‖₂, the
  limit tests/test_torch_residency.py holds a W8A8 Flux block to. One Linear
  alone agrees bit for bit, but the f32 norms and softmax before it differ in
  the last digits between XLA and torch, which moves an activation that sits
  near a rounding tie by one int8 step, at widths of 64 a visible share of a
  row;
- ``checkpoint``: every component loaded by both engines from the same files
  on disk (BFL single-file transformer, sharded T5 directory, CLIP and VAE in
  their published naming) under the components directory. Latents
  max|Δ| ≤ 1e-4·max|ref|, as for carried weights;
- ``manifest_lora`` / ``request_lora``: the checkpoint run with a rank-4 LoRA
  named in the manifest, or in the request's ``selected_components``; both
  engines merge it at load. Same tolerance.

Also here: the seed contract (noise bit-equal to JAX's), the card-by-default
rule, synthetic weights, and that the port never imports JAX.
"""

import ast
import copy
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from apex_studio_tpu.engine.base import BaseEngine as JaxBaseEngine
from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu.quantize import residency as jax_residency
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.loaders.export import flux_bfl_state_dict, published_state_dict
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from apex_studio_tpu_torch.loaders.safetensors_io import save_safetensors
from apex_studio_tpu_torch.quantize.residency import count_resident
from tests.test_engine_flux import FLUX_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import assert_close, jax_params

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "apex_studio_tpu_torch"
RUN = dict(prompt="hello world", height=32, width=32, num_inference_steps=2, seed=11,
           guidance_scale=3.5)


def write_manifest(tmp_path, precision="fp32", model_paths=None, loras=None):
    doc = copy.deepcopy(FLUX_TINY)
    for comp in doc["spec"]["components"]:
        if comp["type"] != "scheduler":
            comp["precision"] = precision
            if model_paths:
                comp["model_path"] = model_paths[comp.get("name") or comp["type"]]
    if loras:
        doc["spec"]["loras"] = loras
    path = tmp_path / "flux-tiny.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


def inject_tokenizer(engine):
    tok = make_tokenizer()
    for spec in engine.component_specs.values():
        if spec.get("type") == "text_encoder":
            spec["tokenizer"] = tok


def load_all(engine):
    engine.load_component_by_type("vae")
    engine.load_component_by_type("transformer")
    engine.load_text_encoders()
    return {
        "vae": engine.vae,
        "transformer": engine.transformer,
        "clip": engine.text_encoder._ensure_model(),
        "t5": engine.text_encoder_2._ensure_model(),
    }


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flux_port")
    path = write_manifest(tmp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_HOME_DIR", str(tmp / "home_jax"))
        jeng = JaxUniversalEngine(path)
        inject_tokenizer(jeng)
        jax_parts = load_all(jeng)
        ref_lat = np.asarray(jeng.run(return_latents=True, **RUN))
        ref_frames = jeng.run(**RUN)

        mp.setenv("APEX_HOME_DIR", str(tmp / "home_port"))
        peng = UniversalEngine(path, device="cpu")
        inject_tokenizer(peng)
        for name, module in load_all(peng).items():
            load_from_jax(module, jax_params(jax_parts[name]))
        lat = peng.run(return_latents=True, **RUN)
        frames = peng.run(**RUN)
    return ref_lat, ref_frames, lat, frames


class TestFluxEngineParity:
    def test_latents_match_jax(self, engines):
        ref_lat, _, lat, _ = engines
        assert lat.dtype == torch.float32 and tuple(lat.shape) == ref_lat.shape
        assert_close(lat, ref_lat)

    def test_frames_within_one_lsb(self, engines):
        _, ref_frames, _, frames = engines
        assert len(frames) == len(ref_frames) == 1
        assert frames[0].shape == (32, 32, 3) and frames[0].dtype == np.uint8
        diff = np.abs(frames[0].astype(np.int16) - ref_frames[0].astype(np.int16))
        assert diff.max() <= 1


MODEL_PATHS = {"transformer": "flux-tiny/flux1-tiny.safetensors", "vae": "flux-tiny/vae.safetensors",
               "text_encoder": "flux-tiny/text_encoder/model.safetensors",
               "text_encoder_2": "flux-tiny/text_encoder_2"}


def write_checkpoints(tmp):
    """Seeded random weights for every component, written under
    ``tmp/components`` in each family's published naming. Returns the LoRA
    file written beside them."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_HOME_DIR", str(tmp / "home_writer"))
        parts = load_all(UniversalEngine(write_manifest(tmp), device="cpu"))
    gen = torch.Generator().manual_seed(5)
    for module in parts.values():
        for p in module.parameters():
            p.data.normal_(0.0, 0.1, generator=gen)
    root = tmp / "components" / "flux-tiny"
    (root / "text_encoder").mkdir(parents=True)
    (root / "text_encoder_2").mkdir()
    save_safetensors(root / "flux1-tiny.safetensors", flux_bfl_state_dict(parts["transformer"].state_dict()))
    save_safetensors(root / "vae.safetensors", published_state_dict("autoencoder_kl", parts["vae"].state_dict()))
    save_safetensors(root / "text_encoder" / "model.safetensors",
                     published_state_dict("clip", parts["clip"].state_dict()))
    t5 = published_state_dict("t5", parts["t5"].state_dict())
    names = sorted(t5)
    for i, shard in enumerate((names[::2], names[1::2])):  # a sharded directory, no index file
        save_safetensors(root / "text_encoder_2" / f"model-0000{i + 1}-of-00002.safetensors",
                         {k: t5[k] for k in shard})
    rng = np.random.default_rng(0)
    lora = {}
    for proj in ("to_q", "to_k", "to_v"):
        base = f"transformer.transformer_blocks.0.attn.{proj}"
        lora[f"{base}.lora_A.weight"] = rng.normal(size=(4, 64)).astype(np.float32) * 0.3
        lora[f"{base}.lora_B.weight"] = rng.normal(size=(64, 4)).astype(np.float32) * 0.3
    save_safetensors(tmp / "style.safetensors", lora)
    return tmp / "style.safetensors"


VARIANTS = ["int8_carried", "checkpoint", "manifest_lora", "request_lora"]


@pytest.fixture(scope="module", params=VARIANTS)
def variant(request, tmp_path_factory):
    """(name, JAX latents, port latents, port engine) of one variant."""
    name = request.param
    tmp = tmp_path_factory.mktemp(name)
    kwargs = {}
    if name == "int8_carried":
        path = write_manifest(tmp)
    else:
        lora = {"source": str(write_checkpoints(tmp)), "scale": 0.8}
        path = write_manifest(tmp, model_paths=MODEL_PATHS,
                              loras=[lora] if name == "manifest_lora" else None)
        if name == "request_lora":
            kwargs["selected_components"] = {"loras": [lora]}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        mp.setenv("APEX_COMPONENTS_PATH", str(tmp / "components"))
        mp.setenv("APEX_HOME_DIR", str(tmp / "home_jax"))
        jeng = JaxUniversalEngine(path, **kwargs)
        inject_tokenizer(jeng)
        if name == "int8_carried":
            jax_parts = load_all(jeng)
            assert jax_residency.apply_int8_residency(jeng.transformer, min_numel=1 << 10) > 0
        ref_lat = np.asarray(jeng.run(return_latents=True, **RUN))

        mp.setenv("APEX_HOME_DIR", str(tmp / "home_port"))
        peng = UniversalEngine(path, device="cpu", **kwargs)
        inject_tokenizer(peng)
        if name == "int8_carried":
            for part, module in load_all(peng).items():
                load_from_jax(module, jax_params(jax_parts[part]))
        lat = peng.run(return_latents=True, **RUN)
    return name, ref_lat, lat, peng


class TestFluxEngineVariants:
    def test_latents_match_jax(self, variant):
        name, ref_lat, lat, peng = variant
        assert tuple(lat.shape) == ref_lat.shape and torch.isfinite(lat).all()
        if name == "int8_carried":
            assert count_resident(peng.transformer) > 0
            err = np.linalg.norm(lat.numpy() - ref_lat) / np.linalg.norm(ref_lat)
            assert err <= 5e-3, err
        else:
            assert_close(lat, ref_lat)

    def test_loras_merged_at_load(self, variant):
        name, _, _, peng = variant
        if name.endswith("_lora"):
            assert [(r["scale"], r["applied"], r["skipped"]) for r in peng.lora_results] == [(0.8, 3, [])]
        else:
            assert peng.lora_results == []


def test_lora_changes_the_latents(tmp_path_factory):
    """The merged adapter is not a no-op: against the same checkpoint without it."""
    tmp = tmp_path_factory.mktemp("lora_effect")
    lora = {"source": str(write_checkpoints(tmp)), "scale": 0.8}
    lats = []
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        mp.setenv("APEX_COMPONENTS_PATH", str(tmp / "components"))
        mp.setenv("APEX_HOME_DIR", str(tmp / "home"))
        for loras in (None, [lora]):
            (tmp / str(bool(loras))).mkdir()
            eng = UniversalEngine(write_manifest(tmp / str(bool(loras)), model_paths=MODEL_PATHS, loras=loras),
                                  device="cpu")
            inject_tokenizer(eng)
            lats.append(eng.run(return_latents=True, **RUN))
    assert not torch.allclose(lats[0], lats[1], rtol=0, atol=1e-3 * float(lats[0].abs().max()))


def test_gguf_variant_routes_through_the_gguf_reader(tmp_path, monkeypatch):
    """A ``type: gguf`` variant picked by the request: the transformer's file
    (diffusers naming, written by the JAX package's writer) is dequantized on
    load. F32 entries come back exactly, Q8_0 ones within a quantization step."""
    from apex_studio_tpu.quantize.writers import write_gguf

    monkeypatch.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
    monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
    monkeypatch.setenv("APEX_COMPONENTS_PATH", str(tmp_path / "components"))
    source = load_all(UniversalEngine(write_manifest(tmp_path), device="cpu"))["transformer"]
    gen = torch.Generator().manual_seed(2)
    for p in source.parameters():
        p.data.normal_(0.0, 0.1, generator=gen)
    published = published_state_dict("flux", source.state_dict())
    used = write_gguf(tmp_path / "components" / "flux-tiny" / "flux-Q8_0.gguf",
                      {k: v.numpy() for k, v in published.items()}, qtype="Q8_0", skip_quant=("norm", "bias"))
    assert "Q8_0" in used.values() and "F32" in used.values()
    variants = [{"path": "flux-tiny/missing.safetensors", "variant": "default", "type": "safetensors"},
                {"path": "flux-tiny/flux-Q8_0.gguf", "variant": "GGUF_Q8_0", "type": "gguf"}]
    (tmp_path / "g").mkdir()
    path = write_manifest(tmp_path / "g", model_paths={**MODEL_PATHS, "transformer": variants})
    eng = UniversalEngine(path, device="cpu", selected_components={"transformer": {"variant": "GGUF_Q8_0"}})
    loaded = eng.load_component_by_type("transformer")
    want, got = source.state_dict(), loaded.state_dict()
    assert sorted(want) == sorted(got)
    for k in want:
        step = float(want[k].abs().max()) / 127
        assert float((got[k] - want[k]).abs().max()) <= (0.0 if "norm" in k or "bias" in k else 0.6 * step), k  # half a step, and the fp16 block scale
    with pytest.raises(FileNotFoundError, match="missing.safetensors"):
        UniversalEngine(path, device="cpu").load_component_by_type("transformer")


def test_missing_lora_file_is_skipped_not_fatal(tmp_path, monkeypatch):
    monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
    eng = UniversalEngine(write_manifest(tmp_path, loras=["nowhere.safetensors"]), device="cpu")
    eng.load_component_by_type("transformer")
    assert eng.lora_results == []


class TestSeedContract:
    @pytest.mark.parametrize("seed", [0, 11, 2**31 - 1])
    def test_noise_bit_equal_to_jax(self, seed, tmp_path):
        peng = UniversalEngine(write_manifest(tmp_path), device="cpu")
        shape = (1, 16, 16, 12)
        ours = peng.get_latents(shape, seed=seed)
        ref = np.asarray(JaxBaseEngine.get_latents(shape, seed=seed))
        np.testing.assert_array_equal(ours.numpy(), ref)


class TestTextEncoderCache:
    def test_encode_is_disk_cached(self, tmp_path, monkeypatch):
        monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
        eng = UniversalEngine(write_manifest(tmp_path), device="cpu")
        inject_tokenizer(eng)
        eng.load_text_encoders()
        t5 = eng.text_encoder_2
        first, mask = t5.encode(["hello world"], 16, use_chat_template=False)
        t5.release()
        again, mask2 = t5.encode(["hello world"], 16, use_chat_template=False)
        assert t5.model is None  # served from the cache, the encoder was not rebuilt
        torch.testing.assert_close(again, first.float(), rtol=0, atol=0)
        torch.testing.assert_close(mask2, mask, rtol=0, atol=0)


class TestDeviceRule:
    def test_entry_point_without_device_needs_cuda(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            UniversalEngine(write_manifest(tmp_path))

    def test_cpu_on_request(self, tmp_path):
        eng = UniversalEngine(write_manifest(tmp_path), device="cpu")
        assert eng.device == torch.device("cpu")


class TestSyntheticWeights:
    def test_bf16_run_is_finite_and_seeded(self, tmp_path, monkeypatch):
        monkeypatch.setenv("APEX_SYNTHETIC_WEIGHTS", "bf16")
        monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
        path = write_manifest(tmp_path, precision="bf16")
        outs = []
        for _ in range(2):
            eng = UniversalEngine(path, device="cpu")
            inject_tokenizer(eng)
            outs.append(eng.run(return_latents=True, **RUN))
        assert torch.isfinite(outs[0]).all()
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
        assert eng.transformer.x_embedder.weight.dtype == torch.bfloat16

    @pytest.mark.parametrize("mode", ["int8", "int4"])
    def test_quantized_residency_raises(self, mode, tmp_path, monkeypatch):
        """Quantized residency used to raise; now the run is finite and seeded.
        Every weight of the tiny manifest is under 2**20 elements, so the
        threshold is lowered here to make some resident."""
        from apex_studio_tpu_torch.quantize import residency

        monkeypatch.setenv("APEX_SYNTHETIC_WEIGHTS", mode)
        monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
        for fill in ("materialize_random_int8", "materialize_random_int4"):
            monkeypatch.setattr(residency, fill, functools.partial(getattr(residency, fill), min_numel=1 << 10))
        path = write_manifest(tmp_path, precision="bf16")
        outs = []
        for _ in range(2):
            eng = UniversalEngine(path, device="cpu")
            inject_tokenizer(eng)
            outs.append(eng.run(return_latents=True, **RUN))
        assert torch.isfinite(outs[0]).all()
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
        lin = eng.transformer.transformer_blocks[0].attn.to_q
        assert lin.weight_bits == (4 if mode == "int4" else 8)
        assert lin.weight.dtype == (torch.uint8 if mode == "int4" else torch.int8)
        # int4 is the transformer's tier alone: the encoders stay int8
        t5 = eng.text_encoder_2._ensure_model()
        assert {m.weight.dtype for m in t5.modules()
                if getattr(m, "weight_scale", None) is not None} == {torch.int8}

    def test_checkpoint_loading_not_ported(self, tmp_path, monkeypatch):
        """A component whose files are not on disk raises ``FileNotFoundError``
        naming the path (it used to raise ``NotImplementedError``)."""
        monkeypatch.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
        eng = UniversalEngine(REPO / "manifests/image/flux-dev-text-to-image.yml", device="cpu")
        with pytest.raises(FileNotFoundError, match="FLUX.1-dev"):
            eng.load_component_by_type("transformer")


def _port_modules():
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


class TestNoJax:
    def test_import_adds_no_jax_module(self):
        code = (
            "import importlib, sys\n"
            f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ml_dtypes', 'safetensors')"
            " or m == 'apex_studio_tpu' or m.startswith('apex_studio_tpu.')]\n"
            "print(sorted(bad))\n"
        )
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]"

    @pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                             ids=lambda p: str(p.relative_to(REPO)))
    def test_source_has_no_jax_import(self, path):
        names = []
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.append(node.module)
        bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "apex_studio_tpu",
                                                        "ml_dtypes", "safetensors")]
        assert not bad, bad
