"""The port's Flux t2i engine end to end against the JAX package's, on the CPU.

The tiny Flux manifest of tests/test_engine_flux.py, set to fp32, runs through
both ``UniversalEngine``s with the same seed; every component's weights are
carried from the JAX engine into the port. Each engine gets its own
``APEX_HOME_DIR``: text encodes are disk-cached by prompt and config, so a
shared home would hand the port the JAX embeddings. Latents after 2 steps:
max|Δ| ≤ 1e-4·max|ref|; frames: within 1 LSB.

Also here: the seed contract (noise bit-equal to JAX's), the card-by-default
rule, synthetic weights, and that the port never imports JAX.
"""

import ast
import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from apex_studio_tpu.engine.base import BaseEngine as JaxBaseEngine
from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from tests.test_engine_flux import FLUX_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import assert_close, jax_params

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "apex_studio_tpu_torch"
RUN = dict(prompt="hello world", height=32, width=32, num_inference_steps=2, seed=11,
           guidance_scale=3.5)


def write_manifest(tmp_path, precision="fp32"):
    doc = copy.deepcopy(FLUX_TINY)
    for comp in doc["spec"]["components"]:
        if comp["type"] != "scheduler":
            comp["precision"] = precision
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
        monkeypatch.setenv("APEX_SYNTHETIC_WEIGHTS", mode)
        eng = UniversalEngine(write_manifest(tmp_path), device="cpu")
        with pytest.raises(NotImplementedError, match="residency"):
            eng.load_component_by_type("transformer")

    def test_checkpoint_loading_not_ported(self, tmp_path, monkeypatch):
        monkeypatch.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        eng = UniversalEngine(REPO / "manifests/image/flux-dev-text-to-image.yml", device="cpu")
        with pytest.raises(NotImplementedError, match="checkpoints"):
            eng.load_component_by_type("transformer")


def _port_modules():
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


class TestNoJax:
    def test_import_adds_no_jax_module(self):
        code = (
            "import importlib, sys\n"
            f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax')"
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
        bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "apex_studio_tpu")]
        assert not bad, bad
