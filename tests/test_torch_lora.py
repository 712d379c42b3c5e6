"""The port's LoRA handling against the JAX package's, on the CPU.

The same adapter files go through ``apex_studio_tpu.lora`` and
``apex_studio_tpu_torch.lora`` onto a tiny Flux DiT whose weights (quantized
ones too) are carried from the JAX model. Tolerances: merged f32 weights and
outputs max|Δ| ≤ 1e-4·max|ref| (1e-6 for the weights alone); requantized int8 /
int4 values equal JAX's in ≥ 99.9% of entries and never more than one step
apart, scales to 1e-6 relative (XLA may fuse ``q·s + d`` into one rounding,
which moves a value on a rounding tie by a step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from apex_studio_tpu.lora import convert as jax_convert
from apex_studio_tpu.lora import manager as jax_manager
from apex_studio_tpu.models.transformers.flux import FluxConfig as JaxFluxConfig
from apex_studio_tpu.models.transformers.flux import FluxTransformer2DModel as JaxFlux
from apex_studio_tpu.quantize import residency as jax_residency
from apex_studio_tpu_torch.loaders.safetensors_io import save_safetensors
from apex_studio_tpu_torch.lora import convert, manager
from apex_studio_tpu_torch.lora.manager import LoraManager, LoraSpec
from apex_studio_tpu_torch.models.transformers.flux import FluxConfig, FluxTransformer2DModel
from tests.torch_port_helpers import assert_close, port_from_jax

TINY = dict(in_channels=16, out_channels=16, num_layers=2, num_single_layers=1,
            attention_head_dim=32, num_attention_heads=2, joint_attention_dim=48,
            pooled_projection_dim=24, axes_dims_rope=(8, 12, 12))
D = 64
RANK = 4


def lora_state(fmt, blocks=(0, 1), projs=("to_q", "to_k", "to_v"), extra=()):
    """Rank-4 adapters on the double blocks' qkv, in PEFT or kohya naming."""
    rng = np.random.default_rng(0)
    sd = {}
    for path in [f"transformer_blocks.{i}.attn.{p}" for i in blocks for p in projs] + list(extra):
        down = rng.normal(size=(RANK, D)).astype(np.float32) * 0.1
        up = rng.normal(size=(D, RANK)).astype(np.float32) * 0.1
        if fmt == "peft":
            sd[f"transformer.{path}.lora_A.weight"] = down
            sd[f"transformer.{path}.lora_B.weight"] = up
        else:
            flat = "lora_unet_" + path.replace(".", "_")
            sd[f"{flat}.lora_down.weight"] = down
            sd[f"{flat}.lora_up.weight"] = up
            sd[f"{flat}.alpha"] = np.array(2.0, np.float32)
    return sd


def build_pair(residency=None, min_numel=D * D):
    jm = JaxFlux(JaxFluxConfig(**TINY), dtype=jnp.float32, param_dtype=jnp.float32, rngs=nnx.Rngs(0))
    if residency == 8:
        assert jax_residency.apply_int8_residency(jm, min_numel=min_numel) > 0
    elif residency == 4:
        assert jax_residency.apply_int4_residency(jm, min_numel=min_numel) > 0
    pm = port_from_jax(lambda: FluxTransformer2DModel(FluxConfig(**TINY), dtype=torch.float32), jm)
    return jm, pm


def forward(jm, pm):
    rng = np.random.default_rng(1)
    args = [rng.normal(size=s).astype(np.float32) for s in ((1, 16, 16), (1, 5, 48), (1, 24))]
    args += [np.array([0.6], np.float32), np.array([3.5], np.float32)]
    ref = np.asarray(jm(*map(jnp.asarray, args), grid_hw=(4, 4)))
    with torch.inference_mode():
        out = pm(*map(torch.from_numpy, args), grid_hw=(4, 4))
    return out, ref


@pytest.mark.parametrize("fmt", ["peft", "kohya"])
class TestFormats:
    def test_pairs_equal_jax(self, fmt):
        sd = lora_state(fmt)
        assert convert.detect_lora_format(sd) == jax_convert.detect_lora_format(sd) == fmt
        ours = convert.lora_pairs_from_state_dict(sd)
        ref = jax_convert.lora_pairs_from_state_dict(sd)
        assert [p.module_path for p in ours] == [p.module_path for p in ref]
        assert ours[0].module_path == "transformer_blocks.0.attn.to_q"
        for a, b in zip(ours, ref):
            assert a.alpha == b.alpha and a.rank == RANK
            np.testing.assert_array_equal(a.delta(0.8), b.delta(0.8))

    def test_merge_and_unmerge_match_jax(self, fmt):
        jm, pm = build_pair()
        sd = lora_state(fmt)
        w0 = pm.transformer_blocks[0].attn.to_k.weight.detach().clone()
        applied, skipped = LoraManager().apply_to_model(pm, sd, scale=0.8, converter_family="flux")
        ref_applied, ref_skipped = jax_manager.LoraManager().apply_to_model(
            jm, sd, scale=0.8, converter_family="flux")
        assert (applied, skipped) == (ref_applied, ref_skipped) == (6, [])
        merged = pm.transformer_blocks[0].attn.to_k.weight
        assert not torch.allclose(merged, w0)
        assert_close(merged, np.asarray(jm.transformer_blocks[0].attn.to_k.kernel.value).T, rel=1e-6)
        assert_close(*forward(jm, pm))
        LoraManager().apply_to_model(pm, sd, scale=0.8, converter_family="flux", sign=-1.0)
        assert_close(pm.transformer_blocks[0].attn.to_k.weight, w0.numpy(), rel=1e-6)


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="unrecognized"):
        convert.lora_pairs_from_state_dict({"w": np.zeros(2)})


def test_bf16_merge_casts_the_delta_to_the_weight_dtype():
    _, pm = build_pair()
    pm = pm.to(torch.bfloat16)
    w0 = pm.transformer_blocks[1].attn.to_v.weight.detach().clone()
    sd = lora_state("peft")
    LoraManager().apply_to_model(pm, sd, scale=1.0, converter_family="flux")
    delta = [p for p in convert.lora_pairs_from_state_dict(sd)
             if p.module_path == "transformer_blocks.1.attn.to_v"][0].delta(1.0)
    want = w0 + torch.from_numpy(delta).to(torch.bfloat16)
    w = pm.transformer_blocks[1].attn.to_v.weight
    assert w.dtype == torch.bfloat16 and torch.equal(w, want)


def requantized_close(q, q_ref, s, s_ref):
    np.testing.assert_allclose(s, s_ref, rtol=1e-6)
    q, q_ref = q.astype(np.int16), q_ref.astype(np.int16)
    assert (q == q_ref).mean() >= 0.999 and np.abs(q - q_ref).max() <= 1


class TestQuantizedMerge:
    def test_merge8_equals_jax(self):
        rng = np.random.default_rng(0)
        q = rng.integers(-127, 128, size=(48, 40), dtype=np.int8)  # JAX [in, out]
        s = rng.uniform(0.001, 0.01, size=40).astype(np.float32)
        s[3] = 1.0
        q[:, 3] = 0  # with a zero delta this channel's absmax is 0 → scale 1
        d = rng.normal(size=(48, 40)).astype(np.float32) * 0.05
        d[:, 3] = 0.0
        q_ref, s_ref = jax_manager._merge8(jnp.asarray(q), jnp.asarray(s), jnp.asarray(d))
        new_q, new_s = manager._merge8(*map(torch.from_numpy, (np.ascontiguousarray(q.T), s,
                                                               np.ascontiguousarray(d.T))))
        assert new_q.dtype == torch.int8 and new_s.dtype == torch.float32 and new_s[3] == 1.0
        requantized_close(new_q.numpy().T, np.asarray(q_ref), new_s.numpy(), np.asarray(s_ref))

    def test_merge4_equals_jax_nibble_for_nibble(self):
        rng = np.random.default_rng(1)
        packed = rng.integers(0, 256, size=(48, 20), dtype=np.uint8)  # JAX [in, out/2]
        s = rng.uniform(0.01, 0.1, size=40).astype(np.float32)
        d = rng.normal(size=(48, 40)).astype(np.float32) * 0.05
        p_ref, s_ref = jax_manager._merge4(jnp.asarray(packed), jnp.asarray(s), jnp.asarray(d))
        new_p, new_s = manager._merge4(*map(torch.from_numpy, (np.ascontiguousarray(packed.T), s,
                                                               np.ascontiguousarray(d.T))))
        assert new_p.dtype == torch.uint8 and tuple(new_p.shape) == (20, 48)
        ours, ref = new_p.numpy().T, np.asarray(p_ref)
        for plane in (lambda u: u & 0xF, lambda u: u >> 4):
            requantized_close(plane(ours), plane(ref), new_s.numpy(), np.asarray(s_ref))

    @pytest.mark.parametrize("bits", [8, 4])
    def test_routes_to_the_quantized_merge_and_matches_jax(self, bits):
        jm, pm = build_pair(residency=bits)
        lin = pm.transformer_blocks[0].attn.to_q
        assert lin.weight_scale is not None and lin.weight_bits == bits
        q0, s0 = lin.weight.detach().clone(), lin.weight_scale.detach().clone()
        sd = lora_state("peft")
        applied, skipped = LoraManager().apply_to_model(pm, sd, scale=0.8, converter_family="flux")
        ref = jax_manager.LoraManager().apply_to_model(jm, sd, scale=0.8, converter_family="flux")
        assert (applied, skipped) == ref == (6, [])
        lin = pm.transformer_blocks[0].attn.to_q
        assert lin.weight.dtype == q0.dtype and lin.weight.shape == q0.shape and lin.weight_bits == bits
        assert not torch.equal(lin.weight, q0) and not torch.equal(lin.weight_scale, s0)
        np.testing.assert_allclose(lin.weight_scale.numpy(),
                                   np.asarray(jm.transformer_blocks[0].attn.to_q.kernel_scale.value),
                                   rtol=1e-6)
        out, ref_out = forward(jm, pm)
        # a requantized value one step off moves the output by a fraction of a scale
        tol = 2e-2 if bits == 4 else 2e-3
        assert np.linalg.norm(out.numpy() - ref_out) <= tol * np.linalg.norm(ref_out)

    def test_unmerge_of_a_quantized_weight_is_not_exact(self):
        _, pm = build_pair(residency=8)
        lin = pm.transformer_blocks[0].attn.to_q
        q0, s0 = lin.weight.detach().clone(), lin.weight_scale.detach().clone()
        sd = lora_state("peft")
        steps = []
        for sign in (1.0, -1.0):
            LoraManager().apply_to_model(pm, sd, scale=0.8, converter_family="flux", sign=sign)
            steps.append(pm.transformer_blocks[0].attn.to_q.weight_scale.max())
        lin = pm.transformer_blocks[0].attn.to_q
        back = lin.weight.float() * lin.weight_scale[:, None]
        orig = q0.float() * s0[:, None]
        assert not torch.equal(lin.weight, q0)  # the scales changed twice
        # each requantization rounds by at most half a step of its own scale
        assert (back - orig).abs().max() <= 1.01 * 0.5 * sum(steps)

    def test_quantized_shape_mismatch_is_skipped(self):
        _, pm = build_pair(residency=8)
        bad = {"transformer.transformer_blocks.0.attn.to_q.lora_A.weight": np.zeros((RANK, D), np.float32),
               "transformer.transformer_blocks.0.attn.to_q.lora_B.weight": np.zeros((D + 2, RANK), np.float32)}
        applied, skipped = LoraManager().apply_to_model(pm, bad, converter_family="flux")
        assert applied == 0 and skipped == ["transformer_blocks.0.attn.to_q.weight (quantized target shape mismatch)"]


class TestTargets:
    def test_missing_targets_are_reported_as_skipped(self):
        jm, pm = build_pair()
        sd = lora_state("peft", extra=("transformer_blocks.7.attn.to_q", "not_a_module.proj"))
        applied, skipped = LoraManager().apply_to_model(pm, sd, converter_family="flux")
        ref = jax_manager.LoraManager().apply_to_model(jm, sd, converter_family="flux")
        assert applied == ref[0] == 6
        assert skipped == ["transformer_blocks.7.attn.to_q.weight", "not_a_module.proj.weight"]
        assert len(ref[1]) == 2

    def test_shape_mismatch_is_skipped(self):
        _, pm = build_pair()
        bad = {"transformer.x_embedder.lora_A.weight": np.zeros((RANK, 5), np.float32),
               "transformer.x_embedder.lora_B.weight": np.zeros((D, RANK), np.float32)}
        applied, skipped = LoraManager().apply_to_model(pm, bad, converter_family="flux")
        assert applied == 0 and "x_embedder.weight (shape (64, 5) vs (64, 16))" in skipped[0]

    def test_single_block_and_renamed_paths(self):
        """diffusers names that the flux converter renames (single-block attn,
        to_out.0, ff.net) land on the port's paths."""
        mgr = LoraManager()
        sd = {}
        for path in ("single_transformer_blocks.0.attn.to_q", "transformer_blocks.0.attn.to_out.0",
                     "transformer_blocks.1.ff.net.0.proj"):
            sd[f"{path}.lora_A.weight"] = np.zeros((RANK, D), np.float32)
            sd[f"{path}.lora_B.weight"] = np.zeros((4 * D if "proj" in path else D, RANK), np.float32)
        paths = [p for p, _ in mgr.pairs_for_model(sd, "flux")]
        assert paths == ["single_transformer_blocks.0.to_q.weight", "transformer_blocks.0.attn.to_out.weight",
                         "transformer_blocks.1.ff.fc1.weight"]
        _, pm = build_pair()
        assert mgr.apply_to_model(pm, sd, converter_family="flux") == (3, [])


class TestResolveAndLoad:
    def test_local_forms(self, tmp_path, monkeypatch):
        monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
        root = tmp_path / "home" / "loras"
        (root / "org" / "repo").mkdir(parents=True)
        for p in (tmp_path / "abs.safetensors", root / "named.safetensors", root / "org/repo/f.safetensors"):
            save_safetensors(p, {"x": torch.zeros(1)})
        mgr = LoraManager()
        assert mgr.lora_root == root
        assert mgr.resolve(str(tmp_path / "abs.safetensors")) == tmp_path / "abs.safetensors"
        assert mgr.resolve("named.safetensors") == root / "named.safetensors"
        assert mgr.resolve("hf:org/repo/f.safetensors") == root / "org/repo/f.safetensors"

    @pytest.mark.parametrize("source", ["https://example.invalid/a.safetensors",
                                        "urn:air:flux1:lora:civitai:1@2", "nowhere.safetensors"])
    def test_unresolvable_sources_raise_file_not_found(self, source, tmp_path):
        with pytest.raises(FileNotFoundError, match="LoRA"):
            LoraManager(lora_root=tmp_path).resolve(source)

    def test_load_into_reads_a_bf16_file(self, tmp_path):
        _, pm = build_pair()
        sd = {k: torch.from_numpy(np.asarray(v)).to(torch.bfloat16) for k, v in lora_state("peft").items()}
        save_safetensors(tmp_path / "style.safetensors", sd)
        w0 = pm.transformer_blocks[0].attn.to_q.weight.detach().clone()
        spec = LoraSpec.from_manifest_entry({"source": str(tmp_path / "style.safetensors"), "scale": 0.5})
        assert LoraManager(lora_root=tmp_path).load_into(pm, spec, converter_family="flux") == (6, [])
        assert not torch.equal(pm.transformer_blocks[0].attn.to_q.weight, w0)

    def test_spec_from_manifest_entry(self):
        assert LoraSpec.from_manifest_entry("a.safetensors") == LoraSpec(source="a.safetensors")
        spec = LoraSpec.from_manifest_entry({"path": "b", "scale": "0.3", "name": "n"})
        assert (spec.source, spec.scale, spec.name) == ("b", 0.3, "n")
