"""The port's HunyuanImage 3.0 (the MoE backbone, its DC-AE VAE, the t2i engine)
against the JAX package, on the CPU in f32.

The backbone at toy widths (2 layers, 4 query heads over 2 KV heads, QK norm,
4 experts at top-2 with a shared expert, the first layer dense) within 1e-5
rel L2: on the engine's layout, with ``img_begin`` given and tokens trailing
the image span, with group-limited routing; its attention as two kernel
launches a layer with no mask. The VAE within 1e-5 rel L2, images and
videos both ways. The engine from the repository manifest with toy
components, 2 steps with CFG: latents within 1e-3. The published names of
both modules round-trip, and the card's fit check raises with its need.
"""

import copy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu.models.transformers import hunyuanimage3 as jax_hy3
from apex_studio_tpu.models.vaes import hunyuanimage3_vae as jax_vae
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.engine import hunyuanimage3 as port_engine
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from apex_studio_tpu_torch.models.transformers import hunyuanimage3 as port_hy3
from apex_studio_tpu_torch.models.vaes import hunyuanimage3_vae as port_vae
from tests.test_engine_hunyuanimage3 import HYI3_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import (assert_published_round_trip, assert_rel_l2, fast_jax_engine, jax_build,
                                      jax_params, jitted, port_from_jax)

REPO = Path(__file__).resolve().parents[1]
BACKBONE = {"vocab_size": 64, "hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 32,
            "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2, "attention_head_dim": 16,
            "use_qk_norm": True, "num_experts": 4, "moe_topk": 2, "moe_layer_num_skipped": 1,
            "use_mixed_mlp_moe": True, "patch_embed_hidden_dim": 32, "img_in_channels": 4, "img_out_channels": 4,
            "patch_size": 1}
# case → (config overrides, latent grid, ids length, img_begin)
CASES = {
    "engine_layout": ({}, 8, 6, None),
    "img_begin_trailing": ({"patch_size": 2}, 8, 24, 4),
    "group_limited": ({"group_limited_greedy": True, "n_group": 2, "topk_group": 1, "norm_topk_prob": False,
                       "routed_scaling_factor": 2.5}, 4, 5, None),
}
VAE = {"latent_channels": 4, "block_out_channels": [32, 64, 64], "layers_per_block": 1, "ffactor_spatial": 4,
       "ffactor_temporal": 2}


def pair(overrides):
    """(JAX backbone, port backbone with its weights)."""
    cfg = dict(BACKBONE, **overrides)
    jm = jax_build(lambda: jax_hy3.HunyuanImage3ForCausalMM(jax_hy3.HunyuanImage3Config.from_dict(cfg),
                                                            dtype=jnp.float32, param_dtype=jnp.float32,
                                                            rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: port_hy3.HunyuanImage3ForCausalMM(port_hy3.HunyuanImage3Config.from_dict(cfg),
                                                                 dtype=torch.float32), jm)
    return jm, pm


def inputs(grid, n_ids, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(1, 4, grid, grid)).astype(np.float32)
    ids = rng.integers(0, 64, size=(1, n_ids)).astype(np.int32)
    return img, np.asarray([640.0], np.float32), ids


@pytest.mark.parametrize("case", list(CASES))
def test_backbone_matches_jax(case):
    overrides, grid, n_ids, img_begin = CASES[case]
    jm, pm = pair(overrides)
    img, t, ids = inputs(grid, n_ids)
    want = jitted(jm, lambda m, *a: m(*a, img_begin=img_begin), img, t, ids)
    got = pm(torch.from_numpy(img), torch.from_numpy(t), torch.from_numpy(ids), img_begin=img_begin)
    assert tuple(got.shape) == (1, 4, grid, grid)
    assert_rel_l2(got, want, 1e-5)


@pytest.mark.parametrize("img_begin, n_ids", [(None, 6), (4, 24)])
def test_attention_is_two_unmasked_launches_a_layer(monkeypatch, img_begin, n_ids):
    """No ``[S, S]`` mask reaches ``attention``: each layer launches a causal
    call with Sq == Sk and the image span's queries unmasked, every call on
    the flash route, and together they equal the masked plain attention."""
    from apex_studio_tpu_torch.ops.attention import attention as real_attention

    calls = []

    def recording(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw))
        return real_attention(q, k, v, **kw)

    monkeypatch.setattr(port_hy3, "attention", recording)
    _, pm = pair({"patch_size": 2} if img_begin else {})
    grid = 8
    pm(*(torch.from_numpy(a) for a in inputs(grid, n_ids)), img_begin=img_begin)
    assert len(calls) == 2 * BACKBONE["num_hidden_layers"]
    n_img = (grid // (2 if img_begin else 1)) ** 2
    for sq, sk, kw in calls:
        assert set(kw) <= {"is_causal"} and (not kw.get("is_causal") or sq == sk)
    assert sorted(sq for sq, _, _ in calls[:2]) == sorted([n_img, n_ids + (0 if img_begin else 1)])

    rng = np.random.default_rng(3)
    s, begin, n = 20, 7, 9
    q, k, v = (torch.from_numpy(rng.normal(size=(1, s, 2, 16)).astype(np.float32)) for _ in range(3))
    mask = torch.ones(s, s).tril().bool()
    mask[begin:begin + n, begin:begin + n] = True
    want = real_attention(q, k, v, mask=mask[None, None], backend="naive")
    assert_rel_l2(port_hy3.span_attention(q, k, v, begin, n), want.numpy(), 1e-6)
    mask = torch.ones(s, s).tril().bool()
    mask[begin:, begin:] = True
    want = real_attention(q, k, v, mask=mask[None, None], backend="naive")
    assert_rel_l2(port_hy3.span_attention(q, k, v, begin, s - begin), want.numpy(), 1e-6)


def test_rope_and_timestep_helpers_match_jax():
    for args in ((30, 16, 7, 4, 5, 10000.0), (12, 8, 3, 3, 3, 500.0)):
        for got, want in zip(port_hy3._build_2d_rope(*args), jax_hy3._build_2d_rope(*args)):
            np.testing.assert_array_equal(got, want)
    t = np.asarray([0.0, 1.5, 999.0], np.float32)
    assert_rel_l2(port_hy3._timestep_embedding(torch.from_numpy(t), 32),
                  np.asarray(jax_hy3._timestep_embedding(jnp.asarray(t), 32)), 1e-6)


@pytest.fixture(scope="module")
def vae_pair():
    cfg = jax_vae.HunyuanImage3VAEConfig.from_dict(VAE)
    jm = jax_build(lambda: jax_vae.AutoencoderKLConv3D(cfg, dtype=jnp.float32, rngs=nnx.Rngs(0)))
    pm = port_from_jax(lambda: port_vae.AutoencoderKLConv3D(port_vae.HunyuanImage3VAEConfig.from_dict(VAE),
                                                            dtype=torch.float32), jm)
    return jm, pm


@pytest.mark.parametrize("shape", [(1, 3, 16, 16), (1, 3, 4, 16, 16)], ids=["image", "video"])
def test_vae_encode_matches_jax(vae_pair, shape):
    jm, pm = vae_pair
    x = np.random.default_rng(1).uniform(-1, 1, size=shape).astype(np.float32)
    want = jitted(jm, lambda m, a: m.encode(a), x)
    got = pm.encode(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    assert_rel_l2(got, want, 1e-5)


@pytest.mark.parametrize("shape", [(1, 4, 4, 4), (1, 4, 1, 4, 4), (1, 4, 2, 4, 4)], ids=["image", "one", "video"])
def test_vae_decode_matches_jax(vae_pair, shape):
    jm, pm = vae_pair
    z = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want = jitted(jm, lambda m, a: m.decode(a), z)
    got = pm.decode(torch.from_numpy(z))
    assert tuple(got.shape) == want.shape
    assert_rel_l2(got, want, 1e-5)


def test_published_names_round_trip(vae_pair):
    cfg = dict(BACKBONE, patch_size=2)
    jm, _ = pair({"patch_size": 2})
    assert_published_round_trip(
        "hunyuanimage3",
        lambda: port_hy3.HunyuanImage3ForCausalMM(port_hy3.HunyuanImage3Config.from_dict(cfg), dtype=torch.float32),
        jm)
    assert_published_round_trip(
        "hunyuanimage3_vae",
        lambda: port_vae.AutoencoderKLConv3D(port_vae.HunyuanImage3VAEConfig.from_dict(VAE), dtype=torch.float32),
        vae_pair[0])


def manifest(tmp_path):
    """The repository manifest with toy components in fp32 and no weight files."""
    doc = yaml.safe_load((REPO / "manifests" / "image" / "hunyuanimage-3.yml").read_text())
    tiny = {"vae": VAE, "transformer": HYI3_TINY["spec"]["components"][3]["config"]}
    for comp in doc["spec"]["components"]:
        if comp["type"] in tiny:
            for key in ("config_path", "model_path"):
                comp.pop(key, None)
            comp["precision"] = "fp32"
            comp["config"] = copy.deepcopy(tiny[comp["type"]])
    path = tmp_path / "hunyuanimage-3.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


def test_engine_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
    path = manifest(tmp_path)
    engines = {}
    for side, cls in (("jax", JaxUniversalEngine), ("port", UniversalEngine)):
        monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / f"home_{side}"))
        eng = cls(path) if side == "jax" else cls(path, device="cpu")
        if side == "jax":
            fast_jax_engine(eng)
        eng._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
        eng.load_components(False) if side == "jax" else eng.load_components()
        engines[side] = eng
    assert type(engines["port"]) is port_engine.HunyuanImage3T2IEngine
    for name in ("transformer", "vae"):
        load_from_jax(getattr(engines["port"], name), jax_params(getattr(engines["jax"], name)))
    kw = dict(prompt="a lighthouse", negative_prompt="blurry", height=32, width=32, num_inference_steps=2,
              guidance_scale=7.5, seed=0, return_latents=True)
    want = np.asarray(engines["jax"].run(**kw))
    got = engines["port"].run(**kw)
    assert tuple(got.shape) == want.shape == (1, 4, 8, 8)
    assert_rel_l2(got, want, 1e-3)
    frames = engines["port"].run(**dict(kw, return_latents=False))
    assert len(frames) == 1 and frames[0].shape == (32, 32, 3) and frames[0].dtype == np.uint8


def test_fit_check_reckons_int4_and_raises(tmp_path, monkeypatch):
    """The backbone's bytes at int4 (each quantized Linear at half a byte an
    element and its f32 scales); a card with less free memory than that
    and the engine's headroom raises before the backbone is built."""
    from apex_studio_tpu_torch.quantize.residency import resident_bytes
    from apex_studio_tpu_torch.utils import memory

    cfg = port_hy3.HunyuanImage3Config(hidden_size=1024, intermediate_size=1024, moe_intermediate_size=1024,
                                       num_hidden_layers=1, num_attention_heads=8, num_experts=2, moe_topk=1,
                                       use_mixed_mlp_moe=True, vocab_size=16, patch_embed_hidden_dim=32)
    with torch.device("meta"):
        model = port_hy3.HunyuanImage3ForCausalMM(cfg, dtype=torch.bfloat16)
    big = [m for m in model.modules() if isinstance(m, port_hy3.Linear) and m.weight.numel() >= 1 << 20]
    every = sum(p.numel() * p.element_size() for p in model.parameters())
    rest = every - sum(m.weight.numel() * 2 for m in big)
    assert len(big) == 12  # qkv, o, the two experts' and the shared MLP's three, 3 time MLPs, the stem's emb
    want = sum(m.weight.numel() // 2 + 4 * m.weight.shape[0] for m in big) + rest
    assert resident_bytes(model, 4) == want
    assert resident_bytes(model, None) == every

    monkeypatch.setenv("APEX_SYNTHETIC_WEIGHTS", "int4")
    monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
    eng = UniversalEngine(manifest(tmp_path), device="cpu")
    assert eng.resident_headroom_bytes == port_engine.HEADROOM_BYTES
    eng._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
    monkeypatch.setattr(memory, "free_memory_bytes", lambda device: 1 << 30)
    with pytest.raises(MemoryError, match="needs .* GiB at int4 residency"):
        eng.load_components()
    assert eng.transformer is None and eng.reckoned_bytes["transformer"] > 0
