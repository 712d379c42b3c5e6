"""The port's SkyReels V2 (the Wan DiT's fps embedding and per-frame
timesteps, the diffusion-forcing schedule, the t2v / i2v / df engines, the
``skyreels`` checkpoint names) against the JAX package, on the CPU.

The DiT at toy widths (2 blocks, 2 heads of 32, FFN 96, text 48, freq 32,
``inject_sample_info``), built from seeded numpy values and carried into the
port; f32 forwards held to rel L2 ≤ 1e-4 over 3 latent frames of 5 × 6
tokens: one timestep with the fps row, per-frame timesteps [1, 3] with and
without it. ``generate_timestep_matrix`` bit-equal to JAX's, its errors
too. The engines from the repository's three SkyReels manifests with
tests/test_engine_skyreels.py's toy components (a 1-block DiT, 2 heads of
24; a 1-layer UMT5; a Wan VAE with 4 latent channels, 2× in space and time)
in fp32, every weight carried from the JAX engine: latents within rel L2
1e-3. The df request: 9 frames at 16 × 16 (5 latent frames of 4 × 4 tokens)
in windows of 3 (``base_num_frames`` 5), 2 steps, ``ar_step`` 1, CFG 3.0.
The i2v manifest names the 16-channel DF config: the JAX engine fails on it
and the port raises first; a 10-channel DiT (4 noise + 2 mask + 4
condition) runs i2v on both.
"""

import copy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from apex_studio_tpu.engine import skyreels as jax_skyreels
from apex_studio_tpu.models.transformers import wan as jax_wan
from apex_studio_tpu_torch.engine import skyreels
from apex_studio_tpu_torch.models.transformers import wan
from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
from apex_studio_tpu_torch.engine import UniversalEngine
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from tests.test_engine_skyreels import SKYREELS_TINY
from tests.test_engine_zimage import make_tokenizer
from tests.torch_port_helpers import (assert_published_round_trip, assert_rel_l2, fast_jax_engine, jax_build,
                                      jax_params, port_from_jax)

REPO = Path(__file__).resolve().parents[1]

# -- the DiT ---------------------------------------------------------------------------

DIT = dict(num_attention_heads=2, attention_head_dim=32, in_channels=4, out_channels=4, text_dim=48,
           freq_dim=32, ffn_dim=96, num_layers=2, inject_sample_info=True)
F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
LATENT = (3, 10, 12)  # T, H, W: 3 × 5 × 6 tokens


def jax_dit():
    return jax_wan.WanTransformer3DModel(jax_wan.WanConfig(**DIT), rngs=nnx.Rngs(0), **F32)


def port_dit():
    return wan.WanTransformer3DModel(wan.WanConfig(**DIT), dtype=torch.float32)


@pytest.fixture(scope="module")
def dit():
    ref = jax_build(jax_dit, seed=11)
    return ref, port_from_jax(port_dit, ref)


def dit_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, 4, *LATENT)).astype(np.float32)
    ctx = rng.normal(size=(1, 7, 48)).astype(np.float32)
    ctx[:, 5:] = 0.0
    return x, ctx


CASES = {
    "one_timestep_fps": (np.array([731.0], np.float32), np.array([1], np.int32)),
    "per_frame_fps": (np.array([[999.0, 731.0, 250.0]], np.float32), np.array([0], np.int32)),
    "per_frame_no_fps": (np.array([[999.0, 500.0, 0.0]], np.float32), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dit_matches_jax(dit, case):
    ref, port = dit
    ts, fps = CASES[case]
    x, ctx = dit_inputs()
    want = nnx.jit(lambda m, *a: m(*a))(ref, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), None,
                                       None if fps is None else jnp.asarray(fps))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                   fps_index=None if fps is None else torch.from_numpy(fps).long())
    assert tuple(got.shape) == (1, 4, *LATENT)
    assert_rel_l2(got, want, 1e-4)


def test_fps_row_and_per_frame_timesteps_change_the_output(dit):
    _, port = dit
    x, ctx = (torch.from_numpy(a) for a in dit_inputs())
    t_one, t_frames = torch.tensor([731.0]), torch.tensor([[731.0, 731.0, 100.0]])
    with torch.no_grad():
        a, b = (port(x, t_one, ctx, fps_index=torch.tensor([i])) for i in (0, 1))
        assert not torch.allclose(a, b)
        # equal per-frame timesteps are the one timestep; another on one frame
        # changes every frame (self-attention mixes them)
        same = port(x, torch.tensor([[731.0] * 3]), ctx, fps_index=torch.tensor([1]))
        assert (same - b).abs().max() <= 1e-5 * b.abs().max()
        other = port(x, t_frames, ctx, fps_index=torch.tensor([1]))
        assert all(not torch.allclose(other[:, :, f], b[:, :, f]) for f in range(3))


def test_skyreels_is_registered_and_its_names_round_trip(dit):
    from apex_studio_tpu_torch.models.registry import _load_builtin_families, transformer_registry

    _load_builtin_families()
    for name in ("skyreels.base", "skyreels", "SkyReelsTransformer3DModel"):
        assert transformer_registry.get(name) is wan.WanTransformer3DModel
    assert_published_round_trip("skyreels", port_dit, dit[0])


# -- the diffusion-forcing schedule ---------------------------------------------------------

MATRIX_CASES = {
    "staggered": dict(num_frames=8, step_template=np.linspace(999, 1, 6), base_num_frames=8, ar_step=2),
    "prefix": dict(num_frames=6, step_template=np.linspace(999, 1, 4), base_num_frames=6, ar_step=2,
                   num_pre_ready=2),
    "window": dict(num_frames=9, step_template=np.array([999.0, 500.0]), base_num_frames=5, ar_step=1),
    "window_prefix": dict(num_frames=5, step_template=np.array([999.0, 700.0, 300.0]), base_num_frames=3,
                          ar_step=2, num_pre_ready=1),
    "causal_blocks": dict(num_frames=8, step_template=np.linspace(999, 1, 4), base_num_frames=4, ar_step=2,
                          causal_block_size=2),
}


@pytest.mark.parametrize("case", list(MATRIX_CASES))
def test_timestep_matrix_equals_jax(case):
    kw = MATRIX_CASES[case]
    got, want = skyreels.generate_timestep_matrix(**kw), jax_skyreels.generate_timestep_matrix(**kw)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3] == want[3]


def test_timestep_matrix_ar_step_bound_raises_as_jax():
    kw = dict(num_frames=16, step_template=np.linspace(999, 1, 10), base_num_frames=4, ar_step=1)
    with pytest.raises(ValueError) as a:
        skyreels.generate_timestep_matrix(**kw)
    with pytest.raises(ValueError) as b:
        jax_skyreels.generate_timestep_matrix(**kw)
    assert str(a.value) == str(b.value)
    assert skyreels.fps_to_index(16) == 0 and skyreels.fps_to_index(24) == 1 == jax_skyreels.fps_to_index(24)


# -- the engines ----------------------------------------------------------------------

MANIFESTS = {"df": "video/skyreels-v2-df-14b.yml", "t2v": "video/skyreels-v2-t2v-14b.yml",
             "i2v": "video/skyreels-v2-i2v-14b.yml"}
TINY = {c["type"]: c["config"] for c in SKYREELS_TINY["spec"]["components"] if c["type"] != "scheduler"}
DF = dict(prompt="a long video", negative_prompt="a cat", height=16, width=16, num_frames=9, base_num_frames=5,
          num_inference_steps=2, ar_step=1, guidance_scale=3.0, seed=7, fps=24)
IMAGE = np.random.default_rng(0).integers(0, 256, size=(20, 18, 3), dtype=np.uint8)
T2V = dict(prompt="hello world", negative_prompt="a cat", height=16, width=16, num_frames=5,
           num_inference_steps=2, guidance_scale=3.0, seed=3)


def manifest(tmp_path, model_type, in_channels=4):
    """The repository's SkyReels manifest of ``model_type`` with the toy
    components in fp32 and no files: its scheduler (FlowUniPC, shift 8) as
    published, the DiT at ``in_channels``."""
    doc = yaml.safe_load((REPO / "manifests" / MANIFESTS[model_type]).read_text())
    for comp in doc["spec"]["components"]:
        if comp["type"] == "scheduler":
            continue
        comp.pop("config_path", None)
        comp.pop("model_path", None)
        comp["precision"] = "fp32"
        comp["config"] = copy.deepcopy(TINY[comp["type"]])
        if comp["type"] == "transformer":
            comp["config"]["in_channels"] = in_channels
    path = tmp_path / f"skyreels-{model_type}-{in_channels}.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


def components(engine):
    for ctype in ("vae", "scheduler", "text_encoder"):
        if getattr(engine, ctype) is None:
            engine.load_component_by_type(ctype)
    engine.load_components(return_latents=True)
    engine._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
    return {"vae": engine.vae, "transformer": engine.transformer, "umt5": engine.text_encoder._ensure_model()}


class Pair:
    """A JAX engine and a port engine on one manifest, each with its own
    ``APEX_HOME_DIR``, the port carrying the JAX engine's weights; the
    encoders stay resident (a released one would be rebuilt from its own
    random weights)."""

    def __init__(self, path, tmp_path, mp):
        mp.delenv("APEX_SYNTHETIC_WEIGHTS", raising=False)
        mp.setenv("APEX_RELEASE_TEXT_ENCODERS", "0")
        self.mp, self.tmp = mp, tmp_path
        self.mp.setenv("APEX_HOME_DIR", str(tmp_path / "home_jax"))
        self.jax = fast_jax_engine(JaxUniversalEngine(path))
        ref = components(self.jax)
        self.mp.setenv("APEX_HOME_DIR", str(tmp_path / "home_port"))
        self.port = UniversalEngine(path, device="cpu")
        for name, module in components(self.port).items():
            load_from_jax(module, jax_params(ref[name]))

    def run_jax(self, **kw):
        self.mp.setenv("APEX_HOME_DIR", str(self.tmp / "home_jax"))
        return self.jax.run(**kw)

    def run_port(self, **kw):
        self.mp.setenv("APEX_HOME_DIR", str(self.tmp / "home_port"))
        return self.port.run(**kw)


def pair_fixture(model_type, in_channels=4):
    @pytest.fixture(scope="module")
    def fixture(tmp_path_factory):
        tmp = tmp_path_factory.mktemp(f"skyreels_{model_type}")
        with pytest.MonkeyPatch.context() as mp:
            yield Pair(manifest(tmp, model_type, in_channels), tmp, mp)

    return fixture


df = pair_fixture("df")
t2v = pair_fixture("t2v")
i2v = pair_fixture("i2v", in_channels=10)


def latents(pair, **kw):
    run = {**kw, "return_latents": True}
    return np.asarray(pair.run_jax(**run)), pair.run_port(**run)


def test_engine_classes(df, t2v, i2v):
    assert (type(df.port), type(t2v.port), type(i2v.port)) == (
        skyreels.SkyReelsDFEngine, skyreels.SkyReelsT2VEngine, skyreels.SkyReelsI2VEngine)
    assert df.port.transformer.cfg.inject_sample_info


def test_df_matches_jax(df, monkeypatch):
    ref, lat = latents(df, **DF)
    assert tuple(lat.shape) == ref.shape == (1, 4, 5, 8, 8)
    assert_rel_l2(lat, ref, 1e-3)
    # 6 rows, windows (0, 3) × 3, (1, 4), (2, 5) × 2, each a CFG pair over 3 frames
    windows = []
    forward = df.port.transformer.forward
    monkeypatch.setattr(df.port.transformer, "forward",
                        lambda x, t, *a, **k: windows.append(tuple(t.shape)) or forward(x, t, *a, **k))
    frames = df.run_port(**DF)
    assert windows == [(1, 3)] * 12
    assert len(frames) == 9 and frames[0].shape == (16, 16, 3) and frames[0].dtype == np.uint8


def test_df_image_prefix_is_preserved_and_matches_jax(df):
    run = dict(DF, image=IMAGE, guidance_scale=1.0, seed=3)
    ref, lat = latents(df, **run)
    assert_rel_l2(lat, ref, 1e-3)
    import cv2

    from apex_studio_tpu_torch.engine.wan import _pixels, _resized

    z0 = df.port.vae.encode(_pixels(_resized([IMAGE], 16, 16, cv2.INTER_LANCZOS4)))
    assert torch.equal(lat[:, :, :1], z0.float())  # the prefix frame is the image's latent, never updated
    assert not torch.equal(lat[:, :, 1:2], df.run_port(**dict(run, image=None, return_latents=True))[:, :, 1:2])


def drop_fps(monkeypatch, engine):
    """The port engine without the fps row, as JAX's fused and i2v forwards run."""
    monkeypatch.setattr(engine, "_set_fps", lambda fps: setattr(engine, "_fps_index", None))


def test_t2v_host_stepped_matches_jax_with_the_fps_row(t2v):
    """JAX threads the fps row only through ``_fwd_for``, the forward of a
    host-stepped scheduler: there both hold it, at 24 and at 16 fps."""
    from tests.test_torch_engine_wan import HostStepped

    saved = t2v.jax.scheduler, t2v.port.scheduler
    t2v.jax.scheduler, t2v.port.scheduler = HostStepped(saved[0]), HostStepped(saved[1])
    lat = {}
    try:
        for fps in (24, 16):
            ref, lat[fps] = latents(t2v, **T2V, fps=fps)
            assert tuple(lat[fps].shape) == ref.shape == (1, 4, 3, 8, 8)
            assert_rel_l2(lat[fps], ref, 1e-3)
    finally:
        t2v.jax.scheduler, t2v.port.scheduler = saved
    assert not torch.allclose(lat[24], lat[16])


@pytest.mark.parametrize("model_type", ["t2v", "i2v"])
def test_fused_t2v_and_i2v_thread_the_fps_row_where_jax_drops_it(model_type, t2v, i2v, monkeypatch):
    """JAX's fused UniPC step (t2v) and its i2v forward never pass the fps
    row (a reference fault, ROADMAP Queue 3): its outputs at 24 and 16 fps
    are equal. The port threads it: its outputs differ, and without the row
    they are JAX's."""
    pair = {"t2v": t2v, "i2v": i2v}[model_type]
    run = dict(T2V, image=IMAGE) if model_type == "i2v" else T2V
    ref24, ref16 = (np.asarray(pair.run_jax(**run, fps=fps, return_latents=True)) for fps in (24, 16))
    assert np.array_equal(ref24, ref16)
    lat24, lat16 = (pair.run_port(**run, fps=fps, return_latents=True) for fps in (24, 16))
    assert not torch.allclose(lat24, lat16)
    drop_fps(monkeypatch, pair.port)
    lat = pair.run_port(**run, fps=24, return_latents=True)
    assert tuple(lat.shape) == ref24.shape == (1, 4, 3, 8, 8)
    assert_rel_l2(lat, ref24, 1e-3)


def test_i2v_manifest_config_fails_in_jax_and_raises_in_the_port(tmp_path, monkeypatch):
    """The i2v manifest names the DF transformer config: a DiT whose input is
    its latent channels alone. JAX's i2v engine asks for noise of 4 − 6
    channels and fails; the port raises before it, naming the cause."""
    pair = Pair(manifest(tmp_path, "i2v", in_channels=4), tmp_path, monkeypatch)
    run = dict(T2V, image=IMAGE, num_inference_steps=1, guidance_scale=1.0)
    with pytest.raises(RuntimeError, match="negative dimension"):
        pair.run_jax(**run)
    with pytest.raises(ValueError, match="4 input channels, no more than the 6 condition channels"):
        pair.run_port(**run)
