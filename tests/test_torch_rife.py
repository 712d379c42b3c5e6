"""The port's RIFE interpolator and cv2 interpolators against the JAX package's,
on the CPU.

Ops (``resize_half_pixel`` down- and upsampling at odd sizes, ``flow_warp``
with coordinates past the border, ``pixel_shuffle2``, ``Deconv2x``) and whole
IFNets (``RIFEConfig.tiny()`` and the default widths) run the same seeded
numpy inputs in f32 after the JAX parameters are carried with
``loaders/from_jax.py``: max|Δ| ≤ 1e-4·max|ref|. Interpolated uint8 frames
are at most one step apart (the +0.5 rounding of nearly equal floats) and
almost all equal; the cv2 ``frame_interpolation`` and ``blend`` frames are
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from apex_studio_tpu.loaders.state_mapping import apply_state_dict as jax_apply_state_dict
from apex_studio_tpu.postprocess import interpolate as jax_interpolate
from apex_studio_tpu.postprocess import rife as jax_rife
from apex_studio_tpu_torch.loaders.export import published_state_dict
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
from apex_studio_tpu_torch.loaders.safetensors_io import save_safetensors
from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict
from apex_studio_tpu_torch.postprocess import postprocessor_registry, run_postprocessor
from apex_studio_tpu_torch.postprocess import rife
from apex_studio_tpu_torch.postprocess.interpolate import (
    BlendInterpolationPostprocessor,
    FrameInterpolationPostprocessor,
)
from tests.torch_port_helpers import assert_close, jax_params

RNG = np.random.default_rng(5)
CONFIGS = {"tiny": jax_rife.RIFEConfig.tiny(), "default": jax_rife.RIFEConfig()}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def flownet_sd(cfg, seed=0):
    """A Practical-RIFE ``flownet`` state dict for ``cfg`` with seeded values."""
    rng = np.random.default_rng(seed)
    r = lambda *shape: (rng.normal(size=shape) * 0.1).astype(np.float32)  # noqa: E731
    sd = {}
    for b, c in enumerate(cfg.widths):
        cin = 7 if b == 0 else 12
        p = f"module.block{b}"
        sd[f"{p}.conv0.0.0.weight"], sd[f"{p}.conv0.0.0.bias"] = r(c // 2, cin, 3, 3), r(c // 2)
        sd[f"{p}.conv0.0.1.weight"] = 0.2 + r(c // 2)
        sd[f"{p}.conv0.1.0.weight"], sd[f"{p}.conv0.1.0.bias"] = r(c, c // 2, 3, 3), r(c)
        sd[f"{p}.conv0.1.1.weight"] = 0.2 + r(c)
        for i in range(cfg.res_blocks):
            sd[f"{p}.convblock.{i}.conv.weight"], sd[f"{p}.convblock.{i}.conv.bias"] = r(c, c, 3, 3), r(c)
            sd[f"{p}.convblock.{i}.beta"] = 1.0 + r(1, c, 1, 1)
            sd[f"{p}.convblock.{i}.relu.weight"] = 0.2 + r(c)
        sd[f"{p}.lastconv.weight"], sd[f"{p}.lastconv.bias"] = r(c, 24, 4, 4), r(24)
    sd["module.contextnet.conv1.weight"] = r(1)  # training-time only: dropped
    return sd


def jax_ifnet(cfg, sd):
    # built abstractly: the flownet dict fills every parameter
    model = nnx.eval_shape(lambda: jax_rife.IFNet(cfg, rngs=nnx.Rngs(1)))
    jax_apply_state_dict(model, jax_rife.convert_rife_keys(sd), strict=True)
    return model


def port_ifnet(cfg, jax_model):
    return load_from_jax(rife.IFNet(rife.RIFEConfig(**vars(cfg))), jax_params(jax_model)).eval()


@pytest.fixture(scope="module")
def nets():
    out = {}
    for name, cfg in CONFIGS.items():
        ref = jax_ifnet(cfg, flownet_sd(cfg))
        out[name] = (ref, port_ifnet(cfg, ref))
    return out


class TestOps:
    @pytest.mark.parametrize("src,dst", [((64, 96), (8, 12)), ((64, 96), (32, 48)), ((37, 45), (9, 11)),
                                         ((37, 45), (18, 45)), ((8, 12), (64, 96)), ((5, 7), (19, 23)),
                                         ((16, 16), (16, 16))])
    def test_resize_matches_jax_image_resize(self, src, dst):
        x = RNG.normal(size=(2, *src, 5)).astype(np.float32)
        ref = jax.image.resize(jnp.asarray(x), (2, *dst, 5), "bilinear")
        out = rife.resize_half_pixel(nchw(x), *dst)
        assert_close(nhwc(out), np.asarray(ref), rel=1e-4)

    def test_resize_is_not_plain_bilinear_when_downsampling(self):
        x = nchw(RNG.normal(size=(1, 64, 64, 3)).astype(np.float32))
        plain = torch.nn.functional.interpolate(x, size=(8, 8), mode="bilinear", align_corners=False)
        assert (rife.resize_half_pixel(x, 8, 8) - plain).abs().max() > 1e-2

    def test_flow_warp_matches_jax(self):
        img = RNG.normal(size=(2, 24, 20, 3)).astype(np.float32)
        flow = (RNG.normal(size=(2, 24, 20, 2)) * 8).astype(np.float32)  # reaches past every border
        ref = jax_rife.flow_warp(jnp.asarray(img), jnp.asarray(flow))
        out = rife.flow_warp(nchw(img), nchw(flow))
        assert_close(nhwc(out), np.asarray(ref), rel=1e-4)

    def test_pixel_shuffle_matches_jax(self):
        x = RNG.normal(size=(2, 3, 4, 24)).astype(np.float32)
        ref = jax_rife.pixel_shuffle2(jnp.asarray(x))
        assert_close(nhwc(rife.pixel_shuffle2(nchw(x))), np.asarray(ref), rel=1e-6)

    def test_deconv2x_carry_undoes_the_flip(self):
        ref = jax_rife.Deconv2x(5, 7, rngs=nnx.Rngs(3))
        ref.bias.value = jnp.asarray(RNG.normal(size=(7,)).astype(np.float32))
        port = load_from_jax(rife.Deconv2x(5, 7), jax_params(ref))
        x = RNG.normal(size=(2, 6, 9, 5)).astype(np.float32)
        assert_close(nhwc(port(nchw(x))), np.asarray(ref(jnp.asarray(x))), rel=1e-4)


class TestIFNet:
    @pytest.mark.parametrize("name,size", [("tiny", (64, 96)), ("default", (64, 64))])
    def test_forward_matches_jax(self, nets, name, size):
        ref, port = nets[name]
        a = RNG.uniform(size=(1, *size, 3)).astype(np.float32)
        b = RNG.uniform(size=(1, *size, 3)).astype(np.float32)
        want = np.asarray(nnx.jit(lambda m, a, b: m(a, b, 0.3))(ref, jnp.asarray(a), jnp.asarray(b)))
        with torch.inference_mode():
            out = port(nchw(a), nchw(b), 0.3)
        assert_close(nhwc(out), want, rel=1e-4)
        assert 0.0 < float(want.std())

    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_convert_rife_keys_loads_strictly(self, nets, name):
        """The port's own converter on the same flownet dict gives the
        parameters the carry gives."""
        cfg = CONFIGS[name]
        sd = flownet_sd(cfg)
        mapped = rife.convert_rife_keys({k: torch.from_numpy(v) for k, v in sd.items()})
        assert not any("contextnet" in k for k in mapped)
        model = rife.IFNet(rife.RIFEConfig(**vars(cfg)))
        apply_state_dict(model, mapped, strict=True)
        want = nets[name][1].state_dict()
        got = model.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


class TestPostprocessor:
    def test_frames_match_jax(self, nets):
        ref, port = nets["tiny"]
        frames = [RNG.integers(0, 256, size=(40, 52, 3), dtype=np.uint8) for _ in range(3)]
        want = jax_rife.RIFEPostprocessor(model=ref)(frames, multiplier=3)
        got = rife.RIFEPostprocessor(model=port)(frames, multiplier=3)
        assert len(got) == len(want) == 7
        assert all(f.shape == (40, 52, 3) and f.dtype == np.uint8 for f in got)
        for i in (0, 3, 6):
            np.testing.assert_array_equal(got[i], frames[i // 3])
        diff = np.stack([np.abs(g.astype(int) - w.astype(int)) for g, w in zip(got, want)])
        assert diff.max() <= 1 and (diff == 0).mean() > 0.99

    def test_setup_loads_the_flownet_checkpoint(self, nets, tmp_path, monkeypatch):
        """``run_postprocessor`` builds the default IFNet from
        ``rife_v4.safetensors`` in the preprocessor models directory, written
        in the published naming from the carried module."""
        port = nets["default"][1]
        save_safetensors(tmp_path / "rife_v4.safetensors", published_state_dict("rife", port.state_dict()))
        monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
        frames = [RNG.integers(0, 256, size=(32, 40, 3), dtype=np.uint8) for _ in range(2)]
        got = run_postprocessor("rife_v4", frames, {"multiplier": 2}, device="cpu")
        want = rife.RIFEPostprocessor(model=port)(frames, multiplier=2)
        assert len(got) == 3
        np.testing.assert_array_equal(got[1], want[1])
        # with the checkpoint installed, frame_interpolation runs RIFE
        via_alias = run_postprocessor("rife", frames, {"multiplier": 2}, device="cpu")
        np.testing.assert_array_equal(via_alias[1], want[1])

    def test_setup_raises_without_checkpoint(self, tmp_path, monkeypatch):
        monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))
        with pytest.raises(FileNotFoundError, match="rife_v4"):
            rife.RIFEPostprocessor(device="cpu").setup()

    def test_entry_point_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            rife.RIFEPostprocessor()

    def test_registry(self):
        assert postprocessor_registry.get("rife_v4") is rife.RIFEPostprocessor
        for name in ("frame_interpolation", "rife", "interpolate"):
            assert postprocessor_registry.get(name) is FrameInterpolationPostprocessor


class TestCv2Interpolators:
    def test_frame_interpolation_matches_jax(self, tmp_path, monkeypatch):
        monkeypatch.setenv("APEX_PREPROCESSOR_MODELS_PATH", str(tmp_path))  # no RIFE checkpoint
        base = RNG.integers(0, 256, size=(36, 44, 3), dtype=np.uint8)
        frames = [base, np.roll(base, 3, axis=1), np.roll(base, 5, axis=0)]
        want = jax_interpolate.FrameInterpolationPostprocessor()(frames, multiplier=3)
        got = FrameInterpolationPostprocessor()(frames, multiplier=3)
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_blend_matches_jax(self):
        frames = [RNG.integers(0, 256, size=(8, 10, 3), dtype=np.uint8) for _ in range(3)]
        want = jax_interpolate.BlendInterpolationPostprocessor()(frames, multiplier=4)
        got = BlendInterpolationPostprocessor()(frames, multiplier=4)
        assert len(got) == len(want) == 9
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
