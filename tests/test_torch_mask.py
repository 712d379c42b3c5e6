"""The port's point-mask segmenter and tracker against the JAX package's
``mask/segment.py``, on the same frames: masks, contours and shape bounds
equal. Both run numpy and OpenCV on the host. The JAX side runs with its
SAM2 predictor lookup answering "none configured", so it takes GrabCut (and
fetches no checkpoint); the port raises where a SAM2 checkpoint is configured.

Frames: eight 96 × 160 frames of a bright disk moving 3 px a frame over dark
noise (the bench leg's clip at a fifth of its size).
"""

import numpy as np
import pytest

from apex_studio_tpu.mask import predictor as jax_predictor
from apex_studio_tpu.mask import segment as jax_segment
from apex_studio_tpu_torch import mask as port_mask
from apex_studio_tpu_torch.mask import segment


def clip(n=8, h=96, w=160):
    rng = np.random.default_rng(0)
    frames, disks = [], []
    yy, xx = np.mgrid[:h, :w]
    for i in range(n):
        img = rng.integers(0, 30, (h, w, 3)).astype(np.uint8)
        disk = (yy - 48) ** 2 + (xx - 40 - 3 * i) ** 2 <= 14 ** 2
        img[disk] = [200, 80, 80]
        frames.append(img)
        disks.append(disk)
    return frames, disks


FRAMES, DISKS = clip()
PROMPTS = {
    "touch": dict(points=[{"x": 40, "y": 48}]),
    "negative_point": dict(points=[{"x": 40, "y": 48}, {"x": 120, "y": 20}], point_labels=[1, 0]),
    "box": dict(points=[], box={"x1": 20, "y1": 28, "x2": 62, "y2": 70}, tool="shape"),
    "lasso": dict(points=[{"x": 40 + 18 * np.cos(a), "y": 48 + 18 * np.sin(a)}
                          for a in np.linspace(0, 2 * np.pi, 10, endpoint=False)], tool="lasso"),
}


@pytest.fixture()
def no_sam2(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_predictor, "get_sam2_predictor", lambda: None)
    monkeypatch.delenv("APEX_SAM2_PATH", raising=False)
    monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
    monkeypatch.delenv("APEX_PREPROCESSOR_MODELS_PATH", raising=False)


@pytest.mark.parametrize("prompt", list(PROMPTS))
def test_masks_equal_jax(no_sam2, prompt):
    want = jax_segment.mask_from_points(FRAMES[0], **PROMPTS[prompt])
    got = port_mask.mask_from_points(FRAMES[0], **PROMPTS[prompt])
    assert got.dtype == np.uint8 and got.shape == (96, 160)
    np.testing.assert_array_equal(got, want)
    if prompt == "lasso":  # the lasso seeds GrabCut with its polygon, no rectangle
        assert got[48, 40] == 1
    else:
        assert (got.astype(bool) & DISKS[0]).sum() / (got.astype(bool) | DISKS[0]).sum() > 0.9


@pytest.mark.parametrize("direction,start,refine", [("forward", 0, 8), ("both", 4, 2)])
def test_tracking_equals_jax(no_sam2, direction, start, refine):
    initial = port_mask.mask_from_points(FRAMES[start], **PROMPTS["touch"]) if start == 0 else \
        DISKS[start].astype(np.uint8)
    want = jax_segment.track_mask(FRAMES, initial, start, direction, refine_every=refine)
    seen = []
    got = port_mask.track_mask(FRAMES, initial, start, direction, refine_every=refine,
                               frame_callback=lambda i, m: seen.append(i))
    assert sorted(got) == sorted(want) == list(range(8))
    for i in got:
        np.testing.assert_array_equal(got[i], want[i])
    assert sorted(seen) == [i for i in range(8) if i != start]


def test_contours_and_shape_bounds_equal_jax(no_sam2):
    mask = port_mask.mask_from_points(FRAMES[0], **PROMPTS["touch"])
    contours = port_mask.mask_to_contours(mask)
    assert contours == jax_segment.mask_to_contours(mask) and len(contours) == 1
    for shape in (None, "ellipse", "star", "polygon", "rectangle"):
        assert (port_mask.shape_bounds_from_contours(contours, shape)
                == jax_segment.shape_bounds_from_contours(contours, shape))
    assert port_mask.mask_from_box(FRAMES[0], PROMPTS["box"]["box"]).sum() == \
        jax_segment.mask_from_box(FRAMES[0], PROMPTS["box"]["box"]).sum()


@pytest.mark.parametrize("where", ["env", "preprocessor_models"])
def test_configured_sam2_raises(no_sam2, monkeypatch, tmp_path, where):
    if where == "env":
        monkeypatch.setenv("APEX_SAM2_PATH", str(tmp_path / "sam2.1_hiera_tiny.pt"))
    else:
        ckpt = tmp_path / "home" / "preprocessor_models" / "sam2" / "sam2.1_hiera_base_plus.pt"
        ckpt.parent.mkdir(parents=True)
        ckpt.write_bytes(b"\0")
    assert segment.sam2_checkpoint_configured() is not None
    for prompt in ("touch", "box"):
        with pytest.raises(NotImplementedError, match="SAM2"):
            port_mask.mask_from_points(FRAMES[0], **PROMPTS[prompt])
    # a lasso never took SAM2 in the JAX module either
    assert port_mask.mask_from_points(FRAMES[0], **PROMPTS["lasso"])[48, 40] == 1


def test_no_sam2_configured_takes_grabcut(no_sam2):
    assert segment.sam2_checkpoint_configured() is None
