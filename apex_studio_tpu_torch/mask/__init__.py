"""Point / box masks and their tracking across frames (port of
``apex_studio_tpu/mask``): SAM2 (``sam2.py``, ``predictor.py``) where a
checkpoint is configured or on disk, else the classical segmenter."""

from apex_studio_tpu_torch.mask.segment import (  # noqa: F401
    mask_from_box,
    mask_from_points,
    mask_to_contours,
    shape_bounds_from_contours,
    track_mask,
)
