"""Point / box masks and their tracking across frames (port of
``apex_studio_tpu/mask``, the classical segmenter; SAM2 is not ported)."""

from apex_studio_tpu_torch.mask.segment import (  # noqa: F401
    mask_from_box,
    mask_from_points,
    mask_to_contours,
    shape_bounds_from_contours,
    track_mask,
)
