"""Postprocessors of the port: the cv2 frame interpolators, RIFE and the
Cosmos guardrail."""

from apex_studio_tpu_torch.postprocess.base import (  # noqa: F401
    BasePostprocessor,
    postprocessor_registry,
    run_postprocessor,
)
from apex_studio_tpu_torch.postprocess import interpolate  # noqa: F401  (registration)
from apex_studio_tpu_torch.postprocess import rife  # noqa: F401  (registration)
from apex_studio_tpu_torch.postprocess import guardrail  # noqa: F401  (registration)
