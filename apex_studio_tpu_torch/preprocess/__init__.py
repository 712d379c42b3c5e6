"""Preprocessor framework of the port (port of ``apex_studio_tpu/preprocess``):
the registry, ``run_preprocessor`` and ``load_frames``, and the detectors
ported so far, registered on import: the weight-free cv2 family
(``basic``, ``basic2``, ``basic3``), Depth Anything V2 and OpenPose."""

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, preprocessor_registry, run_preprocessor  # noqa: F401
from apex_studio_tpu_torch.preprocess import basic  # noqa: F401  (registration side effects)
from apex_studio_tpu_torch.preprocess import basic2  # noqa: F401
from apex_studio_tpu_torch.preprocess import basic3  # noqa: F401
from apex_studio_tpu_torch.preprocess import depth_anything  # noqa: F401
from apex_studio_tpu_torch.preprocess import openpose  # noqa: F401
