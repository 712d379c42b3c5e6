"""Preprocessor framework of the port (port of ``apex_studio_tpu/preprocess``):
the registry, ``run_preprocessor`` and ``load_frames``, and the detectors
ported so far, registered on import in the JAX package's order (so that the
registry lists them as the JAX registry does): the weight-free cv2 family
(``basic``, ``basic2``, ``basic3``), TEED, U²-Net (rembg), HED, the lineart
generator, PiDiNet, Depth Anything V2, OpenPose, DWPose, M-LSD, Manga Line,
the ``transformers`` delegates (``depth_hf``: MiDaS, ZoeDepth, Depth Anything
v1; ``segmentation``: SegFormer, OneFormer, the gated stubs and DensePose),
UniMatch / GMFlow optical flow, the anime lineart U-Net, the anime face
segmenter, the wan-animate pose family with NLF (``pose2d``), NormalBAE,
DSINE, Metric3D and LeReS: every name the JAX registry has."""

from apex_studio_tpu_torch.preprocess.base import BasePreprocessor, preprocessor_registry, run_preprocessor  # noqa: F401
from apex_studio_tpu_torch.preprocess import basic  # noqa: F401  (registration side effects)
from apex_studio_tpu_torch.preprocess import basic2  # noqa: F401
from apex_studio_tpu_torch.preprocess import basic3  # noqa: F401
from apex_studio_tpu_torch.preprocess import teed  # noqa: F401
from apex_studio_tpu_torch.preprocess import u2net  # noqa: F401
from apex_studio_tpu_torch.preprocess import hed  # noqa: F401
from apex_studio_tpu_torch.preprocess import lineart_model  # noqa: F401
from apex_studio_tpu_torch.preprocess import pidinet  # noqa: F401
from apex_studio_tpu_torch.preprocess import depth_anything  # noqa: F401
from apex_studio_tpu_torch.preprocess import openpose  # noqa: F401
from apex_studio_tpu_torch.preprocess import dwpose  # noqa: F401
from apex_studio_tpu_torch.preprocess import mlsd  # noqa: F401
from apex_studio_tpu_torch.preprocess import manga_line  # noqa: F401
from apex_studio_tpu_torch.preprocess import depth_hf  # noqa: F401
from apex_studio_tpu_torch.preprocess import segmentation  # noqa: F401  (DensePose too)
from apex_studio_tpu_torch.preprocess import unimatch  # noqa: F401
from apex_studio_tpu_torch.preprocess import lineart_anime  # noqa: F401
from apex_studio_tpu_torch.preprocess import anime_seg  # noqa: F401
from apex_studio_tpu_torch.preprocess import pose2d  # noqa: F401
from apex_studio_tpu_torch.preprocess import normalbae  # noqa: F401
from apex_studio_tpu_torch.preprocess import dsine  # noqa: F401
from apex_studio_tpu_torch.preprocess import metric3d  # noqa: F401
from apex_studio_tpu_torch.preprocess import leres  # noqa: F401
