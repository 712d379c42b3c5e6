"""Postprocessor framework (port of ``apex_studio_tpu/postprocess/base.py``).

A postprocessor takes a list of HWC uint8 frames and returns another. Learned
ones run on ``device``: the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from apex_studio_tpu_torch.registry import Registry
from apex_studio_tpu_torch.utils.progress import ProgressCallback

postprocessor_registry = Registry("postprocessor")


class BasePostprocessor:
    name: str = ""

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        self.device = device

    def setup(self) -> None:
        pass

    def __call__(
        self,
        frames: Sequence[np.ndarray],
        progress_callback: Optional[ProgressCallback] = None,
        **params: Any,
    ) -> List[np.ndarray]:
        raise NotImplementedError


def run_postprocessor(
    name: str,
    frames: Sequence[np.ndarray],
    params: Optional[Dict[str, Any]] = None,
    progress_callback: Optional[ProgressCallback] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> List[np.ndarray]:
    cls = postprocessor_registry.get(name)
    proc = cls(device=device) if isinstance(cls, type) else cls
    proc.setup()
    return proc(frames, progress_callback=progress_callback, **(params or {}))
