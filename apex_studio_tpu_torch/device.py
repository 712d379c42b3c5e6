"""Device selection for the port's entry points, and cuDNN's deterministic
algorithms for a block."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises: the port
    never drops to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms for the block: a transposed
    convolution runs as a convolution's backward pass, which cuDNN may sum in
    a different order from one call to the next."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved
