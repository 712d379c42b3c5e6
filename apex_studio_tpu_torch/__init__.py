"""PyTorch/CUDA port of apex_studio_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package imports ``torch``
and never ``jax``, ``flax`` or ``apex_studio_tpu``: what it needs from JAX-free
modules there it keeps as its own copies. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
