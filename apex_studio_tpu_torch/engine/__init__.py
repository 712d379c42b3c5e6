"""Engines of the port."""

from apex_studio_tpu_torch.engine.registry import UniversalEngine  # noqa: F401
