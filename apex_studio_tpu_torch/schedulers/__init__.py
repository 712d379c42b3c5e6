"""Schedulers of the port (the flow-match Euler samplers so far)."""

from apex_studio_tpu_torch.schedulers import flow_match  # noqa: F401  (registers)
from apex_studio_tpu_torch.schedulers.base import (  # noqa: F401
    compute_dynamic_shift_mu,
    create_scheduler,
    scheduler_registry,
)
