"""Schedulers of the port: the flow-match Euler samplers, FlowUniPC and CogVideoX's DDIM."""

from apex_studio_tpu_torch.schedulers import ddim, flow_match, unipc  # noqa: F401  (registers)
from apex_studio_tpu_torch.schedulers.base import (  # noqa: F401
    compute_dynamic_shift_mu,
    create_scheduler,
    scheduler_registry,
)
