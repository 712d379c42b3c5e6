"""Schedulers of the port: the flow-match Euler samplers, FlowUniPC, CogVideoX's DDIM and the
rectified-flow sampler (LTX-Video)."""

from apex_studio_tpu_torch.schedulers import ddim, flow_match, rectified_flow, unipc  # noqa: F401  (registers)
from apex_studio_tpu_torch.schedulers.base import (  # noqa: F401
    compute_dynamic_shift_mu,
    create_scheduler,
    scheduler_registry,
)
