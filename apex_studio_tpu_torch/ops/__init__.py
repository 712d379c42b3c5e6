"""Shared ops of the port: attention, norms, RoPE, embeddings (EasyCache step
skipping in ops/easycache.py)."""

from apex_studio_tpu_torch.ops.attention import attention  # noqa: F401
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding  # noqa: F401
from apex_studio_tpu_torch.ops.norms import gate, layer_norm, modulate, rms_norm  # noqa: F401
from apex_studio_tpu_torch.ops.rope import apply_rope, precompute_axial_freqs  # noqa: F401
