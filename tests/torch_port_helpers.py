"""Helpers shared by the tests that hold the PyTorch port against the JAX package."""

import numpy as np
import torch
from flax import nnx

from apex_studio_tpu_torch.engine.base import materialize_random
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax


def jax_params(model) -> dict:
    """Flat ``{dotted.nnx.path: np.ndarray}`` of a JAX module's parameters."""
    return {".".join(map(str, path)): np.asarray(var.get_value())
            for path, var in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def port_from_jax(build, jax_model):
    """Build a port module on the CPU and carry ``jax_model``'s weights into it."""
    return load_from_jax(materialize_random(build, torch.device("cpu"), seed=0),
                         jax_params(jax_model))


def assert_close(out, ref, rel=1e-4):
    """max|Δ| ≤ rel·max|ref|, in f32."""
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = float(np.abs(out - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-6), (err, float(np.abs(ref).max()))
