"""Where a DiT's bf16 distance from f32 at its published width comes from:
the port's bf16 forward against the JAX module's bf16 forward of the same
weights, on the CPU, both against the port's f32 forward of those weights
(rounded to bf16, so that every forward holds the same values). A 1 + 1-block
FLUX.2 DiT at 48 heads of 128 (6144 wide, the 15360-wide context) and a
1 + 1-block HunyuanVideo DiT at 24 heads of 128 (token_replace), the shapes
``chip_smoke.py`` holds on the card.

Two weight recipes: ``synthetic``, the smoke run's (every floating tensor
normal(0, 0.02), ``materialize_random``), carried from the port into the JAX
module; ``jax``, the CPU tests' (``jax_build``: kernels normal(0,
1/√fan_in), norm scales 1 + normal(0, 0.05)), carried from the JAX module.

If the two bf16 forwards agree far more closely than either agrees with f32,
or are as far from f32 as each other, the distance is bf16 rounding and not
a port fault. A 48-head model takes 18–27 GB of host memory at its peak, so
this is a script, not a Tier-1 test:

    JAX_PLATFORMS=cpu python -m tests.torch_bf16_width [flux2|hunyuanvideo] [synthetic|jax] [heads]

It prints one JSON line: the relative L2 distances (port bf16 vs f32, JAX
bf16 vs f32, port bf16 vs JAX bf16).
"""

import gc
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from apex_studio_tpu.models.transformers import flux2 as jax_flux2
from apex_studio_tpu.models.transformers import hunyuanvideo as jax_hv
from apex_studio_tpu_torch.engine.base import materialize_random
from apex_studio_tpu_torch.loaders.from_jax import convert_jax_params, load_from_jax
from apex_studio_tpu_torch.models.transformers import flux2
from apex_studio_tpu_torch.models.transformers import hunyuanvideo as hv
from tests.torch_port_helpers import jax_build, jax_params


def rel_l2(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def models(name: str, heads: int):
    """(JAX build in bf16, port build for a dtype, numpy inputs, JAX
    forward, port forward) at the smoke run's shapes."""
    rng = np.random.default_rng(13)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    bf16 = dict(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    if name == "flux2":
        kw = dict(num_layers=1, num_single_layers=1, num_attention_heads=heads)
        call = dict(grid_hw=(8, 8), cond_grids=((4, 4),))
        return (lambda: jax_flux2.Flux2Transformer2DModel(jax_flux2.Flux2Config(**kw), rngs=nnx.Rngs(0), **bf16),
                lambda dt: flux2.Flux2Transformer2DModel(flux2.Flux2Config(**kw), dtype=dt),
                (normal(1, 64, 128), normal(1, 64, 15360), np.array([0.6], np.float32),
                 np.array([4.0], np.float32), normal(1, 16, 128)),
                lambda m, x, s, t, g, c: m(x, s, t, g, cond_tokens=c, **call),
                lambda m, x, s, t, g, c: m(x, s, t, g, cond_tokens=c, **call))
    kw = dict(num_layers=1, num_single_layers=1, num_attention_heads=heads, image_condition_type="token_replace")
    mask = (np.arange(64) < 40)[None].astype(np.int32)
    return (lambda: jax_hv.HunyuanVideoTransformer3DModel(jax_hv.HunyuanVideoConfig(**kw), rngs=nnx.Rngs(0),
                                                             **bf16),
            lambda dt: hv.HunyuanVideoTransformer3DModel(hv.HunyuanVideoConfig(**kw), dtype=dt),
            (normal(1, 16, 2, 16, 16), np.array([700.0], np.float32), normal(1, 64, 4096), mask,
             normal(1, 768), np.array([6000.0], np.float32)),
            lambda m, x, t, txt, k, p, g: m(x, t, txt, k, pooled=p, guidance=g),
            lambda m, x, t, txt, k, p, g: m(x, t, txt, k, pooled=p, guidance=g))


def jax_from_port(build, state) -> nnx.Module:
    """The JAX module ``build`` makes, abstractly, filled from a port state
    dict (the inverse of ``loaders/from_jax.py`` for Linear kernels)."""
    model = nnx.eval_shape(build)
    params = nnx.state(model, nnx.Param)
    for path, var in nnx.to_flat_state(params):
        key = ".".join(map(str, path))
        shape = tuple(var.get_value().shape)
        (port_key, _), = convert_jax_params({key: np.zeros(shape, np.float32)}).items()
        value = state[port_key].float().numpy()
        value = value.T if value.ndim == 2 and key.endswith("kernel") else value
        var.set_value(jnp.asarray(value.reshape(shape), var.get_value().dtype))
    nnx.update(model, params)
    return model


def readings(name: str, recipe: str, heads: int) -> dict:
    build_jax, build_port, inputs, fwd_jax, fwd_port = models(name, heads)
    if recipe == "synthetic":
        port = materialize_random(lambda: build_port(torch.float32), torch.device("cpu"), seed=31)
        with torch.no_grad():
            for prm in port.parameters():
                prm.copy_(prm.to(torch.bfloat16).float())
        state = port.state_dict()
        del port
        jm = jax_from_port(build_jax, state)
    else:
        jm = jax_build(build_jax, seed=31)
        state = None
    out_jax = np.asarray(nnx.jit(fwd_jax)(jm, *(jnp.asarray(a) for a in inputs)).astype(jnp.float32))
    params = jax_params(jm)
    del jm
    gc.collect()
    jax.clear_caches()

    def run(dtype):
        module = materialize_random(lambda: build_port(dtype), torch.device("cpu"), seed=0)
        if state is not None:
            module.load_state_dict(state)
        else:
            load_from_jax(module, params)
        with torch.inference_mode():
            out = fwd_port(module, *(torch.from_numpy(a) for a in inputs)).float().numpy()
        del module
        gc.collect()
        return out

    out_bf16, out_f32 = run(torch.bfloat16), run(torch.float32)
    return {"model": name, "weights": recipe, "heads": heads, "dim": heads * 128,
            "rel_l2_port_bf16_vs_f32": rel_l2(out_bf16, out_f32), "rel_l2_jax_bf16_vs_f32": rel_l2(out_jax, out_f32),
            "rel_l2_port_bf16_vs_jax_bf16": rel_l2(out_bf16, out_jax)}


if __name__ == "__main__":
    name = sys.argv[1] if len(sys.argv) > 1 else "flux2"
    recipe = sys.argv[2] if len(sys.argv) > 2 else "synthetic"
    heads = int(sys.argv[3]) if len(sys.argv) > 3 else (48 if name == "flux2" else 24)
    print(json.dumps(readings(name, recipe, heads)), flush=True)
