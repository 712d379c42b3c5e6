"""Helpers shared by the tests that hold the PyTorch port against the JAX package.

Under pytest-xdist every worker is a process of its own, and torch's default
of one intra-op thread per core would then oversubscribe the cores as many
times over as there are workers; each worker takes its share of the cores
instead. Every worker imports this module while it collects the port's test
files, so the share holds for the whole run of each worker. A run in one
process keeps torch's default.

torch's CPU arithmetic runs with denormals flushed to zero, as XLA's CPU
backend computes for the JAX reference: seeded weights shrink some
activations into the denormal range, where x86 arithmetic runs some 30×
slower.
"""

import os
import zlib

import jax
import numpy as np
import torch
from flax import nnx

from apex_studio_tpu_torch.engine.base import materialize_random
from apex_studio_tpu_torch.loaders.from_jax import load_from_jax

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
torch.set_flush_denormal(True)


def jax_build(build, seed: int = 0):
    """The JAX module ``build()`` makes, built abstractly (``nnx.eval_shape``:
    no initialiser runs, and on the CPU each initialiser compiles a program
    per parameter shape) and filled from a seeded numpy generator: kernels
    normal(0, 1/√fan_in), biases normal(0, 0.05), other 1-D parameters (norm
    scales) 1 + normal(0, 0.05), anything else normal(0, 0.02). A module
    with state other than parameters is built as it is."""
    model = nnx.eval_shape(build)
    _, _, rest = nnx.split(model, nnx.Param, ...)
    if jax.tree.leaves(rest):
        return build()
    rng = np.random.default_rng(seed)
    state = nnx.state(model, nnx.Param)
    for path, var in nnx.to_flat_state(state):
        name, shape = str(path[-1]), tuple(var.get_value().shape)
        if name == "kernel" or name.endswith("_kernel"):
            val = rng.normal(size=shape) / np.sqrt(max(1, int(np.prod(shape[:-1]))))
        elif name == "bias" or name.endswith("_bias"):
            val = 0.05 * rng.normal(size=shape)
        elif len(shape) == 1:
            val = 1.0 + 0.05 * rng.normal(size=shape)
        else:
            val = 0.02 * rng.normal(size=shape)
        var.set_value(jax.numpy.asarray(val.astype(var.get_value().dtype)))
    nnx.update(model, state)
    return model


_SEEDED = {}


def fast_jax_engine(engine):
    """Make a JAX engine build its components without flax's initialisers: a
    component with a checkpoint is built abstractly and filled from it as the
    JAX loader fills it (converter, strict apply), one without gets
    :func:`jax_build`'s values, seeded by the component. A seeded component
    is built once a worker and handed out as clones (``nnx.clone``: its own
    variables over the same immutable arrays), so an engine that reloads a
    component, or a test that rebuilds it, traces no constructor again."""
    from apex_studio_tpu.loaders.converters import convert_keys, converter_registry
    from apex_studio_tpu.loaders.state_mapping import apply_state_dict
    from apex_studio_tpu.models.registry import _load_builtin_families

    def instantiate(registry, spec, converter_family):
        _load_builtin_families()
        base = spec.get("base")
        cls = registry.get(base)
        cfg_dict = engine._load_component_config(spec)
        cfg = cls.config_class.from_dict(cfg_dict) if cfg_dict else cls.config_class()
        dtype = engine._component_dtype(spec)
        build = lambda: cls(cfg, dtype=dtype, param_dtype=dtype, rngs=nnx.Rngs(0))  # noqa: E731
        sd = engine._load_state_dict(spec)
        if sd is None:
            key = (cls, base, converter_family, repr(cfg), str(dtype))
            if key not in _SEEDED:
                _SEEDED[key] = jax_build(build, seed=zlib.crc32(f"{base}/{converter_family}".encode()))
            return nnx.clone(_SEEDED[key])
        family = converter_family if converter_family in converter_registry else None
        model = nnx.eval_shape(build)
        apply_state_dict(model, convert_keys(family, sd) if family else sd, strict=True)
        return model

    engine._instantiate_family = instantiate
    return engine


def jitted(model, fn, *args):
    """``fn(model, *args)`` for a JAX module through one ``jax.jit`` over its
    split state (one XLA program, where op-by-op dispatch compiles one a
    primitive and shape), as numpy."""
    graphdef, state = nnx.split(model)
    return np.asarray(jax.jit(lambda s, *a: fn(nnx.merge(graphdef, s), *a))(
        state, *(jax.numpy.asarray(a) for a in args)))


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


def assert_rel_l2(out, ref, tol):
    """‖out − ref‖₂ ≤ tol·‖ref‖₂, in f64."""
    out = out.detach().double().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = float(np.linalg.norm(out - ref)) / max(float(np.linalg.norm(ref)), 1e-30)
    assert err <= tol, err


def assert_published_round_trip(family, build, jax_model):
    """A port module's state under the family's published names
    (``loaders/export.py``) loads back through the port's converter, strictly
    and bit-equal; and the JAX package's converter maps the same names onto
    exactly ``jax_model``'s parameter paths."""
    from apex_studio_tpu.loaders.converters import convert_keys as jax_convert_keys

    from apex_studio_tpu_torch.loaders.converters import convert_keys
    from apex_studio_tpu_torch.loaders.export import published_state_dict
    from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict

    src = materialize_random(build, torch.device("cpu"), seed=3)
    published = published_state_dict(family, src.state_dict())
    assert set(published) != set(src.state_dict())  # the published names differ
    dst = materialize_random(build, torch.device("cpu"), seed=4)
    apply_state_dict(dst, convert_keys(family, published), strict=True)
    for name, value in src.state_dict().items():
        assert torch.equal(dst.state_dict()[name], value), name
    assert set(jax_convert_keys(family, {k: v.numpy() for k, v in published.items()})) == set(jax_params(jax_model))


def jax_build_bn(build, seed: int = 0):
    """``jax_build``, then every inference BatchNorm's running mean (a 1-D
    parameter named ``mean``, ``bn_mean`` or ``running_mean``) redrawn as
    normal(0, 0.05): at ``jax_build``'s 1 + normal(0, 0.05) each BN shifts
    its input down by about one, and a deep stack of BN → ReLU collapses to
    a map that is constant over the image (M-LSD's does)."""
    model = jax_build(build, seed)
    rng = np.random.default_rng(seed + 1)
    state = nnx.state(model, nnx.Param)
    for path, var in nnx.to_flat_state(state):
        if str(path[-1]) in ("mean", "bn_mean", "running_mean"):
            shape = tuple(var.get_value().shape)
            var.set_value(jax.numpy.asarray((0.05 * rng.normal(size=shape)).astype(np.float32)))
    nnx.update(model, state)
    return model


def jax_assign(model, tree) -> None:
    """Set a JAX module's parameters from a converted flat ``{path: array}``
    tree, as the JAX preprocessors assign theirs, but strictly: every key
    names a parameter of the same shape and every parameter is set."""
    state = nnx.state(model, nnx.Param)
    flat = {".".join(map(str, path)): var for path, var in nnx.to_flat_state(state)}
    assert set(flat) == set(tree), (sorted(set(flat) ^ set(tree))[:8])
    for name, var in flat.items():
        value = np.asarray(tree[name], np.float32)
        assert value.shape == tuple(var.get_value().shape), (name, value.shape, var.get_value().shape)
        var.set_value(jax.numpy.asarray(value))
    nnx.update(model, state)


def assert_loads_as_jax(build, tree, jax_model, atol: float = 0.0) -> None:
    """A port module built on ``meta`` and filled strictly from ``tree`` (the
    port converter's output) holds exactly the parameters that ``jax_model``
    (filled by the JAX converter from the same file) carries into it; within
    ``atol`` where a converter computes (PiDiNet's fold sums each kernel, in
    numpy's order on one side and torch's on the other)."""
    from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict

    with torch.device("meta"):
        port = build()
    apply_state_dict(port, tree, device="cpu", strict=True)
    ref = port_from_jax(build, jax_model)
    got, want = port.state_dict(), ref.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        if atol:
            assert float((got[name] - value).abs().max()) <= atol, name
        else:
            assert torch.equal(got[name], value), name
