"""BaseEngine — manifest-driven pipeline base (port of
``apex_studio_tpu/engine/base.py``, the parts the Flux t2i path runs).

- parses the normalized manifest config and resolves component paths
- instantiates components lazily on ``self.device``: the scheduler from its
  registry, transformer / VAE / text encoders from the model registries
- synthetic weights (``APEX_SYNTHETIC_WEIGHTS=bf16``): each module is built on
  the ``meta`` device, materialized with ``to_empty`` on the target device and
  filled there with normal(0, 0.02) from a generator seeded by the component
- the seed→latent contract (CPU ``torch.Generator``), timestep handling and
  frame post-processing
"""

from __future__ import annotations

import json
import logging
import os
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from apex_studio_tpu_torch.device import resolve_device
from apex_studio_tpu_torch.utils.progress import ProgressCallback, safe_emit_progress

logger = logging.getLogger("apex.engine")

_DTYPES = {
    "fp32": torch.float32,
    "float32": torch.float32,
    # the JAX package maps 16-bit manifests to bf16 (its one 16-bit type); so does the port
    "fp16": torch.bfloat16,
    "float16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
}

SYNTHETIC_STD = 0.02


def configure_float32_matmul() -> None:
    """Float32 matmuls and convolutions run in full f32, not TF32. The VAE
    runs in f32 (manifest precision) and is compared with the JAX package in
    f32; TF32 keeps ~3 decimal digits and cuDNN would use it for f32 convs by
    default. The bf16 DiT and encoders are unaffected by either flag."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class BaseEngine:
    def __init__(
        self,
        config: Dict[str, Any],
        yaml_path: Optional[Path] = None,
        model_type: Optional[str] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
        components_root: Optional[Path] = None,
        selected_components: Optional[Dict[str, Any]] = None,
        **kwargs: Any,
    ):
        from apex_studio_tpu_torch.utils.defaults import get_components_path

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            configure_float32_matmul()
        self.config = config
        self.yaml_path = yaml_path
        self.model_type = model_type or config.get("type")
        self.components_root = Path(components_root or get_components_path())
        self.selected_components = selected_components or {}
        self.defaults: Dict[str, Any] = dict(config.get("defaults") or {})

        self.component_specs: Dict[str, Dict[str, Any]] = {}
        for comp in config.get("components", []) or []:
            self.component_specs[comp.get("name") or comp["type"]] = comp

        self.scheduler = None
        self.transformer = None
        self.vae = None
        self.text_encoder = None

    # -- path resolution -----------------------------------------------------------

    def _resolve_path(self, ref: Optional[str]) -> Optional[Path]:
        """Manifest path (HF-repo-relative) → local file/dir under components/."""
        if not ref:
            return None
        p = Path(ref)
        if p.is_absolute() and p.exists():
            return p
        local = self.components_root / ref
        if local.exists():
            return local
        if p.exists():
            return p.resolve()
        return None

    def _spec_for_type(self, ctype: str) -> Optional[Dict[str, Any]]:
        for spec in self.component_specs.values():
            if spec.get("type") == ctype:
                return spec
        return None

    def _load_component_config(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        extra = spec.get("extra_kwargs") if isinstance(spec.get("extra_kwargs"), dict) else {}
        if isinstance(spec.get("config"), dict):
            return {**spec["config"], **extra}
        cfg_path = self._resolve_path(spec.get("config_path"))
        if cfg_path is None and spec.get("config_path"):
            raise FileNotFoundError(
                f"component config not found locally: {spec['config_path']} "
                f"(searched under {self.components_root})")
        if cfg_path is None:
            return dict(extra)
        if cfg_path.is_dir():
            cfg_path = cfg_path / "config.json"
        return {**json.loads(cfg_path.read_text()), **extra}

    def _component_dtype(self, spec: Dict[str, Any]) -> torch.dtype:
        sel = self.selected_components.get(spec.get("type"), {})
        prec = sel.get("precision") or spec.get("precision") or "bf16"
        return _DTYPES.get(str(prec).lower(), torch.bfloat16)

    # -- component loading ------------------------------------------------------------

    def release_text_encoders(self, names=None) -> None:
        """Drop text-encoder weights after conditioning is encoded. Repeat
        prompts rebuild nothing (TextEncoder.encode is disk-cached)."""
        for attr in names or ("text_encoder", "text_encoder_2", "text_encoder_3"):
            te = getattr(self, attr, None)
            if te is not None and hasattr(te, "release"):
                te.release()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def maybe_release_text_encoders(self, names=None) -> None:
        """release_text_encoders unless ``APEX_RELEASE_TEXT_ENCODERS=0``: the
        port runs on one device, where releasing is what the JAX engine does."""
        if os.environ.get("APEX_RELEASE_TEXT_ENCODERS") == "0":
            return
        self.release_text_encoders(names)

    def load_component_by_type(self, ctype: str, progress: Optional[ProgressCallback] = None):
        spec = self._spec_for_type(ctype)
        if spec is None:
            raise KeyError(f"manifest has no {ctype} component")
        loader = getattr(self, f"_load_{ctype}", None)
        if loader is None:
            raise KeyError(f"no loader for component type {ctype}")
        safe_emit_progress(progress, 0.0, f"Loading {ctype}")
        component = loader(spec)
        setattr(self, ctype, component)
        safe_emit_progress(progress, 1.0, f"{ctype} ready")
        return component

    def _load_scheduler(self, spec: Dict[str, Any]):
        from apex_studio_tpu_torch.schedulers import create_scheduler

        sel = self.selected_components.get("scheduler", {})
        opts = spec.get("scheduler_options") or []
        base = spec.get("base")
        cfg_path = spec.get("config_path")
        chosen = sel.get("name") or spec.get("default")
        for opt in opts:
            if opt.get("name") == chosen or (chosen is None and opt is opts[0]):
                base = opt.get("base", base)
                cfg_path = opt.get("config_path", cfg_path)
                break
        if base is None and opts:
            base = opts[0].get("base")
            cfg_path = opts[0].get("config_path", cfg_path)
        cfg: Dict[str, Any] = {}
        if isinstance(spec.get("config"), dict):
            cfg = dict(spec["config"])
        else:
            local = self._resolve_path(cfg_path)
            if local is not None:
                cfg = json.loads(local.read_text())
        kwargs = spec.get("extra_kwargs") or {}
        return create_scheduler(base or "FlowMatchEulerDiscreteScheduler", cfg or None, **kwargs)

    def _instantiate_family(self, registry, spec: Dict[str, Any], converter_family: str):
        """Shared loader for transformer / VAE / text-encoder families.

        Weights are random, from a generator seeded by the component:
        ``APEX_SYNTHETIC_WEIGHTS=bf16`` (the full-size dry run) or a manifest
        component with no ``model_path`` (the tiny test models, whose weights
        tests then carry over from the JAX package). Loading real checkpoints
        is not ported yet and raises."""
        from apex_studio_tpu_torch.models.layers import check_residency
        from apex_studio_tpu_torch.models.registry import _load_builtin_families

        _load_builtin_families()
        base = spec.get("base")
        cls = registry.get(base)
        synth = os.environ.get("APEX_SYNTHETIC_WEIGHTS", "")
        if synth:
            check_residency(synth)
        elif spec.get("model_path"):
            raise NotImplementedError(
                f"loading checkpoints for {base} is not ported yet (a later slice ports "
                "loaders/converters.py and safetensors_io.py); set APEX_SYNTHETIC_WEIGHTS=bf16")
        try:
            cfg_dict = self._load_component_config(spec)
        except FileNotFoundError:
            if not synth:
                raise
            cfg_dict = None  # synthetic mode: family defaults stand in
        cfg = cls.config_class.from_dict(cfg_dict) if cfg_dict else cls.config_class()
        dtype = self._component_dtype(spec)
        seed = zlib.crc32(f"{base}/{converter_family}".encode()) & 0x7FFFFFFF
        model = materialize_random(lambda: cls(cfg, dtype=dtype), self.device, seed)
        logger.info("random weights for %s on %s (seed %d)", base, self.device, seed)
        return model

    def _load_transformer(self, spec: Dict[str, Any]):
        base = spec.get("base") or ""
        return self._instantiate_family(_registry("transformer"), spec, base.split(".")[0])

    def _load_vae(self, spec: Dict[str, Any]):
        base = spec.get("base") or "auto"
        family = "autoencoder_kl" if base in ("auto", "AutoencoderKL") else base.split(".")[0]
        return self._instantiate_family(_registry("vae"), spec, family)

    def _load_text_encoder(self, spec: Dict[str, Any]):
        from apex_studio_tpu_torch.text_encoder import TextEncoder

        return TextEncoder(self, spec)

    # -- seed → latents contract ----------------------------------------------------

    def get_latents(self, shape: Tuple[int, ...], seed: Optional[int] = None,
                    latents: Optional[np.ndarray] = None) -> torch.Tensor:
        """Initial noise: f32 normal at ``shape`` from a CPU ``torch.Generator``
        (so a seed gives the JAX package's noise bit for bit), then moved to
        the engine's device."""
        if latents is not None:
            return torch.as_tensor(np.asarray(latents), dtype=torch.float32).to(self.device)
        gen = torch.Generator("cpu")
        if seed is not None:
            gen.manual_seed(int(seed))
        noise = torch.randn(shape, generator=gen, dtype=torch.float32)
        return noise.to(self.device)

    # -- timesteps ------------------------------------------------------------------

    def get_timesteps(
        self,
        scheduler,
        num_inference_steps: int,
        timesteps: Optional[List[float]] = None,
        sigmas: Optional[List[float]] = None,
        **set_kwargs: Any,
    ) -> Tuple[np.ndarray, int]:
        """Explicit integer timesteps are *indices into the 1000-step training
        schedule*; floats are values."""
        if timesteps is not None:
            full = getattr(scheduler, "num_train_timesteps", 1000)
            ts = np.asarray(timesteps, np.float64)
            if np.all(np.abs(ts - np.round(ts)) < 1e-9) and ts.max() < full:
                grid = np.linspace(1.0, 1.0 / full, full)
                from apex_studio_tpu_torch.schedulers.base import shift_sigmas

                shift = getattr(scheduler, "shift", 1.0)
                sig = shift_sigmas(grid, shift)[ts.astype(int)]
                scheduler.set_timesteps(len(ts), sigmas=sig, **set_kwargs)
            else:
                scheduler.set_timesteps(len(ts), **set_kwargs)
            return scheduler.timesteps, len(scheduler.timesteps)
        if sigmas is not None:
            scheduler.set_timesteps(len(sigmas), sigmas=np.asarray(sigmas), **set_kwargs)
            return scheduler.timesteps, len(scheduler.timesteps)
        scheduler.set_timesteps(num_inference_steps, **set_kwargs)
        return scheduler.timesteps, num_inference_steps

    # -- postprocessing ----------------------------------------------------------------

    @staticmethod
    def tensor_to_frames(img: torch.Tensor) -> List[np.ndarray]:
        """[B,3,H,W] in [-1,1] → list of HWC uint8 frames."""
        arr = ((img.float() + 1.0) / 2.0).clamp(0.0, 1.0).cpu().numpy()
        arr = (arr * 255.0 + 0.5).astype(np.uint8)
        return [np.transpose(a, (1, 2, 0)) for a in arr]

    def run(self, **kwargs: Any):  # pragma: no cover - interface
        raise NotImplementedError


def _registry(kind: str):
    from apex_studio_tpu_torch.models import registry

    return getattr(registry, f"{kind}_registry")


def materialize_random(build, device: torch.device, seed: int, std: float = SYNTHETIC_STD):
    """Build a module on the ``meta`` device (no host allocation), give it
    storage on ``device`` and fill every floating tensor with normal(0, std)
    from a generator on that device."""
    with torch.device("meta"):
        model = build()
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if t.is_floating_point():
                t.normal_(0.0, std, generator=gen)
    return model.eval().requires_grad_(False)
