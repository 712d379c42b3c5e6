"""BaseEngine — manifest-driven pipeline base (port of
``apex_studio_tpu/engine/base.py``, the parts the Flux t2i and HunyuanVideo
1.5 paths run).

- parses the normalized manifest config and resolves component paths
- instantiates components lazily on ``self.device``: the scheduler from its
  registry, transformer / VAE / text encoders from the model registries
- every module is built on the ``meta`` device and gets its storage on the
  target device: from a checkpoint (safetensors / GGUF / torch pickle through
  the family's key converter and a strict state-dict apply, tensor by tensor),
  or, with ``APEX_SYNTHETIC_WEIGHTS=bf16|int8|int4``, random values from a
  generator seeded by the component, large Linear weights straight to int8 /
  int4 residency (quantize/residency.py)
- LoRAs of the manifest and the request merged into the transformer at load,
  and int8 residency as the fallback for a model that crowds the card
- helper components (``load_helper``), the disk-cached VAE encode of
  conditioning pixels, previews through a light TAE decoder, image inputs
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

# VAE bases whose checkpoints another family's converter reads
_VAE_CONVERTERS = {"qwenimage": "wan_vae", "AutoencoderKLQwenImage": "wan_vae"}


def select_variant(model_path: Union[str, List[Dict[str, Any]], None],
                   preferred: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Pick a weight variant from a manifest model_path entry."""
    if model_path is None:
        return None
    if isinstance(model_path, str):
        return {"path": model_path, "variant": "default", "type": "safetensors"}
    if preferred:
        for v in model_path:
            if v.get("variant") == preferred or v.get("precision") == preferred:
                return dict(v)
    # Prefer plain safetensors over quantized formats.
    for v in model_path:
        if v.get("type", "safetensors") == "safetensors" and v.get("precision") not in ("fp8",):
            return dict(v)
    return dict(model_path[0])


def configure_float32_matmul() -> None:
    """Float32 matmuls and convolutions run in full f32, not TF32: the plain
    attention routes and norms compute in f32, and a component built in f32
    is compared with the JAX package in f32. TF32 keeps ~3 decimal digits.
    The bf16 DiTs and encoders are unaffected by either flag."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class BaseEngine:
    # bytes each component built on the card must leave free beside its
    # parameters (``_check_fits``): an engine whose activations are large
    # next to the free memory its weights leave raises it
    resident_headroom_bytes = 0

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
        self.helpers: Dict[str, Any] = {}
        # each component type's parameter bytes as ``_check_fits`` reckoned them
        self.reckoned_bytes: Dict[str, int] = {}
        # one entry per LoRA merged at transformer load: source, scale, applied, skipped
        self.lora_results: List[Dict[str, Any]] = []

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

    def _load_state_dict(self, spec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The component's checkpoint as a flat state dict of CPU tensors
        (numpy arrays from GGUF), or None when the spec names no weights."""
        from apex_studio_tpu_torch.loaders.safetensors_io import dequantize_fp8_scaled

        sel = self.selected_components.get(spec.get("type"), {})
        variant = select_variant(spec.get("model_path"), sel.get("variant"))
        if variant is None:
            return None
        local = self._resolve_path(variant["path"])
        if local is None:
            raise FileNotFoundError(
                f"weights not downloaded: {variant['path']} "
                f"(searched under {self.components_root})")
        if variant.get("type") == "gguf" or str(local).endswith(".gguf"):
            from apex_studio_tpu_torch.quantize.gguf import load_gguf_state_dict

            return load_gguf_state_dict(local)
        sd = self._read_weights_file(local)
        # extra_model_path components that target this component type are
        # merged into its state dict under their key_prefix
        for extra in self.config.get("components", []) or []:
            if extra.get("type") != "extra_model_path":
                continue
            if (extra.get("component") or "transformer") != spec.get("type"):
                continue
            ev = select_variant(extra.get("model_path"), None)
            if ev is None:
                continue
            epath = self._resolve_path(ev["path"])
            if epath is None:
                raise FileNotFoundError(f"extra weights not downloaded: {ev['path']}")
            prefix = extra.get("key_prefix") or ""
            for k, v in self._read_weights_file(Path(epath)).items():
                sd[prefix + k] = v
        return dequantize_fp8_scaled(sd)

    def _read_weights_file(self, local: Path) -> Dict[str, torch.Tensor]:
        from apex_studio_tpu_torch.loaders.safetensors_io import (
            load_safetensors,
            load_sharded_safetensors,
            load_torch_checkpoint,
        )

        local = Path(local)
        if local.is_dir():
            return load_sharded_safetensors(local)
        if local.suffix in (".pth", ".ckpt", ".pt", ".pkl"):
            return load_torch_checkpoint(local)
        return load_safetensors(local)

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

    def load_missing(self, *ctypes: str) -> None:
        """Load each component type the engine does not hold yet."""
        for ctype in ctypes:
            if getattr(self, ctype) is None:
                self.load_component_by_type(ctype)

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
        """Shared loader for transformer / VAE / text-encoder families. The
        module is built on ``meta`` and gets its storage on ``self.device``.

        - ``APEX_SYNTHETIC_WEIGHTS`` set: never touch checkpoints; random
          weights from a generator seeded by the component. ``int8`` (also
          ``1``/``true``) makes large Linear weights int8-resident, ``int4``
          makes the transformer's packed int4 and everything else int8 (the
          encoders stage out after the encode and gain nothing from 4 bits),
          any other value (``bf16``) leaves them in the component's dtype.
        - else a ``model_path``: checkpoint → key converter → strict apply,
          one tensor at a time.
        - else (the tiny test manifests): random weights in the component's
          dtype, which tests then overwrite.

        Before any storage is given: ``_check_fits`` at that residency.
        """
        from apex_studio_tpu_torch.loaders.converters import convert_keys, converter_registry
        from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict
        from apex_studio_tpu_torch.models.registry import _load_builtin_families, transformer_registry
        from apex_studio_tpu_torch.quantize.residency import materialize_random_int4, materialize_random_int8

        _load_builtin_families()
        base = spec.get("base")
        cls = registry.get(base)
        synth = os.environ.get("APEX_SYNTHETIC_WEIGHTS", "")
        try:
            cfg_dict = self._load_component_config(spec)
        except FileNotFoundError:
            if not synth:
                raise
            cfg_dict = None  # synthetic mode: family defaults stand in
        cfg = cls.config_class.from_dict(cfg_dict) if cfg_dict else cls.config_class()
        dtype = self._component_dtype(spec)
        with torch.device("meta"):
            model = cls(cfg, dtype=dtype)
        if synth == "int4" and registry is transformer_registry:
            bits = 4
        elif synth in ("int8", "int4", "1", "true"):
            bits = 8
        else:  # "bf16", a checkpoint, or no checkpoint named: no residency
            bits = None
        self._check_fits(spec, model, bits, dtype)

        sd = None if synth else self._load_state_dict(spec)
        if sd is not None:
            family = converter_family if converter_family in converter_registry else None
            mapped = convert_keys(family, sd) if family else sd
            apply_state_dict(model, mapped, device=self.device, strict=True)
            logger.info("loaded %d tensors for %s onto %s", len(mapped), base, self.device)
            return model.eval().requires_grad_(False)

        seed = zlib.crc32(f"{base}/{converter_family}".encode()) & 0x7FFFFFFF
        if bits == 4:
            n = materialize_random_int4(model, device=self.device, seed=seed, scale=SYNTHETIC_STD)
        elif bits == 8:
            n = materialize_random_int8(model, device=self.device, seed=seed, scale=SYNTHETIC_STD)
        else:  # random weights, no residency
            n = materialize_random_int8(model, device=self.device, seed=seed, scale=SYNTHETIC_STD,
                                        min_numel=1 << 62)
        # Departure from the JAX engine, which draws running statistics like
        # weights (a negative variance makes the Flux 2 VAE's normalization NaN)
        if hasattr(model, "reset_running_stats"):
            model.reset_running_stats()
        logger.info("random %s weights for %s on %s (seed %d, %d resident weights)",
                    synth or "unquantized", base, self.device, seed, n)
        return model.eval().requires_grad_(False)

    def _check_fits(self, spec: Dict[str, Any], model, bits: Optional[int], dtype) -> None:
        """Before a component is built: its parameters' bytes on the ``meta``
        model at the residency about to be applied (``bits``, or ``dtype``
        throughout), kept in ``reckoned_bytes``; on the card, a
        ``MemoryError`` naming that need when it and
        ``resident_headroom_bytes`` exceed the free memory."""
        from apex_studio_tpu_torch.quantize.residency import resident_bytes
        from apex_studio_tpu_torch.utils import memory

        need = resident_bytes(model, bits)
        self.reckoned_bytes[spec.get("type")] = need
        free = memory.free_memory_bytes(self.device)
        if free is not None and need + self.resident_headroom_bytes > free:
            raise MemoryError(
                f"the {spec.get('type')} {spec.get('base')} needs {need / 2**30:.1f} GiB at "
                f"{f'int{bits}' if bits else str(dtype).removeprefix('torch.')} residency plus "
                f"{self.resident_headroom_bytes / 2**30:.0f} GiB beside it; {free / 2**30:.1f} GiB free on "
                f"{self.device}")

    def _load_transformer(self, spec: Dict[str, Any]):
        from apex_studio_tpu_torch.loaders.converters import converter_registry

        base = spec.get("base") or ""
        family = base.split(".")[0]
        # a sub-variant with its own checkpoint layout registers a dotted
        # converter ("wan.flashvsr" → "wan_flashvsr")
        dotted = base.replace(".", "_")
        if dotted != family and dotted in converter_registry:
            family = dotted
        model = self._instantiate_family(_registry("transformer"), spec, family)
        self._apply_loras(model, family)
        self._apply_memory_fallback(model, spec)
        return model

    def _apply_memory_fallback(self, model, spec: Dict[str, Any]) -> None:
        """Oversized-model fallback for one card. Modes (env
        ``APEX_MEMORY_FALLBACK`` > the component's ``memory_fallback`` > the
        manifest's > ``auto``): ``off``, ``int8`` (force int8 residency),
        ``auto`` (int8 residency only when the parameters alone would take
        three quarters of the card's free memory)."""
        from apex_studio_tpu_torch.quantize.residency import apply_int8_residency
        from apex_studio_tpu_torch.utils.memory import should_stream

        mode = (
            os.environ.get("APEX_MEMORY_FALLBACK")
            or spec.get("memory_fallback")
            or self.config.get("memory_fallback")
            or "auto"
        )
        if mode in ("off", "none", "0"):
            return
        if mode == "int8":
            n = apply_int8_residency(model)
            logger.info("int8 residency forced: %d weights quantized", n)
        elif should_stream(model, device=self.device):
            n = apply_int8_residency(model)
            logger.warning("model crowds the card's free memory; int8 residency applied to %d "
                           "weights (set APEX_MEMORY_FALLBACK=off to disable)", n)

    def _apply_loras(self, model, converter_family: str) -> None:
        """Merge manifest + request-selected LoRAs into the transformer
        weights at load time. A source that is not on disk is skipped with a
        warning; what was merged is recorded in ``self.lora_results``."""
        entries = list(self.config.get("loras") or [])
        entries += list(self.selected_components.get("loras") or [])
        if not entries:
            return
        from apex_studio_tpu_torch.lora.manager import LoraManager, LoraSpec

        mgr = LoraManager()
        for entry in entries:
            spec = LoraSpec.from_manifest_entry(entry)
            if not spec.source:
                continue
            try:
                applied, skipped = mgr.load_into(model, spec, converter_family=converter_family)
            except FileNotFoundError as e:
                logger.warning("skipping LoRA %s: %s", spec.source, e)
                continue
            self.lora_results.append({"source": spec.source, "scale": spec.scale,
                                      "applied": applied, "skipped": skipped})

    def _load_vae(self, spec: Dict[str, Any]):
        from apex_studio_tpu_torch.loaders.converters import converter_registry

        base = spec.get("base") or "auto"
        family = "autoencoder_kl" if base in ("auto", "AutoencoderKL") else base.split(".")[0]
        # VAE checkpoints have their own key layout: prefer a "<family>_vae" converter
        if f"{family}_vae" in converter_registry:
            family = f"{family}_vae"
        # Departure from the JAX engine, which maps a QwenImage VAE file
        # through the DiT's "qwenimage" converter (no "qwenimage_vae" exists):
        # that VAE is the Wan architecture and loads through "wan_vae".
        family = _VAE_CONVERTERS.get(base, family)
        return self._instantiate_family(_registry("vae"), spec, family)

    def _load_text_encoder(self, spec: Dict[str, Any]):
        from apex_studio_tpu_torch.text_encoder import TextEncoder

        return TextEncoder(self, spec)

    def load_helper(self, name: str):
        """Load a helper component (an auxiliary encoder) by its manifest
        name, else the manifest's first helper; kept in ``self.helpers``."""
        if name in self.helpers:
            return self.helpers[name]
        spec = self.component_specs.get(name)
        if spec is None:
            spec = next((s for s in self.component_specs.values() if s.get("type") == "helper"), None)
        if spec is None:
            raise KeyError(f"manifest has no helper component named {name!r}")
        base = spec.get("base") or ""
        family = _HELPER_FAMILIES.get(base)
        if family is None:
            raise KeyError(f"helper {name!r}: no ported family for base {base!r} "
                           f"(known: {', '.join(sorted(_HELPER_FAMILIES))})")
        model = self._instantiate_family(_registry("text_encoder"), spec, family)
        self.helpers[name] = model
        return model

    # -- cached conditioning encode ------------------------------------------------

    @torch.inference_mode()
    def encode_video_latents(self, video) -> torch.Tensor:
        """VAE encode of conditioning pixels ``video`` ([B,3,T,H,W] in [-1, 1])
        on the engine's device, with a disk cache keyed by the VAE's config,
        the shape and the pixels' f32 bytes: a repeat run skips the encoder."""
        import dataclasses
        import hashlib

        from apex_studio_tpu_torch.utils.disk_cache import EmbeddingCache

        arr = np.ascontiguousarray(np.asarray(torch.as_tensor(video).float().cpu()), np.float32)
        cfg = getattr(self.vae, "cfg", None)
        cache = EmbeddingCache("vae_encode")
        payload = {
            "fn": "vae_encode",
            "vae": dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else {},
            "shape": list(arr.shape),
            "sha": hashlib.sha256(arr.tobytes()).hexdigest(),
        }
        hit = cache.load(payload)
        if hit is not None and hit[0].dtype.kind in "fiu":
            return torch.from_numpy(np.asarray(hit[0], np.float32)).to(self.device)
        out = self.vae.encode(torch.from_numpy(arr).to(self.device)).float()
        cache.store(payload, out.cpu().numpy())
        return out

    # -- light preview decode ------------------------------------------------------

    def _get_preview_vae(self):
        """The TAEHV "light VAE" for cheap previews, declared in the VAE
        component's config as ``light_vae_path`` (+ ``light_vae_config``).
        None when not declared, or when its file is absent outside
        synthetic-weight mode (then a big run previews nothing); in that mode
        an absent file makes a random TAE.

        Unlike the JAX package, a ``light_vae_config`` without a
        ``light_vae_path`` raises outside synthetic-weight mode: there the JAX
        engine previews through a randomly initialised TAE, which shows noise.
        A file that is present but does not load raises too."""
        if hasattr(self, "_preview_vae_cache"):
            return self._preview_vae_cache
        spec = self._spec_for_type("vae")
        cfg_dict = dict(spec.get("config") or {}) if spec and isinstance(spec.get("config"), dict) else {}
        if spec and isinstance(spec.get("extra_kwargs"), dict):
            cfg_dict.update(spec["extra_kwargs"])
        path, light_cfg = cfg_dict.get("light_vae_path"), cfg_dict.get("light_vae_config")
        synthetic = bool(os.environ.get("APEX_SYNTHETIC_WEIGHTS", ""))
        model = None
        if path or light_cfg is not None:
            from apex_studio_tpu_torch.models.vaes.tae_vae import TAEConfig, TAEVAE

            cfg = TAEConfig.from_dict(light_cfg or {})
            local = self._resolve_path(path) if path else None
            if local is not None:
                from apex_studio_tpu_torch.loaders.converters import convert_keys
                from apex_studio_tpu_torch.loaders.state_mapping import apply_state_dict

                with torch.device("meta"):
                    model = TAEVAE(cfg, dtype=torch.float32)
                apply_state_dict(model, convert_keys("tae_vae", self._read_weights_file(local)),
                                 device=self.device, strict=True)
                model = model.eval().requires_grad_(False)
            elif synthetic:
                # the dry-run tier: a random TAE stands in, so that big runs
                # can release the full VAE during the denoise
                model = materialize_random(lambda: TAEVAE(cfg, dtype=torch.float32), self.device,
                                           seed=zlib.crc32(b"light_vae") & 0x7FFFFFFF)
            elif not path:
                raise ValueError("light_vae_config is declared without light_vae_path: previews "
                                 "would come from a randomly initialised TAE")
            else:
                logger.info("light VAE weights not present (%s); no light previews", path)
        self._preview_vae_cache = model
        return model

    @torch.inference_mode()
    def preview_frames(self, latents: torch.Tensor, fallback=None) -> List[np.ndarray]:
        """Preview frames through the light TAE decoder when the manifest
        declares one, else through ``fallback`` (a family's
        ``decode_latents``). At most ``APEX_PREVIEW_MAX_LATENT_T`` (9) latent
        frames are decoded."""
        vae = self._get_preview_vae()
        if vae is None:
            if fallback is None:
                raise RuntimeError("no light VAE and no fallback decoder")
            return fallback(latents)
        max_t = int(os.environ.get("APEX_PREVIEW_MAX_LATENT_T", "9"))
        if latents.ndim == 5 and latents.shape[2] > max_t:
            latents = latents[:, :, :max_t]
        video = vae.decode(latents.float())  # [B,3,T,H,W]
        b, c, t, h, w = video.shape
        return self.tensor_to_frames(video.transpose(1, 2).reshape(b * t, c, h, w))

    # -- media inputs -----------------------------------------------------------------

    @staticmethod
    def load_image_input(image) -> np.ndarray:
        """An image input (HWC array, nested list, file path or data URI) as
        an RGB HWC uint8 array; paths and data URIs are decoded by OpenCV."""
        if isinstance(image, str):
            import cv2

            if image.startswith("data:"):
                import base64

                payload = base64.b64decode(image.split(",", 1)[1])
                arr = cv2.imdecode(np.frombuffer(payload, np.uint8), cv2.IMREAD_COLOR)
                if arr is None:
                    raise ValueError("cannot decode data-URI image")
            else:
                arr = cv2.imread(image, cv2.IMREAD_COLOR)
                if arr is None:
                    raise FileNotFoundError(f"cannot read image: {image}")
            return cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        return arr

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

    @torch.inference_mode()
    def decode_video_tensor(self, z: torch.Tensor, tile: int, threshold: int) -> torch.Tensor:
        """Video latents [B, C, T, h, w] → video [B, 3, T', H, W] in [-1, 1]
        through the VAE; grids of more than ``threshold`` latent pixels (h·w)
        decode in tiles of ``tile`` latent pixels (models/vaes/tiling.py).
        ``APEX_VAE_TILE_THRESHOLD`` / ``APEX_VAE_TILE`` override both."""
        from apex_studio_tpu_torch.models.vaes.tiling import decode_tiled_3d

        threshold = int(os.environ.get("APEX_VAE_TILE_THRESHOLD", threshold))
        z = z.float()
        if z.ndim == 5 and z.shape[-2] * z.shape[-1] > threshold:
            tile = int(os.environ.get("APEX_VAE_TILE", tile))
            return decode_tiled_3d(self.vae.decode, z, self.vae.cfg.spatial_scale, tile=tile)
        return self.vae.decode(z)

    def decode_video_frames(self, z: torch.Tensor, tile: int, threshold: int) -> List[np.ndarray]:
        """Video latents → B·T HWC uint8 frames (``decode_video_tensor``)."""
        video = self.decode_video_tensor(z, tile, threshold)
        b, c, t, h, w = video.shape
        return self.tensor_to_frames(video.transpose(1, 2).reshape(b * t, c, h, w))

    @staticmethod
    def tensor_to_frames(img: torch.Tensor) -> List[np.ndarray]:
        """[B,3,H,W] in [-1,1] → list of HWC uint8 frames."""
        arr = ((img.float() + 1.0) / 2.0).clamp(0.0, 1.0).cpu().numpy()
        arr = (arr * 255.0 + 0.5).astype(np.uint8)
        return [np.transpose(a, (1, 2, 0)) for a in arr]

    def run(self, **kwargs: Any):  # pragma: no cover - interface
        raise NotImplementedError


# a helper's manifest ``base`` → its converter family (the JAX engine picks
# by substrings of ``base`` and derives "wav2vec2model" for wav2vec2, which
# names no converter)
_HELPER_FAMILIES = {"CLIPVisionModel": "clip_vision", "SiglipVisionModel": "siglip", "Wav2Vec2Model": "wav2vec2",
                    "LynxResampler": "lynx_resampler", "lynx_resampler": "lynx_resampler"}


def dynamic_shift_mu(scheduler, image_seq_len: int) -> float:
    """The flow-match shift ``mu`` for ``image_seq_len`` tokens from the
    scheduler's config (the Flux family's defaults where it is silent)."""
    from apex_studio_tpu_torch.schedulers.base import compute_dynamic_shift_mu

    sc = scheduler.config
    return compute_dynamic_shift_mu(image_seq_len, sc.get("base_image_seq_len", 256),
                                    sc.get("max_image_seq_len", 4096), sc.get("base_shift", 0.5),
                                    sc.get("max_shift", 1.15))


def _registry(kind: str):
    from apex_studio_tpu_torch.models import registry

    return getattr(registry, f"{kind}_registry")


def materialize_random(build, device: torch.device, seed: int, std: float = SYNTHETIC_STD):
    """Build a module on the ``meta`` device (no host allocation), give it
    storage on ``device`` and fill every floating tensor with normal(0, std)
    from a generator on that device. No weight is quantized."""
    from apex_studio_tpu_torch.quantize.residency import materialize_random_int8

    with torch.device("meta"):
        model = build()
    materialize_random_int8(model, device=device, seed=seed, scale=std, min_numel=1 << 62)
    return model.eval().requires_grad_(False)
