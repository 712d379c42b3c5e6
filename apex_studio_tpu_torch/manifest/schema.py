"""apex/v1 manifest validation.

Behavioral counterpart of the reference's JSON-Schema at
``src/manifest/schema_v1.py:7-470`` — same accepted surface, implemented as a
programmatic validator so errors are short and actionable. The schema is
deliberately permissive: unknown keys are allowed everywhere (the reference
sets ``additional_properties: True`` throughout), so validation focuses on the
required spine and the enumerations that the engine/UI actually dispatch on.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

COMPONENT_TYPES = {
    "scheduler",
    "vae",
    "text_encoder",
    "transformer",
    "helper",
    "extra_model_path",
}

# Engine types the reference accepts, plus our native backend.
ENGINE_TYPES = {"torch", "mlx", "jax"}

TIMELINE_INPUT_TYPES = {
    "text",
    "audio",
    "video",
    "image",
    "video_with_mask",
    "image_with_mask",
    "video_with_preprocessor",
    "image_with_preprocessor",
}

UI_PARAMETER_TYPES = {
    "number",
    "random",
    "text",
    "textarea",
    "categories",
    "boolean",
    "number_list",
}

_SEMVER_RE = re.compile(r"^(0|[1-9]\d*)\.(0|[1-9]\d*)\.(0|[1-9]\d*)([-+].*)?$")
_API_VERSION_RE = re.compile(r"^apex(/ai)?/v1$")


class ManifestValidationError(ValueError):
    pass


def _fail(path: str, why: str) -> None:
    raise ManifestValidationError(f"Manifest validation failed at {path}: {why}")


def _require(cond: bool, path: str, why: str) -> None:
    if not cond:
        _fail(path, why)


def _check_type(value: Any, types: tuple, path: str) -> None:
    _require(isinstance(value, types), path, f"expected {'/'.join(t.__name__ for t in types)}, got {type(value).__name__}")


def _validate_model_path(mp: Any, path: str) -> None:
    if isinstance(mp, str):
        return
    _check_type(mp, (list,), path)
    for i, variant in enumerate(mp):
        vp = f"{path}[{i}]"
        _check_type(variant, (dict,), vp)
        _require("path" in variant, vp, "variant entries require 'path'")
        _check_type(variant["path"], (str,), vp + ".path")
        rr = variant.get("resource_requirements")
        if rr is not None:
            _check_type(rr, (dict,), vp + ".resource_requirements")


def _validate_component(comp: Any, path: str) -> None:
    _check_type(comp, (dict,), path)
    _require("type" in comp, path, "components require 'type'")
    ctype = comp["type"]
    _require(
        ctype in COMPONENT_TYPES,
        path + ".type",
        f"{ctype!r} is not one of {sorted(COMPONENT_TYPES)}",
    )
    if "model_path" in comp and comp["model_path"] is not None:
        _validate_model_path(comp["model_path"], path + ".model_path")
    for key in ("base", "name", "label", "config_path", "tag", "file_pattern"):
        if key in comp and comp[key] is not None:
            _check_type(comp[key], (str,), f"{path}.{key}")
    if "scheduler_options" in comp:
        opts = comp["scheduler_options"]
        _check_type(opts, (list,), path + ".scheduler_options")
        for i, opt in enumerate(opts):
            op = f"{path}.scheduler_options[{i}]"
            _check_type(opt, (dict,), op)
            _require("name" in opt, op, "scheduler options require 'name'")
    if "gguf_files" in comp:
        files = comp["gguf_files"]
        _check_type(files, (list,), path + ".gguf_files")
        for i, gf in enumerate(files):
            gp = f"{path}.gguf_files[{i}]"
            _check_type(gf, (dict,), gp)
            _require("type" in gf and "path" in gf, gp, "gguf entries require 'type' and 'path'")


def _validate_ui(ui: Any, path: str) -> None:
    _check_type(ui, (dict,), path)
    mode = ui.get("mode")
    if mode is not None:
        _require(
            str(mode).lower() in ("simple", "advanced", "complex"),
            path + ".mode",
            f"{mode!r} is not one of simple/advanced/complex",
        )
    tli = ui.get("timeline_inputs")
    if isinstance(tli, dict):
        for i, inp in enumerate(tli.get("inputs", []) or []):
            ip = f"{path}.timeline_inputs.inputs[{i}]"
            _check_type(inp, (dict,), ip)
            _require("id" in inp and "type" in inp, ip, "timeline inputs require 'id' and 'type'")
            _require(
                inp["type"] in TIMELINE_INPUT_TYPES,
                ip + ".type",
                f"{inp['type']!r} is not one of {sorted(TIMELINE_INPUT_TYPES)}",
            )
    for i, param in enumerate(ui.get("parameters", []) or []):
        pp = f"{path}.parameters[{i}]"
        _check_type(param, (dict,), pp)
        _require("id" in param and "type" in param, pp, "ui parameters require 'id' and 'type'")
        _require(
            param["type"] in UI_PARAMETER_TYPES,
            pp + ".type",
            f"{param['type']!r} is not one of {sorted(UI_PARAMETER_TYPES)}",
        )


def validate_manifest_v1(doc: Dict[str, Any]) -> None:
    """Raise :class:`ManifestValidationError` unless ``doc`` is a valid apex/v1 manifest."""
    _check_type(doc, (dict,), "$")

    api_version = doc.get("api_version") or doc.get("apiVersion")
    _require(api_version is not None, "$.api_version", "required")
    _require(
        bool(_API_VERSION_RE.match(str(api_version))),
        "$.api_version",
        f"{api_version!r} does not match apex/v1",
    )

    kind = doc.get("kind")
    _require(kind in ("Model", "Pipeline"), "$.kind", f"{kind!r} must be Model or Pipeline")

    metadata = doc.get("metadata")
    _check_type(metadata, (dict,), "$.metadata")
    _require(bool(metadata.get("name")), "$.metadata.name", "required and non-empty")
    version = metadata.get("version")
    if version is not None:
        _require(
            bool(_SEMVER_RE.match(str(version))),
            "$.metadata.version",
            f"{version!r} is not semver",
        )
    tags = metadata.get("tags")
    if tags is not None:
        _check_type(tags, (list,), "$.metadata.tags")

    spec = doc.get("spec")
    _check_type(spec, (dict,), "$.spec")
    _require(bool(spec.get("engine")), "$.spec.engine", "required")
    model_type = (
        spec.get("model_type")
        if spec.get("model_type") is not None
        else spec.get("model_types", spec.get("modelType", spec.get("modelTypes")))
    )
    _require(model_type is not None, "$.spec.model_type", "required")
    _check_type(model_type, (str, list), "$.spec.model_type")

    engine_type = spec.get("engine_type") or spec.get("engineType")
    if engine_type is not None:
        _require(
            engine_type in ENGINE_TYPES,
            "$.spec.engine_type",
            f"{engine_type!r} is not one of {sorted(ENGINE_TYPES)}",
        )

    components = spec.get("components")
    if components is not None:
        _check_type(components, (list,), "$.spec.components")
        for i, comp in enumerate(components):
            _validate_component(comp, f"$.spec.components[{i}]")

    for stage_key in ("preprocessors", "postprocessors"):
        stages = spec.get(stage_key)
        if stages is not None:
            _check_type(stages, (list,), f"$.spec.{stage_key}")
            for i, st in enumerate(stages):
                sp = f"$.spec.{stage_key}[{i}]"
                _check_type(st, (dict,), sp)
                _require("type" in st, sp, "requires 'type'")

    loras = spec.get("loras")
    if loras is not None:
        _check_type(loras, (list,), "$.spec.loras")
        for i, lr in enumerate(loras):
            _check_type(lr, (str, dict), f"$.spec.loras[{i}]")

    shared = spec.get("shared")
    if shared is not None:
        _check_type(shared, (list,), "$.spec.shared")

    ui = doc.get("ui") or doc.get("UI") or spec.get("ui") or spec.get("UI")
    if ui is not None:
        _validate_ui(ui, "$.spec.ui")


def manifest_errors(doc: Dict[str, Any]) -> List[str]:
    """Return validation errors without raising (empty list == valid)."""
    try:
        validate_manifest_v1(doc)
        return []
    except ManifestValidationError as e:
        return [str(e)]
