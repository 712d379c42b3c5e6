"""apex/v1 manifest loading and normalization into the engine config shape.

Behavioral counterpart of ``src/manifest/loader.py:57`` (validate_and_normalize)
in the reference: v1 documents are validated and flattened into the "legacy"
shape engines consume (`name`, `engine`, `type`, `engine_type`, `components`,
`defaults`, `ui`, ...); legacy documents (no api_version) pass through.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Union

from apex_studio_tpu_torch.manifest.schema import validate_manifest_v1
from apex_studio_tpu_torch.utils.yaml_io import load_yaml

# UI "component" aliases → canonical widget names (mirrors the reference's
# canonical component mapping in loader._normalize_ui).
_UI_COMPONENT_ALIASES = {
    "string": "text",
    "int": "number",
    "integer": "number",
    "double": "float",
    "boolean": "bool",
    "array": "list",
    "path": "file",
}

# spec key → normalized key, for the scalar engine-wiring fields. Each entry
# lists accepted spellings in priority order (snake_case wins over camelCase).
_SPEC_SCALARS = {
    "engine": ("engine",),
    "engine_type": ("engine_type", "engineType"),
    "denoise_type": ("denoise_type", "denoiseType"),
    "engine_kwargs": ("engine_kwargs",),
    "sub_engines": ("sub_engines", "subEngines", "subengines"),
}

# spec keys copied verbatim when present.
_SPEC_PASSTHROUGH = (
    "components",
    "preprocessors",
    "postprocessors",
    "shared",
    "helpers",
    "loras",
    "attention_types",
    "compute_requirements",
)

# All spec keys consumed by explicit normalization (anything else is passed
# through untouched so new manifest fields reach engines without loader edits).
_SPEC_CONSUMED = (
    set(_SPEC_PASSTHROUGH)
    | {alias for aliases in _SPEC_SCALARS.values() for alias in aliases}
    | {
        "model_type",
        "model_types",
        "modelType",
        "modelTypes",
        "defaults",
        "save",
        "ui",
        "UI",
    }
)


def _normalize_ui(ui: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if ui is None:
        return None
    out = dict(ui)
    if isinstance(out.get("mode"), str):
        out["mode"] = out["mode"].lower()
    simple = out.get("simple")
    if isinstance(simple, dict):
        for item in simple.get("inputs", []) or []:
            widget = item.get("component") or item.get("type")
            if isinstance(widget, str):
                w = widget.lower()
                item["component"] = _UI_COMPONENT_ALIASES.get(w, w)
    return out


def validate_and_normalize(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Validate an apex/v1 manifest and map it to the engine config shape.

    Legacy documents (no ``api_version``) are returned unchanged apart from UI
    normalization, exactly like the reference loader.
    """
    if not isinstance(doc, dict):
        return doc

    top_ui = doc.get("ui") if doc.get("ui") is not None else doc.get("UI")

    if "api_version" not in doc and "apiVersion" not in doc:
        if top_ui is not None and "ui" not in doc:
            doc["ui"] = _normalize_ui(top_ui)
        return doc

    validate_manifest_v1(doc)

    metadata: Dict[str, Any] = doc.get("metadata") or {}
    spec: Dict[str, Any] = doc.get("spec") or {}

    out: Dict[str, Any] = {"name": metadata.get("name"), "metadata": metadata}
    for meta_key in ("description", "version"):
        if metadata.get(meta_key):
            out[meta_key] = metadata[meta_key]

    # model_type → "type" (string or list; camelCase accepted).
    for key in ("model_type", "model_types", "modelType", "modelTypes"):
        if spec.get(key) is not None:
            out["type"] = spec[key]
            break

    for norm_key, spellings in _SPEC_SCALARS.items():
        for s in spellings:
            if spec.get(s):
                out[norm_key] = spec[s]
                break

    for key in _SPEC_PASSTHROUGH:
        if key in spec:
            out[key] = spec[key]

    if "defaults" in spec:
        out["defaults"] = spec["defaults"]
    if "save" in spec:
        out["save_kwargs"] = spec["save"]

    # Every component gets a stable name (defaults to its type).
    for comp in out.get("components", []) or []:
        if isinstance(comp, dict) and "name" not in comp:
            comp["name"] = comp.get("type")

    ui = top_ui if top_ui is not None else (spec.get("ui") or spec.get("UI"))
    if ui is not None:
        out["ui"] = _normalize_ui(ui)

    # Unhandled top-level and spec keys pass through (forward compatibility).
    for key, value in doc.items():
        if key not in ("metadata", "spec", "ui", "UI") and key not in out:
            out[key] = value
    for key, value in spec.items():
        if key not in _SPEC_CONSUMED and key not in out:
            out[key] = value

    return out


def load_manifest(path: Union[str, Path], resolve_shared: bool = True) -> Dict[str, Any]:
    """Load a manifest YAML, expand shared includes, validate and normalize."""
    path = Path(path)
    doc = load_yaml(path)
    if resolve_shared:
        from apex_studio_tpu_torch.manifest.shared_loader import expand_shared

        doc = expand_shared(doc, base_dir=path.parent)
    return validate_and_normalize(doc)
