"""Engine registry + UniversalEngine facade (port of
``apex_studio_tpu/engine/registry.py``). Ported: ``("flux", "t2i")`` and
``("hunyuanvideo15", "t2v" | "i2v")``."""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Type, Union

from apex_studio_tpu_torch.manifest.loader import load_manifest

_ENGINE_MODULES = ("apex_studio_tpu_torch.engine.flux", "apex_studio_tpu_torch.engine.hunyuanvideo15")

engine_registry: Dict[Tuple[str, str], Type] = {}


def register_engine(engine: str, *model_types: str):
    def deco(cls):
        for mt in model_types:
            engine_registry[(engine, mt)] = cls
        cls.engine_name = engine
        return cls

    return deco


def resolve_engine_class(engine: str, model_type: str) -> Type:
    for mod in _ENGINE_MODULES:
        importlib.import_module(mod)
    cls = engine_registry.get((engine, model_type))
    if cls is None:
        known = sorted(f"{e}/{m}" for e, m in engine_registry)
        raise KeyError(f"no engine for {engine}/{model_type}; known: {known}")
    return cls


class UniversalEngine:
    """Facade: manifest path → concrete engine instance on ``device`` (the
    card unless ``device="cpu"``)."""

    def __new__(cls, yaml_path: Union[str, Path], model_type: Optional[str] = None,
                device: Any = None, **kwargs: Any):
        config = load_manifest(yaml_path)
        mt = model_type or config.get("type")
        if isinstance(mt, list):
            mt = mt[0]
        engine_cls = resolve_engine_class(config.get("engine"), mt)
        return engine_cls(config, yaml_path=Path(yaml_path), model_type=mt, device=device, **kwargs)
