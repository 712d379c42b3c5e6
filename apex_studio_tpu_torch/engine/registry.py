"""Engine registry + UniversalEngine facade (port of
``apex_studio_tpu/engine/registry.py``). Ported: ``("flux", "t2i" | "kontext" |
"fill" | "control" | "dreamomni2")``, ``("flux2", "ti2i" | "klein" | "t2i" |
"control")``, ``("hunyuanvideo15", "t2v" | "i2v")``, ``("hunyuanvideo", "t2v" | "i2v" | "framepack" | "avatar")``, ``("zimage", "t2i" | "control")``,
``("qwenimage", "t2i" | "edit" | "edit_plus" | "controlnet")``,
``("wan", "t2v" | "t2i" | "i2v" | "fflf" | "inp" | "v2v" | "svi" | "vace" |
"fun_vace" | "phantom" | "fun_control" | "fun" | "causal" | "humo" | "s2v" | "multitalk")``,
``("chroma", "t2i")``, ``("ovis", "t2i")``, ``("fibo", "ti2i" | "t2i")``,
``("hidream", "t2i" | "edit")``, ``("hunyuanimage", "t2i")``, ``("longcat", "t2v" |
"i2v" | "vc" | "continuation" | "long_video" | "interactive" | "refine")``,
``("cosmos2", "i2v" | "v2v")``, ``("kandinsky5", "t2v" | "i2v")``, ``("hunyuanimage3",
"t2i")``, ``("cogvideo", "t2v" | "i2v" | "v2v" | "control" | "inp")``, ``("mochi", "t2v")``,
``("ltx", "x2v")``, ``("ltx2", "ti2v" | "multimodal_guidance" | "ic_lora" | "keyframe_interpolation")``,
``("magi", "t2v" | "i2v" | "v2v")`` and ``("flashvsr", "upscale")``."""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Type, Union

from apex_studio_tpu_torch.manifest.loader import load_manifest

_ENGINE_MODULES = ("apex_studio_tpu_torch.engine.flux", "apex_studio_tpu_torch.engine.hunyuanvideo15",
                  "apex_studio_tpu_torch.engine.zimage", "apex_studio_tpu_torch.engine.qwenimage",
                  "apex_studio_tpu_torch.engine.wan", "apex_studio_tpu_torch.engine.flux2",
                  "apex_studio_tpu_torch.engine.hunyuanvideo", "apex_studio_tpu_torch.engine.hunyuanvideo_avatar",
                  "apex_studio_tpu_torch.engine.skyreels", "apex_studio_tpu_torch.engine.lucy",
                  "apex_studio_tpu_torch.engine.chroma", "apex_studio_tpu_torch.engine.ovis",
                  "apex_studio_tpu_torch.engine.fibo", "apex_studio_tpu_torch.engine.hidream",
                  "apex_studio_tpu_torch.engine.hunyuanimage", "apex_studio_tpu_torch.engine.longcat",
                  "apex_studio_tpu_torch.engine.cosmos2", "apex_studio_tpu_torch.engine.kandinsky5",
                  "apex_studio_tpu_torch.engine.hunyuanimage3", "apex_studio_tpu_torch.engine.cogvideox",
                  "apex_studio_tpu_torch.engine.mochi", "apex_studio_tpu_torch.engine.ltx",
                  "apex_studio_tpu_torch.engine.ltx2", "apex_studio_tpu_torch.engine.magi",
                  "apex_studio_tpu_torch.engine.flashvsr")

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
