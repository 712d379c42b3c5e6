"""The universal registry primitive.

Everything pluggable in the port — attention backends, transformer, VAE and
text-encoder families, schedulers — hangs off a :class:`Registry`: the part
of ``apex_studio_tpu/registry.py`` that this slice uses (named and aliased
registration with a settable default, and lookup).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional


class Registry:
    """Name → object registry with decorator registration.

    >>> attention = Registry("attention")
    >>> @attention.register("xla", default=True)
    ... def xla_attention(q, k, v, **kw): ...
    >>> attention.get()          # default entry
    >>> attention.get("xla")     # by name
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}
        self._default: Optional[str] = None

    def register(self, name: Optional[str] = None, *, default: bool = False,
                 aliases: Iterable[str] = ()) -> Callable[[Any], Any]:
        def deco(obj: Any) -> Any:
            key = name or getattr(obj, "__name__", None)
            if not key:
                raise ValueError(f"{self.kind}: cannot infer a registry name for {obj!r}")
            for k in (key, *aliases):
                self._entries[k] = obj
            if default or self._default is None:
                self._default = key
            return obj

        return deco

    def add(self, name: str, obj: Any, **kw: Any) -> Any:
        return self.register(name, **kw)(obj)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: Optional[str] = None) -> Any:
        key = name or self._default
        if key is None:
            raise KeyError(f"{self.kind}: registry is empty")
        if key not in self._entries:
            raise KeyError(f"{self.kind}: no entry named {key!r}; known: {sorted(self._entries)}")
        return self._entries[key]
