"""JSON-able serialization for model objects.

Equivalent capability to the reference's ``SimpleRepr`` mixin
(reference: pydcop/utils/simple_repr.py:68,133,175): any object whose
constructor arguments map to attributes can be turned into a plain
dict-of-builtins and back.  Used by the YAML reader/writer, checkpointing and
the (optional) HTTP control plane.

Design: rather than the reference's name-mangling convention alone, we resolve
each constructor parameter ``p`` by looking for, in order, ``self._p``,
``self.p``, then a class-level default.  Classes can override ``_simple_repr``
/ ``_from_repr`` hooks for irregular shapes.
"""
from __future__ import annotations

import importlib
import inspect
from typing import Any

REPR_MODULE = "__module__"
REPR_QUALNAME = "__qualname__"

_MISSING = object()


class SimpleReprException(Exception):
    pass


class SimpleRepr:
    """Mixin providing ``simple_repr(obj)`` / ``from_repr(repr)`` support."""

    def _simple_repr(self) -> dict:
        r: dict[str, Any] = {
            REPR_MODULE: type(self).__module__,
            REPR_QUALNAME: type(self).__qualname__,
        }
        sig = inspect.signature(type(self).__init__)
        for name, param in sig.parameters.items():
            if name == "self":
                continue
            if param.kind in (param.VAR_POSITIONAL, param.VAR_KEYWORD):
                continue
            val = getattr(self, "_" + name, _MISSING)
            if val is _MISSING:
                val = getattr(self, name, _MISSING)
            if val is _MISSING:
                if param.default is not param.empty:
                    val = param.default
                else:
                    raise SimpleReprException(
                        f"Cannot build repr for {self!r}: no attribute "
                        f"matching constructor argument {name!r}"
                    )
            r[name] = simple_repr(val)
        return r

    @classmethod
    def _from_repr(cls, r: dict) -> "SimpleRepr":
        kwargs = {
            k: from_repr(v)
            for k, v in r.items()
            if k not in (REPR_MODULE, REPR_QUALNAME)
        }
        return cls(**kwargs)


def simple_repr(obj: Any) -> Any:
    """Return a composition of builtins (dict/list/str/num) describing obj."""
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [simple_repr(o) for o in obj]
    if isinstance(obj, dict):
        return {k: simple_repr(v) for k, v in obj.items()}
    # numpy scalars / arrays
    if hasattr(obj, "tolist") and type(obj).__module__.startswith(("numpy", "torch")):
        return simple_repr(obj.tolist())
    if isinstance(obj, SimpleRepr):
        return obj._simple_repr()
    raise SimpleReprException(f"Object has no simple repr: {obj!r} ({type(obj)})")


def from_repr(r: Any) -> Any:
    """Rebuild an object from its :func:`simple_repr` output."""
    if r is None or isinstance(r, (str, int, float, bool)):
        return r
    if isinstance(r, list):
        return [from_repr(o) for o in r]
    if isinstance(r, dict):
        if REPR_QUALNAME in r:
            cls = _resolve(r[REPR_MODULE], r[REPR_QUALNAME])
            return cls._from_repr(r)
        return {k: from_repr(v) for k, v in r.items()}
    raise SimpleReprException(f"Cannot rebuild object from {r!r}")


def _resolve(module: str, qualname: str):
    mod = importlib.import_module(module)
    obj: Any = mod
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj
