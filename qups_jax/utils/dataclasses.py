"""Pytree-registered frozen dataclasses.

QUPS models its domain objects (transducers, sequences, scans, ...) as MATLAB
handle classes (e.g. ``/root/reference/src/Transducer.m:12``). The JAX
equivalent is a frozen dataclass registered as a JAX pytree: numeric fields are
traced leaves (so objects pass through ``jit``/``vmap``/``shard_map`` without
recompilation when values change), while structural fields (element counts,
sequence type strings, callables) are static metadata that specialize the
compiled program.
"""
from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import jax

T = TypeVar("T")

_STATIC_KEY = "qups_static"


def static_field(default: Any = dataclasses.MISSING, **kwargs):
    """A dataclass field treated as static (hashable) pytree metadata."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata[_STATIC_KEY] = True
    return dataclasses.field(default=default, metadata=metadata, **kwargs)


def field(default: Any = dataclasses.MISSING, **kwargs):
    """A dataclass field treated as a traced pytree leaf (the default)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata[_STATIC_KEY] = False
    return dataclasses.field(default=default, metadata=metadata, **kwargs)


def pytree_dataclass(cls: type[T] | None = None, **dc_kwargs) -> type[T]:
    """Decorator: make ``cls`` a frozen dataclass registered as a JAX pytree.

    Fields declared with :func:`static_field` become pytree metadata; all other
    fields are children (traced leaves).
    """

    def wrap(c):
        c = dataclasses.dataclass(frozen=True, eq=False, repr=True, **dc_kwargs)(c)
        data_fields = []
        meta_fields = []
        for f in dataclasses.fields(c):
            if f.metadata.get(_STATIC_KEY, False):
                meta_fields.append(f.name)
            else:
                data_fields.append(f.name)
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=meta_fields
        )

        def _replace(self, **changes):
            return dataclasses.replace(self, **changes)

        c.replace = _replace
        return c

    if cls is None:
        return wrap
    return wrap(cls)
