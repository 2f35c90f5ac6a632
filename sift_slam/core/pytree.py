"""Frozen dataclasses registered as JAX pytrees."""

from __future__ import annotations

import dataclasses

import jax


def dataclass(cls):
    """Frozen dataclass that is a pytree node and has ``.replace``.

    Every field is a pytree child (arrays, or nested pytrees) unless it
    is declared ``dataclasses.field(metadata={"static": True})``, which
    makes it hashable metadata: part of the tree structure, and so a
    static argument under ``jax.jit``.
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls)
