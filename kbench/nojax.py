"""The check that a run loaded neither JAX nor the JAX package.

A module counts by its top-level name, the part before the first dot,
compared whole: `kmernator_tpu_torch` (the port) begins with
`kmernator_tpu` (the JAX package) and is not it.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

BANNED = ("jax", "jaxlib", "flax", "kmernator_tpu")


def found(names: Iterable[str] = None) -> List[str]:
    """The names among `names` (default: sys.modules) whose top-level name
    is banned."""
    if names is None:
        names = list(sys.modules)
    return sorted(n for n in names if n.split(".")[0] in BANNED)
