"""The modules a benchmark run may not load: JAX, its libraries and the
JAX package the port was made from. Names are compared whole, by the part
before the first dot: ``ste_gan_torch`` is not ``ste_gan_tpu``."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "ste_gan_tpu"})


def top_level(names: Iterable[str]) -> set:
    return {n.split(".", 1)[0] for n in names}


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: every module
    loaded in this process)."""
    loaded = top_level(sys.modules if names is None else names)
    return sorted(loaded & FORBIDDEN)
