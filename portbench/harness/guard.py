"""The JAX package and JAX itself stay out of every process the benchmark
runs: module names are compared by their top-level name, whole, so the
port (``repro_torch``) is not taken for the JAX package (``repro``)."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded(names: Iterable[str] = FORBIDDEN) -> List[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(names))
