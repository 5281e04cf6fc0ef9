"""The modules a benchmark run may not load: JAX and the JAX package.

Compared by whole top-level name (the part before the first dot), because
the port's package name, `sfa3d_tpu_torch`, begins with the JAX package's.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "sfa3d_tpu")


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    names = sys.modules.keys() if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops.intersection(FORBIDDEN))
