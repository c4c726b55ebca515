"""The check that the benchmark's process loaded neither JAX nor the JAX
package: each module's top-level name (before the first dot) is compared
whole, so ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden(modules: Iterable[str] = None, names=FORBIDDEN) -> List[str]:
    """The top-level names in ``modules`` (default: ``sys.modules``) that
    are one of ``names``."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods} & set(names))
