"""The JAX package stays out: no module of the JAX stack or of the JAX
package may be loaded in a run.  Names are compared by their top-level
part (before the first dot) as a whole, since the port's own name,
``repro_torch``, begins with the JAX package's, ``repro``."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class ForbiddenImport(RuntimeError):
    def __init__(self, names: List[str]):
        super().__init__("modules of the JAX stack or package are loaded: " + ", ".join(names))
        self.names = names


def forbidden(names: Iterable[str]) -> List[str]:
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def forbidden_loaded() -> List[str]:
    return forbidden(list(sys.modules))
