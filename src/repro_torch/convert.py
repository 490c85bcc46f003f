"""Carry parameters over from the JAX package.

``params_from_jax(tree)`` takes the JAX package's ``lm.init_params`` tree,
handed over as numpy arrays (``jax.tree.map(np.asarray, params)``), and
returns this package's parameters — the same dict structure, with the
per-layer tensors stacked the same way — as tensors on ``device``.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def _tensor(a: Any, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: go through float32 (exact)
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Any, device="cpu", dtype: Optional[torch.dtype] = None) -> Any:
    """Convert a nested dict of arrays into tensors on ``device`` (cast to
    ``dtype`` when given, else keeping each array's type)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    return _tensor(tree, device, dtype)
