"""Carry parameters over from the JAX package.

``params_from_jax(tree)`` takes the parameters of any model of the JAX
package (its ``init_params`` tree: nested dicts, such as the hybrid's
doubly stacked ``mamba``, xLSTM's ``layer_{i}`` and the encoder-decoder's
stacked ``encoder`` and ``decoder``), handed over as numpy arrays
(``jax.tree.map(np.asarray, params)``), and returns this package's
parameters — the same dict structure, with the per-layer tensors stacked
the same way — as tensors on ``device``, the
card by default like every entry point of the port.  Without CUDA the
default raises; a caller on the CPU passes ``"cpu"``.
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


def params_from_jax(tree: Any, device="cuda", dtype: Optional[torch.dtype] = None) -> Any:
    """Convert a nested dict of arrays into tensors on ``device`` (cast to
    ``dtype`` when given, else keeping each array's type).  Raises
    ``RuntimeError`` for a CUDA device when CUDA is not available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("params_from_jax: device 'cuda' but torch.cuda.is_available() "
                           "is False; pass device='cpu' to convert onto the CPU")
    return _convert(tree, device, dtype)


def _convert(tree: Any, device: torch.device, dtype: Optional[torch.dtype]) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    return _tensor(tree, device, dtype)
