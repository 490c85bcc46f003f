"""Public wrapper for the Stripe-compiled matmul."""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import build_matmul_kernel
from .ref import matmul_ref


def matmul(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           act: Optional[str] = None) -> torch.Tensor:
    """act(x @ w + bias) through the Stripe-compiled CUDA kernel (its plain
    version for CPU tensors).  The kernel computes in float32: other input
    types are widened, and the result is rounded back to ``x.dtype``."""
    m, k = x.shape
    n = w.shape[-1]
    fn = build_matmul_kernel(m, k, n, act, bias is not None)
    out = fn(x.float(), w.float(), None if bias is None else bias.float())
    return out.to(x.dtype)


__all__ = ["matmul", "matmul_ref"]
