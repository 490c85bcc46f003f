"""Plain PyTorch oracle for the Stripe-generated matmul(+epilogue)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_ACTS = {
    None: lambda x: x,
    "relu": torch.relu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "square": torch.square,
    "gelu": lambda x: F.gelu(x, approximate="none"),
}


def matmul_ref(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
               act: Optional[str] = None) -> torch.Tensor:
    acc = torch.einsum("mk,kn->mn", x.float(), w.float())
    if bias is not None:
        acc = acc + bias.float()
    return _ACTS[act](acc).to(x.dtype)
