"""Sequential oracle for the SSD chunk scan."""
from __future__ import annotations

from typing import Optional

import torch

from ..mlstm_chunk.ref import gla_ref


def ssd_ref(x, dt, A, B, C, D: Optional[torch.Tensor] = None):
    log_decay = dt * A[None, :, None]
    y = gla_ref(C, B, x, log_decay, dt, normalize=False, scale=1.0)
    if D is not None:
        y = y + D[None, :, None, None] * x
    return y
