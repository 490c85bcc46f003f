"""Mamba2 SSD (state space duality) chunk scan on the chunked gated linear
attention kernel: the SSD recurrence

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * B_t x_t^T
    y_t = C_t @ S_t  (+ D_h * x_t)

is the un-normalized gated linear attention with q=C, k=B, v=x,
log_decay = dt*A, gain = dt.  No kernel of its own: a wrapper.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..mlstm_chunk.kernel import chunked_gla


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, D: Optional[torch.Tensor] = None,
              chunk: Optional[int] = None) -> torch.Tensor:
    """x: (Bt, H, S, P); dt: (Bt, H, S) positive; A: (H,) negative;
    B/C: (Bt, H, S, N).  Returns (Bt, H, S, P)."""
    _build.refuse_autograd("ssd_chunk", x, dt, A, B, C, D)
    log_decay = dt * A[None, :, None]
    y = chunked_gla(C, B, x, log_decay, dt, chunk=chunk, normalize=False, scale=1.0)
    if D is not None:
        y = y + D[None, :, None, None] * x
    return y
