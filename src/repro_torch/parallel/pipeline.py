"""GPipe-style pipeline parallelism over a mesh axis, the twin of the JAX
package's ``parallel/pipeline.py``.

Schedule: GPipe with M microbatches; bubble fraction (S-1)/(M+S-1).
``pipeline_apply`` runs ``stage_fn`` (this rank's stage params) over M
microbatches: each step, ranks process their microbatch then pass
activations forward (``ppermute``).  Every rank executes the same
program (SPMD).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from . import spmd
from .compat import axis_size


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, micro_in: torch.Tensor,
                   axis: str = "pod") -> torch.Tensor:
    """Inside shard_map over ``axis``.

    micro_in: (M, mb, ...) — this *pipeline input* is only meaningful on
    stage 0 (others receive via permute).  Returns (M, mb, ...) outputs,
    replicated over the axis.
    """
    s = axis_size(axis)
    idx = spmd.axis_index(axis)
    m = micro_in.shape[0]
    fwd = [(i, (i + 1) % s) for i in range(s)]

    buf = torch.zeros_like(micro_in[0])
    outs = torch.zeros_like(micro_in)
    for t in range(m + s - 1):
        # stage 0 injects microbatch t (if in range); others use arrival
        x = micro_in[min(t, m - 1)] if idx == 0 else buf
        y = stage_fn(stage_params, x)
        # the last stage records its result for microbatch t - (s-1)
        if idx == s - 1 and t >= s - 1:
            outs[t - (s - 1)] = y
        buf = spmd.ppermute(y, axis, fwd)
    # only the last stage wrote real outputs; psum broadcasts them (other
    # ranks hold zeros), making the result replicated over the axis
    return spmd.psum(outs, axis)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
