"""Overlapped collective matmul (ring all-gather matmul), the twin of the
JAX package's ``parallel/collective_matmul.py``.

TP matmul x @ W with W sharded on its input dim normally requires
all-gather(x-shard) *then* matmul — serializing communication and
compute.  The ring formulation interleaves them: at each of N steps,
multiply the chunk currently held while passing the next chunk around
the ring.  The products are plain ``torch.matmul`` calls, as the
reference's are ``jnp`` products outside any Pallas kernel; the
collectives are :mod:`.spmd`'s.
"""
from __future__ import annotations

import torch

from . import spmd
from .compat import axis_size


def ring_allgather_matmul(x_shard: torch.Tensor, w: torch.Tensor,
                          axis: str = "model") -> torch.Tensor:
    """Sequence/batch-parallel -> column-parallel matmul with all-gather
    overlap, inside shard_map.

    x_shard: (M/N, K) — x sharded on rows over ``axis``;
    w:       (K, F_local) — this rank's column shard of W (full K).
    Returns (M, F_local): every rank's output for ALL rows — the x chunks
    travel a ring; at each step the chunk in hand is multiplied and the
    next one passed on.
    """
    n = axis_size(axis)
    idx = spmd.axis_index(axis)
    m_loc = x_shard.shape[0]
    perm = [(i, (i + 1) % n) for i in range(n)]
    out = torch.zeros((n * m_loc, w.shape[1]), dtype=x_shard.dtype, device=x_shard.device)
    chunk = x_shard
    for s in range(n):
        src = (idx - s) % n  # originating rank of the chunk in hand
        out[src * m_loc:(src + 1) * m_loc] = (chunk @ w).to(out.dtype)
        chunk = spmd.ppermute(chunk, axis, perm)
    return out


def ring_matmul_reduce_scatter(x_shard: torch.Tensor, w_shard: torch.Tensor,
                               axis: str = "model") -> torch.Tensor:
    """Row-parallel matmul with ring reduce-scatter overlap, inside
    shard_map.

    x_shard: (M, K/N) — activations sharded on K (as produced by a
    preceding column-parallel layer); w_shard: (K/N, F) — W rows sharded.
    Output: (M, F/N) — this rank's F-shard of x @ W.

    The accumulator that finishes at rank r travels the ring; when it
    visits rank q at step s, q adds its local partial for column block
    ``(q + n-1 - s) mod n`` — one (M,K/N)x(K/N,F/N) matmul a step.
    """
    n = axis_size(axis)
    idx = spmd.axis_index(axis)
    f = w_shard.shape[1]
    assert f % n == 0
    fc = f // n
    fwd = [(i, (i + 1) % n) for i in range(n)]
    xf = x_shard.to(torch.float32)

    def partial_for(b):
        return xf @ w_shard[:, b * fc:(b + 1) * fc].to(torch.float32)

    acc = partial_for((idx + n - 1) % n)
    for s in range(1, n):
        acc = spmd.ppermute(acc, axis, fwd)
        acc = acc + partial_for((idx + n - 1 - s) % n)
    return acc.to(x_shard.dtype)


def allgather_matmul_baseline(x_shard: torch.Tensor, w: torch.Tensor,
                              axis: str = "model") -> torch.Tensor:
    """Unoverlapped baseline: gather x fully, then one big matmul."""
    x = spmd.all_gather(x_shard, axis, axis=0, tiled=True)
    return x @ w
