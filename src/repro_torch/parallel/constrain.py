"""Mesh-aware sharding constraints usable from model code, the twin of the
JAX package's ``parallel/constrain.py``.

``constrain(x, 'model', None, ...)`` is the identity off a mesh (so the
same model code runs on one device).  Where the reference applies
``jax.lax.with_sharding_constraint`` for GSPMD to honour, the port has no
partitioner: its sharded step (``parallel/sharded.py``) lays every value
out itself.  So inside a rank of :func:`~.spmd.shard_map` ``constrain``
moves no data.  It resolves the spec by the reference's rule (an axis
group the mesh lacks a name of, or whose size does not divide the global
dim, is dropped), checks the rank's value against it, and records its
call site under :func:`~.spmd.recording`.

``shape`` is the value's global shape (default: ``x``'s own, a value the
rank holds whole).  Every dim the resolved spec names must be that global
dim divided by its axes' sizes.  A dim the spec leaves whole must hold a
block of the global dim: the reference would gather it with a copy,
which the port never makes, so its step may keep such a dim split (the
layer stack's batch on 'data', where the reference names the group
``('pod', 'data')`` and the mesh has no 'pod').
"""
from __future__ import annotations

from typing import Optional, Sequence

from . import spmd

__all__ = ["constrain"]


def _resolve(axes: Sequence, shape: Sequence[int], sizes) -> tuple:
    """The reference's rule: one entry per dim of ``shape``, each an axis
    name, a tuple of names, or None."""
    spec = []
    for d, a in enumerate(axes):
        if a is None:
            spec.append(None)
            continue
        group = (a,) if isinstance(a, str) else tuple(a)
        if not all(g in sizes for g in group):
            spec.append(None)
            continue
        total = 1
        for g in group:
            total *= sizes[g]
        if shape[d] % total != 0:
            spec.append(None)
            continue
        spec.append(a if isinstance(a, str) else tuple(a))
    return tuple(spec)


def constrain(x, *axes, shape: Optional[Sequence[int]] = None):
    """axes: one entry per dim — an axis name, a tuple of names, or None."""
    if not spmd.in_shard_map():
        return x   # one device, or an ambient mesh: the value is whole
    ctx = spmd._ctx()
    spmd._record(ctx, "constrain", 2)
    sizes = dict(ctx.mesh.shape)
    glob = tuple(x.shape) if shape is None else tuple(shape)
    if len(glob) != x.ndim:
        raise ValueError(f"constrain: a {x.ndim}-d value against a global shape {glob}")
    spec = _resolve(axes, glob, sizes)
    for d, entry in enumerate(spec):
        local = x.shape[d]
        if entry is None:
            ok = local > 0 and glob[d] % local == 0 if glob[d] else local == 0
        else:
            n = 1
            for g in ((entry,) if isinstance(entry, str) else entry):
                n *= sizes[g]
            ok = local * n == glob[d]
        if not ok:
            raise ValueError(f"constrain: rank {ctx.rank}'s value of shape {tuple(x.shape)} is "
                             f"not a block of the global shape {glob} under {spec} (dim {d})")
    return x
