"""``axis_size``: the twin of the JAX package's ``parallel/compat.py``."""
from __future__ import annotations

from . import spmd


def axis_size(name: str, mesh=None) -> int:
    """Static size of the named mesh axis, inside *or* outside shard_map.

    Resolution order: an explicitly passed ``mesh``; the mesh of the
    enclosing :func:`~repro_torch.parallel.spmd.shard_map` rank; finally
    the ambient mesh of a ``with mesh:`` block, so helpers like the
    collective-matmul kernels and ZeRO-1 sharding arithmetic work when
    called outside a rank too."""
    if mesh is not None and name in getattr(mesh, "shape", {}):
        return int(dict(mesh.shape)[name])
    if spmd.in_shard_map():
        try:
            return spmd.axis_size(name)
        except NameError:
            pass
    amb = spmd.ambient_mesh()
    if amb is not None and name in amb.shape:
        return int(amb.shape[name])
    raise NameError(
        f"unbound axis name {name!r}: not inside shard_map and no "
        "ambient mesh (`with mesh:`) defines it")
