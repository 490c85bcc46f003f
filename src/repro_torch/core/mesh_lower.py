"""Multi-device emission: play a :class:`~repro_torch.core.shardplan.ShardPlan`
inside :func:`~repro_torch.parallel.spmd.shard_map` (the twin of the JAX
package's ``core/mesh_lower.py``).

The driver compiles each of the plan's segments with the ordinary
single-device ``stripe_jit`` pipeline (per-block hybrid cuda/torch
composer, cache, tuning DB — everything), then :func:`emit` stitches
the compiled segments together with the plan's explicit collectives:

* ``halo`` — a ``ppermute`` pair moving each shard's boundary slabs to
  its neighbors, concatenated as padding.  The permutation is
  deliberately *not* cyclic: ranks that receive nothing are zero-filled
  by ``ppermute``, which is exactly the boundary masking the dropped
  frontend constraints used to provide.
* ``psum`` / ``all_gather`` — reduction-split partials and sharded
  program outputs.
* ``slice`` — localize a replicated buffer to this shard (no traffic).
* ``ring`` — ``parallel.collective_matmul``'s reduce-scatter matmul,
  the overlap primitive the cost model chose over a plain psum.

Execution always runs on a **flat 1-D mesh** (one ring axis over all
devices); a multi-dim mesh *shape* changes only the cost model's link
bandwidth, not the emitted program.  Each rank runs in its own thread
(``spmd``); on the card each rank's segments launch the kernels on its
device.  ``count_collectives`` / ``expected_primitive_counts`` close the
loop: tests and ``chip_smoke.py`` assert that the collectives the plan
predicted are the collectives one call makes.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Mapping

import torch

from ..parallel import spmd
from .shardplan import Segment, ShardPlan

# The ranks of one call share each compiled segment, and a segment's
# kernel launches fill launch records kept on its plans: one rank at a
# time runs a segment on the host (its launches are asynchronous, so the
# card still overlaps them).
_SEGMENT_LOCK = threading.Lock()


def resolve_mesh(mesh):
    """Normalize a ``mesh=`` argument (device count, mesh shape tuple, or
    :class:`~repro_torch.parallel.spmd.Mesh`) to ``(flat 1-D Mesh, axis
    name, model shape)``.  Returns ``None`` for a trivial (size-1 or
    ``None``) mesh — the caller should compile single-device.  A count or
    a shape takes the machine's first cards and raises when there are too
    few: it never runs on the CPU.  Emulated devices (several ranks on one
    card, or on the CPU) come only from a ``Mesh`` with explicit devices."""
    if mesh is None:
        return None
    if isinstance(mesh, spmd.Mesh):
        shape = tuple(int(s) for s in mesh.devices.shape)
        devs = mesh.flat_devices()
        if len(devs) <= 1:
            return None
        axis = mesh.axis_names[0] if len(mesh.axis_names) == 1 else "x"
        return spmd.Mesh(devs, (axis,)), str(axis), shape
    shape = (int(mesh),) if isinstance(mesh, int) else tuple(int(s) for s in mesh)
    n = 1
    for s in shape:
        n *= s
    if n <= 1:
        return None
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(
            f"mesh {shape} needs {n} devices; only {have} CUDA device(s) available "
            f"(pass a Mesh with explicit devices, e.g. Mesh(['cuda:0'] * {n}, ('x',)) "
            "or Mesh(['cpu'] * n, ('x',)), to emulate them)")
    return spmd.Mesh([f"cuda:{i}" for i in range(n)], ("x",)), "x", shape


def _halo_pad(x: torch.Tensor, dim: int, lo: int, hi: int, axis: str, n: int) -> torch.Tensor:
    parts = []
    if lo:
        tail = x.narrow(dim, x.shape[dim] - lo, lo)
        parts.append(spmd.ppermute(tail, axis, [(i, i + 1) for i in range(n - 1)]))
    parts.append(x)
    if hi:
        head = x.narrow(dim, 0, hi)
        parts.append(spmd.ppermute(head, axis, [(i + 1, i) for i in range(n - 1)]))
    return torch.cat(parts, dim=dim)


def emit(prog, plan: ShardPlan, segments: List[Segment], compiled: List,
         mesh: spmd.Mesh, axis: str):
    """Build the whole-program callable: ``shard_map`` over the plan's
    emission script, inner segments already compiled.  Takes global
    tensors (or arrays) keyed like the single-device driver and returns
    the global outputs on the mesh's first device."""
    from .lower_torch import torch_dtype

    n = plan.n
    in_order = list(prog.inputs)
    out_order = list(prog.outputs)
    in_specs = []
    for name in in_order:
        d = plan.in_specs.get(name, -1)
        rank = len(prog.buffers[name].shape)
        in_specs.append(spmd.P(*[axis if i == d else None for i in range(rank)])
                        if d >= 0 else spmd.P())

    def body(*args):
        env = dict(zip(in_order, args))
        for i, step in enumerate(plan.steps):
            kind = step[0]
            with spmd.site(i):
                if kind == "segment":
                    seg = segments[step[1]]
                    with _SEGMENT_LOCK:
                        outs = compiled[step[1]]({k: env[k] for k in seg.inputs})
                    env.update(outs)
                elif kind == "halo":
                    _, buf, dim, lo, hi = step
                    env[buf] = _halo_pad(env[buf], dim, lo, hi, axis, n)
                elif kind == "gather":
                    _, buf, dim = step
                    env[buf] = spmd.all_gather(env[buf], axis, axis=dim, tiled=True)
                elif kind == "slice":
                    _, buf, dim, size = step
                    r = spmd.axis_index(axis)
                    env[buf] = env[buf].narrow(dim, r * size, size).contiguous()
                elif kind == "psum":
                    env[step[1]] = spmd.psum(env[step[1]], axis)
                elif kind == "ring":
                    from ..parallel.collective_matmul import ring_matmul_reduce_scatter

                    info = step[2]
                    acc = ring_matmul_reduce_scatter(env[info["x"]], env[info["w"]], axis)
                    full = spmd.all_gather(acc, axis, axis=1, tiled=True)
                    env[info["out"]] = full.to(torch_dtype(info["out_dtype"]))
                else:
                    raise ValueError(f"unknown plan step {step!r}")
        return tuple(env[o] for o in out_order)

    sharded = spmd.shard_map(body, mesh, in_specs=tuple(in_specs),
                             out_specs=tuple(spmd.P() for _ in out_order))

    def call(arrays: Mapping[str, Any]) -> Dict[str, Any]:
        outs = sharded(*[a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
                         for a in (arrays[k] for k in in_order)])
        return dict(zip(out_order, outs))

    call._sharded = sharded
    call._in_order = in_order
    return call


# --------------------------------------------------------------------------
# predicted-vs-emitted collective accounting
# --------------------------------------------------------------------------
class CollectiveCounts(dict):
    """Collective call sites by primitive (the dict), and ``trips``: the
    calls rank 0 made by primitive (a ring's loop is one site, ``n - 1``
    trips)."""

    trips: Dict[str, int]


def count_collectives(fn, arrays: Mapping[str, Any]) -> CollectiveCounts:
    """Collective call sites of one call of ``fn`` on ``arrays``, by
    primitive name (``psum``, ``pmax``, ``all_gather``, ``ppermute``,
    ``reduce_scatter``): the port's twin of the JAX package's count of
    collective primitives in a jaxpr.  A call site is one calling line
    inside one plan step, so a ring's loop counts once, as the reference's
    static count does; the dynamic trips are in ``.trips``.  ``fn`` may be
    the driver's ``CompiledProgram``, the dict-calling callable
    :func:`emit` returns, or any positional callable."""
    by_dict = hasattr(fn, "_fn") or hasattr(fn, "_sharded")
    with spmd.recording() as calls:
        if by_dict:
            fn(arrays)
        else:
            fn(*arrays.values())
    counts = CollectiveCounts()
    for prim, where in dict.fromkeys(calls):
        counts[prim] = counts.get(prim, 0) + 1
    counts.trips = {}
    for prim, _ in calls:
        counts.trips[prim] = counts.trips.get(prim, 0) + 1
    return counts


def expected_primitive_counts(plan: ShardPlan) -> Dict[str, int]:
    """The collective call sites :func:`emit` produces for ``plan`` — what
    :func:`count_collectives` must report back.  A halo step is one
    ppermute per nonzero margin; a ring step is one ppermute (inside the
    ring's loop — one site, n - 1 trips) plus the epilogue all-gather."""
    counts: Dict[str, int] = {}

    def add(k: str, m: int = 1):
        if m:
            counts[k] = counts.get(k, 0) + m

    for step in plan.steps:
        kind = step[0]
        if kind == "halo":
            _, _, _, lo, hi = step
            add("ppermute", (1 if lo else 0) + (1 if hi else 0))
        elif kind == "gather":
            add("all_gather")
        elif kind == "psum":
            add("psum")
        elif kind == "ring":
            add("ppermute")
            add("all_gather")
    return counts


def expected_primitive_counts_from_record(mesh_info: Mapping[str, Any]) -> Dict[str, int]:
    """Same accounting as :func:`expected_primitive_counts`, but from the
    ``CompileRecord.mesh`` provenance dict (JSON round-trippable) — so a
    cached or persisted record can still be checked against a call."""
    counts: Dict[str, int] = {}

    def add(k: str, m: int = 1):
        if m:
            counts[k] = counts.get(k, 0) + m

    for c in mesh_info.get("collectives", ()):
        op = c["collective"]
        if op == "halo":
            add("ppermute", (1 if c.get("lo") else 0) + (1 if c.get("hi") else 0))
        elif op == "ring_matmul":
            add("ppermute")
            add("all_gather")
        else:
            add(op)
    return counts
