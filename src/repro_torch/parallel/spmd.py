"""Single-controller SPMD over explicit devices: the port's twin of what
JAX itself provides the JAX package's multi-device code —
``jax.sharding.Mesh``, ``shard_map`` and the ``jax.lax`` collectives
(``psum``, ``pmax``, ``psum_scatter``, ``all_gather``, ``ppermute``,
``axis_index``, ``axis_size``).

The JAX package is single-controller: ``stripe_jit(mesh=8)`` returns one
callable that takes global arrays in one process, and its tests emulate 8
devices in one process.  So is this module:

* :class:`Mesh` is an explicit array of one ``torch.device`` per rank,
  shaped like the mesh, with one name per axis.  A device may repeat:
  ``Mesh(["cuda:0"] * 4, ("x",))`` runs four ranks on one card, as
  ``Mesh(["cpu"] * 8, ("x",))`` runs eight on the CPU;
  ``Mesh(["cuda:0", "cuda:1", "cuda:2", "cuda:3"], ("x",))`` puts one
  rank on each card, and the collectives move data between them with
  peer copies.
* :func:`shard_map` runs ``body`` once per rank, in one thread per rank,
  with that rank's shards of the arguments on its device
  (``in_specs``), and assembles the global results (``out_specs``).
* The collectives are rendezvous between the rank threads: every rank
  of the call deposits its value, waits for the others, and combines the
  values of its group (the ranks that differ only along the named axes)
  on its own device.  Sums and maxima are taken in rank order, so a
  result does not depend on thread timing.  :func:`ppermute` zero-fills
  a rank that receives nothing, as ``jax.lax.ppermute`` does.
* A rank that raises aborts the rendezvous: every rank waiting in a
  collective raises :class:`RankAborted`, and :func:`shard_map` re-raises
  the first rank's own exception.  Each wait has a time limit
  (``timeout``, :data:`DEFAULT_TIMEOUT_S`): a rank that never reaches a
  collective the others wait in fails the call with
  :class:`CollectiveTimeout` instead of hanging it.

Each collective call of rank 0 is recorded when a caller asks for it
(:func:`recording`): ``core.mesh_lower.count_collectives`` counts the
collective call sites of one call that way, where the JAX package counts
the primitives of a jaxpr.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import tree as T

__all__ = ["Mesh", "P", "Placed", "shard_map", "psum", "pmax", "psum_scatter", "all_gather",
           "ppermute", "axis_index", "axis_size", "current_rank", "site", "recording", "ambient_mesh",
           "RankAborted", "CollectiveTimeout", "DEFAULT_TIMEOUT_S"]

# how long a rank waits in one collective for the others (seconds)
DEFAULT_TIMEOUT_S = 300.0

AxisName = Union[str, Tuple[str, ...]]


class RankAborted(RuntimeError):
    """Raised in a rank whose collective was aborted by another rank's
    exception."""


class CollectiveTimeout(RuntimeError):
    """Raised when a rank waited longer than the call's time limit for the
    other ranks to reach a collective."""


class Mesh:
    """An explicit device mesh: ``devices`` (nested lists, or an array, of
    ``torch.device`` or device strings) shaped like the mesh, one name in
    ``axis_names`` per axis.  ``shape`` maps each axis name to its size in
    order, as ``jax.sharding.Mesh.shape`` does.  ``with mesh:`` makes it
    the ambient mesh (``axis_size`` outside ``shard_map``)."""

    def __init__(self, devices, axis_names: Sequence[str] = ("x",)):
        arr = np.empty(np.shape(np.asarray(devices, dtype=object)), dtype=object)
        src = np.asarray(devices, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(src[idx])
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"Mesh: devices of shape {arr.shape} need {arr.ndim} axis "
                             f"names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"Mesh: axis names repeat: {axis_names}")
        self.devices = arr
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, (int(s) for s in arr.shape)))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat_devices(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))

    def coords(self, rank: int) -> Dict[str, int]:
        """The coordinate of flat rank ``rank`` along each axis."""
        idx = np.unravel_index(rank, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def __enter__(self):
        _ambient.stack = getattr(_ambient, "stack", []) + [self]
        return self

    def __exit__(self, *exc):
        _ambient.stack = _ambient.stack[:-1]
        return False

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.flat_devices()]}, shape={self.shape})")


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: one entry per
    leading dim of the value, each ``None`` (whole), an axis name, or a
    tuple of axis names (split over their combined size, the first
    major).  ``P()`` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class Placed:
    """A global value already cut into one shard a rank, each on its rank's
    device (``parallel.sharding.place``): :func:`shard_map` hands a rank
    its shard as it is, without the cut and copy it makes of a plain
    tensor on every call, so a rank that writes its shard in place (an
    optimizer step, a KV cache) writes the placed value."""

    __slots__ = ("mesh", "spec", "shards", "shape", "dtype")

    def __init__(self, mesh: "Mesh", spec: "P", shards: List[torch.Tensor], shape, dtype):
        self.mesh = mesh
        self.spec = P(*spec)
        self.shards = shards
        self.shape = torch.Size(shape)
        self.dtype = dtype

    def shard(self, mesh: "Mesh", rank: int, spec: "P") -> torch.Tensor:
        if mesh is not self.mesh:
            raise ValueError(f"shard_map: a value placed on {self.mesh} passed to a call on {mesh}")
        if _trim(spec) != _trim(self.spec):
            raise ValueError(f"shard_map: a value placed as {self.spec} passed with in_spec {spec}")
        return self.shards[rank]

    def __repr__(self) -> str:
        return f"Placed({tuple(self.shape)}, {self.dtype}, {self.spec})"


def _trim(spec) -> tuple:
    """A spec without its trailing whole dims (``P('x', None) == P('x')``)."""
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


_ambient = threading.local()
_local = threading.local()      # the rank context of a rank thread
_caller = threading.local()     # the recorder a caller installed


def ambient_mesh() -> Optional[Mesh]:
    """The innermost ``with mesh:`` of this thread, or None."""
    stack = getattr(_ambient, "stack", None)
    return stack[-1] if stack else None


# --------------------------------------------------------------------------
# recording collective call sites
# --------------------------------------------------------------------------
class _Recorder:
    def __init__(self):
        self.calls: List[Tuple[str, tuple]] = []


@contextlib.contextmanager
def recording():
    """Record rank 0's collective calls of every ``shard_map`` call made in
    this thread inside the block: yields a list that fills with
    ``(primitive, site)`` pairs, the site being the enclosing :func:`site`
    scopes and the calling line."""
    rec = _Recorder()
    prev = getattr(_caller, "recorder", None)
    _caller.recorder = rec
    try:
        yield rec.calls
    finally:
        _caller.recorder = prev


@contextlib.contextmanager
def site(tag):
    """Name a scope of collective calls inside a rank (``mesh_lower.emit``
    names each plan step): calls from the same line in two scopes are two
    call sites."""
    ctx = _ctx()
    ctx.scope = ctx.scope + (tag,)
    try:
        yield
    finally:
        ctx.scope = ctx.scope[:-1]


# --------------------------------------------------------------------------
# the rendezvous
# --------------------------------------------------------------------------
class _Group:
    """The ranks of one ``shard_map`` call: a barrier, one slot per rank,
    and which rank failed first."""

    def __init__(self, n: int, timeout: float):
        self.timeout = timeout
        self.barrier = threading.Barrier(n)
        self.slots: List[Any] = [None] * n
        self.failed: Optional[int] = None
        self.lock = threading.Lock()

    def fail(self, rank: int) -> None:
        with self.lock:
            if self.failed is None:
                self.failed = rank
        self.barrier.abort()

    def _wait(self, rank: int, what: str) -> None:
        try:
            self.barrier.wait(self.timeout)
        except threading.BrokenBarrierError:
            if self.failed is not None:
                raise RankAborted(f"{what} on rank {rank}: rank {self.failed} raised") from None
            raise CollectiveTimeout(
                f"{what} on rank {rank}: the ranks did not all arrive within "
                f"{self.timeout} s") from None

    def exchange(self, rank: int, value: Any, what: str) -> List[Any]:
        self.slots[rank] = value
        self._wait(rank, what)
        values = list(self.slots)
        self._wait(rank, what)
        return values


class _Rank:
    def __init__(self, mesh: Mesh, rank: int, group: _Group, recorder):
        self.mesh = mesh
        self.rank = rank
        self.group = group
        self.recorder = recorder
        self.device = mesh.flat_devices()[rank]
        self.coords = mesh.coords(rank)
        self.scope: tuple = ()


def _ctx() -> _Rank:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise NameError("not inside shard_map: collectives run only in a rank of "
                        "parallel.spmd.shard_map")
    return ctx


def _axes(ctx: _Rank, axis_name: AxisName) -> Tuple[str, ...]:
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    for a in axes:
        if a not in ctx.mesh.shape:
            raise NameError(f"unbound axis name {a!r}: the mesh's axes are "
                            f"{ctx.mesh.axis_names}")
    return axes


def _index_in(mesh: Mesh, coords: Dict[str, int], axes: Tuple[str, ...]) -> int:
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coords[a]
    return i


def _members(ctx: _Rank, axes: Tuple[str, ...]) -> List[int]:
    """The flat ranks of this rank's group along ``axes``, in group order."""
    mesh = ctx.mesh
    out: List[Tuple[int, int]] = []
    for r in range(mesh.size):
        c = mesh.coords(r)
        if all(c[a] == ctx.coords[a] for a in mesh.axis_names if a not in axes):
            out.append((_index_in(mesh, c, axes), r))
    return [r for _, r in sorted(out)]


def _record(ctx: _Rank, prim: str, stacklevel: int) -> None:
    """Record one call of ``prim`` at the line ``stacklevel`` frames above
    this one: the line that called the public collective."""
    if ctx.recorder is not None and ctx.rank == 0:
        f = sys._getframe(stacklevel)
        ctx.recorder.calls.append((prim, ctx.scope + ((f.f_code.co_filename, f.f_lineno),)))


def _gather_group(prim: str, x: Any, axis_name: AxisName,
                  stacklevel: int = 3) -> Tuple[_Rank, List[Any], int]:
    """Exchange ``x`` within this rank's group.  ``stacklevel`` counts the
    frames from :func:`_record` up to the collective's caller: 3 when a
    public collective calls this directly."""
    ctx = _ctx()
    _record(ctx, prim, stacklevel)
    axes = _axes(ctx, axis_name)
    values = ctx.group.exchange(ctx.rank, x, prim)
    members = _members(ctx, axes)
    return ctx, [values[r] for r in members], members.index(ctx.rank)


def _here(ctx: _Rank, t):
    return t.to(ctx.device) if isinstance(t, torch.Tensor) else torch.as_tensor(t, device=ctx.device)


def _reduce(prim: str, x: Any, axis_name: AxisName, op) -> Any:
    ctx, parts, _ = _gather_group(prim, x, axis_name, stacklevel=4)
    flat = [T.flatten(p)[0] for p in parts]
    _, treedef = T.flatten(x)
    out = []
    for j in range(len(flat[0])):
        acc = _here(ctx, flat[0][j]).clone()
        for p in flat[1:]:
            acc = op(acc, _here(ctx, p[j]))
        out.append(acc)
    return T.unflatten(treedef, out)


def psum(x: Any, axis_name: AxisName) -> Any:
    """The sum of ``x`` (a tensor or a tree of them) over the group, in
    rank order, on every rank of it."""
    return _reduce("psum", x, axis_name, torch.add)


def pmax(x: Any, axis_name: AxisName) -> Any:
    """The elementwise maximum of ``x`` over the group, on every rank."""
    return _reduce("pmax", x, axis_name, torch.maximum)


def psum_scatter(x: torch.Tensor, axis_name: AxisName, *, scatter_dimension: int = 0,
                 tiled: bool = False) -> torch.Tensor:
    """The group's sum of ``x``, of which group rank ``i`` keeps block ``i``
    along ``scatter_dimension``: a slice of size ``shape / n`` (``tiled``)
    or, untiled, index ``i`` of a dim of size ``n``, which is dropped."""
    ctx, parts, i = _gather_group("reduce_scatter", x, axis_name)
    n = len(parts)
    d = scatter_dimension
    fits = x.shape[d] % n == 0 if tiled else x.shape[d] == n
    if not fits:
        raise ValueError(f"psum_scatter: dim {d} of size {x.shape[d]} does not scatter "
                         f"over {n} ranks (tiled={tiled})")
    size = x.shape[d] // n
    acc = None
    for p in parts:
        blk = _here(ctx, p.narrow(d, i * size, size))
        acc = blk.clone() if acc is None else acc + blk
    return acc if tiled else acc.squeeze(d)


def all_gather(x: torch.Tensor, axis_name: AxisName, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Every group rank's ``x`` in group order: concatenated along
    ``axis`` (``tiled``) or stacked in a new dim there."""
    ctx, parts, _ = _gather_group("all_gather", x, axis_name)
    parts = [_here(ctx, p) for p in parts]
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def ppermute(x: torch.Tensor, axis_name: AxisName, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """Send ``x`` along ``perm``'s ``(source, destination)`` pairs of group
    indices; a rank that no pair names as destination receives zeros."""
    ctx, parts, i = _gather_group("ppermute", x, axis_name)
    srcs = [s for s, d in perm if d == i]
    if len(srcs) > 1:
        raise ValueError(f"ppermute: group rank {i} receives from {srcs}")
    if not srcs:
        return torch.zeros_like(x)
    return _here(ctx, parts[srcs[0]]).clone()


def axis_index(axis_name: AxisName) -> int:
    """This rank's index along the named axis (or axes, the first major)."""
    ctx = _ctx()
    return _index_in(ctx.mesh, ctx.coords, _axes(ctx, axis_name))


def axis_size(axis_name: AxisName) -> int:
    """The size of the named axis (or the product over the named axes) of
    the mesh this rank runs on."""
    ctx = _ctx()
    n = 1
    for a in _axes(ctx, axis_name):
        n *= ctx.mesh.shape[a]
    return n


def in_shard_map() -> bool:
    return getattr(_local, "ctx", None) is not None


def current_rank() -> Optional[int]:
    """The flat rank of the calling thread inside ``shard_map``, else None."""
    ctx = getattr(_local, "ctx", None)
    return None if ctx is None else ctx.rank


# --------------------------------------------------------------------------
# shard_map
# --------------------------------------------------------------------------
def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _map_spec(fn: Callable, value: Any, spec: Any) -> Any:
    """Apply ``fn(leaf, P)`` over ``value`` where ``spec`` is a tree prefix of
    it (a ``P`` covers every leaf below it)."""
    if isinstance(spec, P):
        return T.tree_map(lambda leaf: fn(leaf, spec), value)
    if isinstance(spec, dict):
        if not isinstance(value, dict) or set(value) != set(spec):
            raise ValueError(f"shard_map: spec keys {sorted(spec)} do not match the value")
        return {k: _map_spec(fn, value[k], spec[k]) for k in value}
    if isinstance(spec, (list, tuple)):
        if not isinstance(value, (list, tuple)) or len(value) != len(spec):
            raise ValueError("shard_map: spec and value lengths differ")
        return type(value)(_map_spec(fn, v, s) for v, s in zip(value, spec))
    raise TypeError(f"shard_map: a spec is a P or a dict / list / tuple of them, "
                    f"not {type(spec).__name__}")


def _shard(mesh: Mesh, rank: int, leaf: Any, spec: P) -> Any:
    device = mesh.flat_devices()[rank]
    if isinstance(leaf, Placed):
        return leaf.shard(mesh, rank, spec)
    if not isinstance(leaf, torch.Tensor):
        if any(_spec_axes(e) for e in spec):
            raise TypeError(f"shard_map: cannot split a {type(leaf).__name__} by {spec}")
        return leaf
    return block_of(mesh, rank, leaf, spec).to(device).contiguous()


def block_of(mesh: Mesh, rank: int, leaf: torch.Tensor, spec: P) -> torch.Tensor:
    """Rank ``rank``'s block of the global tensor ``leaf`` under ``spec``: a
    view of ``leaf``, where it lies."""
    coords = mesh.coords(rank)
    out = leaf
    for d, entry in enumerate(spec):
        axes = _spec_axes(entry)
        if not axes:
            continue
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        if out.shape[d] % n:
            raise ValueError(f"shard_map: dim {d} of size {out.shape[d]} does not split "
                             f"over {axes} ({n} ranks)")
        size = out.shape[d] // n
        out = out.narrow(d, _index_in(mesh, coords, axes) * size, size)
    return out


def _assemble(mesh: Mesh, values: List[Any], spec: P) -> Any:
    """The global value of one output leaf from every rank's leaf: split
    dims concatenated in rank order, the rest taken from the ranks at
    coordinate 0 of the axes the spec does not name."""
    home = mesh.flat_devices()[0]
    named = [a for e in spec for a in _spec_axes(e)]
    unnamed = [a for a in mesh.axis_names if a not in named]
    keep = [r for r in range(mesh.size) if all(mesh.coords(r)[a] == 0 for a in unnamed)]
    if not isinstance(values[0], torch.Tensor):
        return values[0]
    if not named:
        return values[0].to(home)

    def build(ranks: List[int], dims: List[Tuple[int, Tuple[str, ...]]]):
        if not dims:
            (r,) = ranks
            return values[r].to(home)
        d, axes = dims[0]
        by: Dict[int, List[int]] = {}
        for r in ranks:
            by.setdefault(_index_in(mesh, mesh.coords(r), axes), []).append(r)
        return torch.cat([build(by[i], dims[1:]) for i in sorted(by)], dim=d)

    return build(keep, [(d, _spec_axes(e)) for d, e in enumerate(spec) if _spec_axes(e)])


def shard_map(body: Callable, mesh: Mesh, in_specs: Any, out_specs: Any, *,
              timeout: Optional[float] = None) -> Callable:
    """``body`` run once per rank of ``mesh``, in one thread per rank.

    The returned callable takes global values: ``in_specs`` (one spec a
    positional argument, each a ``P`` or a tree prefix of ``P``) cuts each
    into this rank's shard on its device (a :class:`Placed` leaf gives
    the rank its shard as it is); ``out_specs`` (a tree prefix of
    ``body``'s result) puts the global results together on the mesh's
    first device (``P()``: rank 0's value, the others assumed equal, as
    with ``check_rep=False``).  Grad mode is the caller's.  ``timeout``
    limits each wait in a collective (:data:`DEFAULT_TIMEOUT_S`)."""
    limit = DEFAULT_TIMEOUT_S if timeout is None else float(timeout)

    def call(*args):
        if in_shard_map():
            raise RuntimeError("shard_map inside shard_map is not supported")
        specs = tuple(in_specs) if isinstance(in_specs, (list, tuple)) and not isinstance(
            in_specs, P) else (in_specs,)
        if len(specs) != len(args):
            raise ValueError(f"shard_map: {len(args)} arguments, {len(specs)} in_specs")
        n = mesh.size
        shards = [[_map_spec(lambda leaf, s, r=r: _shard(mesh, r, leaf, s), a, sp)
                   for a, sp in zip(args, specs)] for r in range(n)]
        group = _Group(n, limit)
        recorder = getattr(_caller, "recorder", None)
        grad = torch.is_grad_enabled()
        results: List[Any] = [None] * n
        errors: List[Optional[BaseException]] = [None] * n

        def run(r: int) -> None:
            ctx = _Rank(mesh, r, group, recorder)
            _local.ctx = ctx
            try:
                if ctx.device.type == "cuda":
                    # bind the card's context to this thread before any launch
                    torch.cuda.set_device(ctx.device)
                with torch.set_grad_enabled(grad):
                    results[r] = body(*shards[r])
            except BaseException as e:  # noqa: BLE001 - re-raised by the caller
                errors[r] = e
                if isinstance(e, (RankAborted, CollectiveTimeout)):
                    group.barrier.abort()
                else:
                    group.fail(r)
            finally:
                _local.ctx = None

        threads = [threading.Thread(target=run, args=(r,), name=f"spmd-rank-{r}",
                                    daemon=True) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for kind in (None, CollectiveTimeout, RankAborted):
            for e in errors:
                if e is not None and (isinstance(e, kind) if kind else not isinstance(
                        e, (RankAborted, CollectiveTimeout))):
                    raise e
        return _assemble_tree(mesh, results, out_specs)

    return call


def _assemble_tree(mesh: Mesh, results: List[Any], out_specs: Any) -> Any:
    """Assemble every output leaf over the ranks' results."""
    flat = [T.flatten(r) for r in results]
    leaves0, treedef = flat[0]
    # one spec per leaf: expand the prefix over rank 0's result
    specs = T.leaves(_map_spec(lambda leaf, s: _SpecLeaf(s), results[0], out_specs))
    out = [_assemble(mesh, [f[0][j] for f in flat], specs[j].spec)
           for j in range(len(leaves0))]
    return T.unflatten(treedef, out)


class _SpecLeaf:
    __slots__ = ("spec",)

    def __init__(self, spec: P):
        self.spec = spec
