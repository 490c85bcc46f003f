"""Lowering Stripe programs to plain PyTorch (the "torch" backend).

The twin of the JAX package's jnp backend.  It consumes *frontend-shaped*
flat blocks (one polyhedron, a scalar-view load/compute/store body) and
emits tensor code:

* pure-index contractions        -> ``torch.einsum``
* windowed contractions (convs,
  strided/offset accesses)       -> pad + shifted-slice + einsum per window
  point, aggregated with the block's aggregation op, with halo constraints
  materialized as masks on the output grid (the paper's Fig. 4 "accesses to
  overflow elements are removed by constraints in execution")
* elementwise DAGs               -> broadcast + intrinsic table

PyTorch runs eagerly, so there is no jit wrap: a compile unit is a plain
Python function over tensors.  It is the CPU execution path of the tests,
the per-unit fallback of the CUDA composer (``lower_cuda``), and the A/B
path the serving engine's ``backend="torch"`` runs on the card.
Optimization passes do not change this lowering's semantics;
``lower_program_torch`` always lowers from the semantic (flat) form, which
passes preserve via the ``frontend`` tag.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .affine import Affine
from .flat import FlatOp, _Node, _product_leaves, analyze_flat
from .ir import AGG_IDENTITY, Block, Program, RefDir

_EINSUM_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"

# Same semantics as the JAX package's intrinsic tables: ``gelu`` is the
# exact erf form, ``cast`` is the identity (the store casts).
_J_UNARY = {
    "neg": torch.neg, "exp": torch.exp, "log": torch.log, "tanh": torch.tanh,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "sigmoid": torch.sigmoid,
    "relu": torch.relu, "abs": torch.abs, "square": torch.square,
    "erf": torch.erf, "gelu": lambda a: F.gelu(a, approximate="none"),
    "silu": F.silu, "sign": torch.sign, "floor": torch.floor, "cast": lambda a: a,
}
_J_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.true_divide, "max": torch.maximum, "min": torch.minimum,
    "pow": torch.pow,
}

_AGG_TORCH = {
    "add": torch.add, "max": torch.maximum, "min": torch.minimum, "mul": torch.mul,
}

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
    "bool": torch.bool,
}


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of an IR dtype name."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise TypeError(f"no torch dtype for IR dtype {name!r}") from None


def _is_int(name: str) -> bool:
    return str(name).startswith(("int", "uint"))


def _acc_dtype(out_dtype: str) -> torch.dtype:
    """Accumulator type: int -> int32, float64 -> float64, else float32."""
    if _is_int(out_dtype):
        return torch.int32
    if str(out_dtype) == "float64":
        return torch.float64
    return torch.float32


def _device_of(arrays: Mapping) -> torch.device:
    for v in arrays.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


# --------------------------------------------------------------------------
# Operand materialization
# --------------------------------------------------------------------------
def _pad(arr: torch.Tensor, pads: Sequence[Tuple[int, int]]) -> torch.Tensor:
    shape = [s + lo + hi for s, (lo, hi) in zip(arr.shape, pads)]
    out = arr.new_zeros(shape)
    out[tuple(slice(lo, lo + s) for s, (lo, _) in zip(arr.shape, pads))] = arr
    return out


def _materialize(arr: torch.Tensor, exprs: Sequence[Affine], ranges: Mapping[str, int],
                 wenv: Mapping[str, int]) -> Tuple[torch.Tensor, List[str]]:
    """Slice ``arr`` so each remaining axis corresponds to one index var.

    Every expr must reduce (after substituting ``wenv``) to ``c*v + k`` or a
    constant.  Returns (tensor, axis var names)."""
    var_axes: List[str] = []
    index: List[object] = []
    flips: List[int] = []
    pads: List[Tuple[int, int]] = []
    need_pad = False
    for d, e in enumerate(exprs):
        e = e.partial_eval(wenv)
        size = arr.shape[d]
        if e.is_const():
            k = e.const
            pl = max(0, -k)
            ph = max(0, k - (size - 1))
            pads.append((pl, ph))
            need_pad = need_pad or pl or ph
            index.append(k + pl)
        else:
            if len(e.terms) != 1:
                raise ValueError(f"unwindowed multi-var access {e}")
            (v, c), k = e.terms[0], e.const
            rv = ranges[v]
            lo = min(k, k + c * (rv - 1))
            hi = max(k, k + c * (rv - 1))
            pl = max(0, -lo)
            ph = max(0, hi - (size - 1))
            pads.append((pl, ph))
            need_pad = need_pad or pl or ph
            if c > 0:
                start = k + pl
                index.append(slice(start, start + c * (rv - 1) + 1, c))
            else:
                # torch slices take no negative step: slice ascending, then
                # flip the axis back into the var's order
                start = lo + pl
                index.append(slice(start, start + (-c) * (rv - 1) + 1, -c))
                flips.append(len(var_axes))
            var_axes.append(v)
    if need_pad:
        arr = _pad(arr, pads)
    out = arr[tuple(index)]
    if flips:
        out = torch.flip(out, flips)
    return out, var_axes


def _mask_on_grid(constraints, grid_vars: List[str], ranges, wenv, device):
    """AND of ``expr >= 0`` over the grid spanned by grid_vars."""
    shape = tuple(ranges[v] for v in grid_vars)
    mask = None
    for c in constraints:
        e = c.expr.partial_eval(wenv)
        if e.is_const():
            m = torch.full(shape, bool(e.const >= 0), device=device)
        else:
            acc = torch.full(shape, e.const, dtype=torch.int32, device=device)
            for n, coef in e.terms:
                ax = grid_vars.index(n)
                view = [1] * len(shape)
                view[ax] = shape[ax]
                iota = torch.arange(shape[ax], dtype=torch.int32, device=device).reshape(view)
                acc = acc + coef * iota
            m = acc >= 0
        mask = m if mask is None else (mask & m)
    return mask


def _unhandled_constraint_vars(constraints, wenv, allowed):
    out = set()
    for c in constraints:
        e = c.expr.partial_eval(wenv)
        for n in e.names():
            if n not in allowed:
                out.add(n)
    return out


# --------------------------------------------------------------------------
# Lowering paths
# --------------------------------------------------------------------------
def _einsum(eq: str, ops: Sequence[torch.Tensor], acc: torch.dtype) -> torch.Tensor:
    if acc == torch.int32 and ops and ops[0].is_cuda:
        # CUDA has no integer matrix product: float64 holds every partial
        # sum of int8/int16/int32-range operands exactly below 2**53
        return torch.einsum(eq, *[o.to(torch.float64) for o in ops]).to(acc)
    return torch.einsum(eq, *ops)


def _window_vars(op: FlatOp, leaves: List[_Node]) -> List[str]:
    """Vars that must be enumerated: every var beyond the first carrier in a
    multi-var access dim, plus constraint vars that are not output vars."""
    window: set = set()
    out_set = set(op.out_vars)
    if op.agg not in ("add", "assign"):
        # einsum can only sum; other aggregations enumerate every reduction
        # point and combine with the aggregation op across steps.
        window.update(v for v, r in op.ranges.items() if v not in out_set and r > 1)
    for leaf in leaves:
        for e in leaf.ref.offsets:
            names = [n for n in e.names() if op.ranges.get(n, 1) > 1]
            if len(names) <= 1:
                continue
            carriers = [n for n in names if n in out_set] or names
            carrier = max(carriers, key=lambda n: op.ranges[n])
            window.update(n for n in names if n != carrier)
    # constraints must end up over output vars only
    for _ in range(4):
        extra = _unhandled_constraint_vars(op.block.constraints, {w: 0 for w in window}, out_set)
        if not extra:
            break
        window.update(extra)
    return sorted(window)


def lower_contraction(op: FlatOp, leaves: List[_Node], scale: float) -> Callable:
    wvars = _window_vars(op, leaves)
    wsizes = [op.ranges[v] for v in wvars]
    n_steps = int(np.prod(wsizes)) if wvars else 1
    if n_steps > 16384:
        raise ValueError(f"window too large ({n_steps} steps)")
    out_shape = tuple(op.ranges[v] for v in op.out_vars)
    agg = op.agg
    identity = AGG_IDENTITY.get(agg, 0.0)
    out_dtype = torch_dtype(op.out_ref.dtype)
    acc_dtype = _acc_dtype(op.out_ref.dtype)

    def fn(arrays: Mapping[str, torch.Tensor]) -> torch.Tensor:
        acc = None
        device = _device_of(arrays)
        for combo in itertools.product(*[range(s) for s in wsizes]):
            wenv = dict(zip(wvars, combo))
            ops, labels = [], []
            for leaf in leaves:
                arr = arrays[leaf.ref.from_buf].to(acc_dtype)
                mat, axes = _materialize(arr, leaf.ref.offsets, op.ranges, wenv)
                ops.append(mat)
                labels.append(axes)
            var_letter: Dict[str, str] = {}
            for axes in labels + [op.out_vars]:
                for v in axes:
                    var_letter.setdefault(v, _EINSUM_LETTERS[len(var_letter)])
            eq = ",".join("".join(var_letter[v] for v in axes) for axes in labels)
            eq += "->" + "".join(var_letter[v] for v in op.out_vars)
            if leaves:
                term = _einsum(eq, ops, acc_dtype)
            else:
                term = torch.full(out_shape, 1, dtype=acc_dtype, device=device)
            if scale != 1.0:
                term = term * torch.tensor(scale, dtype=acc_dtype, device=device)
            mask = _mask_on_grid(op.block.constraints, op.out_vars, op.ranges, wenv, device)
            if mask is not None:
                term = torch.where(mask, term,
                                   torch.tensor(identity, dtype=acc_dtype, device=device))
            if acc is None:
                acc = term
            else:
                acc = _AGG_TORCH[agg](acc, term) if agg != "assign" else term
        return acc.to(out_dtype)

    return fn


def _eval_dag(n: _Node, arrays, op: FlatOp, cache, device) -> Tuple[torch.Tensor, List[str]]:
    key = id(n)
    if key in cache:
        return cache[key]
    if n.kind == "load":
        arr = arrays[n.ref.from_buf]
        res = _materialize(arr, n.ref.offsets, op.ranges, {})
    elif n.kind == "const":
        res = (torch.tensor(n.value, dtype=torch.float32, device=device), [])
    else:
        vals = [_eval_dag(a, arrays, op, cache, device) for a in n.args]
        # broadcast all args onto the union var order (output order first)
        union: List[str] = [v for v in op.out_vars]
        for _, axes in vals:
            for v in axes:
                if v not in union:
                    union.append(v)
        used = [v for v in union if any(v in axes for _, axes in vals)]
        bargs = []
        for val, axes in vals:
            if not axes:
                bargs.append(val)
                continue
            perm = [axes.index(v) for v in used if v in axes]
            a = val.permute(perm)
            shape = [op.ranges[v] if v in axes else 1 for v in used]
            bargs.append(a.reshape(shape))
        fn = _J_UNARY[n.op] if len(bargs) == 1 and n.op in _J_UNARY else _J_BINARY[n.op]
        res = (fn(*bargs), used)
    cache[key] = res
    return res


def _reduce(val: torch.Tensor, agg: str, dims: Tuple[int, ...]) -> torch.Tensor:
    if agg == "add":
        return torch.sum(val, dim=dims)
    if agg == "max":
        return torch.amax(val, dim=dims)
    if agg == "min":
        return torch.amin(val, dim=dims)
    if agg == "mul":
        for d in sorted(dims, reverse=True):
            val = torch.prod(val, dim=d)
        return val
    raise KeyError(agg)


def lower_general(op: FlatOp) -> Callable:
    """Elementwise DAGs (assign) and reductions of general DAGs."""
    out_dtype = torch_dtype(op.out_ref.dtype)
    red_vars = [v for v in sorted(op.ranges) if v not in op.out_vars and op.ranges[v] > 1]
    identity = AGG_IDENTITY.get(op.agg, 0.0)

    def fn(arrays: Mapping[str, torch.Tensor]) -> torch.Tensor:
        device = _device_of(arrays)
        cache: Dict[int, Tuple[torch.Tensor, List[str]]] = {}
        val, axes = _eval_dag(op.root, arrays, op, cache, device)
        grid = [v for v in (*op.out_vars, *red_vars)]
        full = [op.ranges[v] for v in grid]
        # expand to full grid order
        if axes:
            perm = [axes.index(v) for v in grid if v in axes]
            val = val.permute(perm)
            val = val.reshape([op.ranges[v] if v in axes else 1 for v in grid])
        val = val.expand(full) if val.dim() else val.reshape([1] * len(full)).expand(full)
        mask = _mask_on_grid(op.block.constraints, grid, op.ranges, {}, device)
        if mask is not None:
            val = torch.where(mask, val, torch.tensor(identity, dtype=val.dtype, device=device))
        if red_vars:
            val = _reduce(val, op.agg, tuple(range(len(op.out_vars), len(grid))))
        return val.to(out_dtype)

    return fn


def lower_block_torch(block: Block) -> Callable[[Mapping[str, torch.Tensor]], torch.Tensor]:
    op = analyze_flat(block)
    prod = _product_leaves(op.root)
    if op.agg != "assign" and prod is not None:
        leaves, scale = prod
        return lower_contraction(op, leaves, scale)
    # assign (no reduction vars allowed: a nondeterministic race) and
    # reductions of general DAGs
    return lower_general(op)


def _out_region(op: FlatOp, buf_shape: Tuple[int, ...]) -> Tuple[Tuple[int, int], ...]:
    region = []
    vi = 0
    for e in op.out_ref.offsets:
        if e.is_const():
            region.append((e.const, e.const + 1))
        else:
            v = op.out_vars[vi]
            vi += 1
            region.append((0, op.ranges[v]))
    return tuple(region)


class _LazyZeros(dict):
    """Tensor environment that materializes a zero buffer on first read —
    a fully-overwritten buffer never pays an init launch."""

    def __init__(self, base: Mapping, buffers: Mapping):
        super().__init__(base)
        self._buffers = buffers
        self._device = _device_of(base)

    def __missing__(self, key):
        d = self._buffers[key]
        v = torch.zeros(d.shape, dtype=torch_dtype(d.dtype), device=self._device)
        self[key] = v
        return v


def _group_executor(prog: Program, plans: Mapping[str, Tuple[Block, FlatOp, Callable]],
                    g: Sequence[str], internal: frozenset) -> Callable:
    """One fusion group as an executable unit: fn(arrays) -> updates dict.
    Group-internal intermediates never leave the unit."""

    def group_fn(arrays, g=tuple(g), internal=frozenset(internal)):
        local = _LazyZeros(arrays, prog.buffers)
        updates: Dict[str, torch.Tensor] = {}
        for name in g:
            blk, op, fn = plans[name]
            val = fn(local)
            buf = op.out_ref.from_buf
            full = local.get(buf)
            decl_shape = tuple(prog.buffers[buf].shape)
            region = _out_region(op, decl_shape)
            out_shape_full = tuple(hi - lo for lo, hi in region)
            val = val.reshape(out_shape_full)
            if out_shape_full == decl_shape:
                if op.agg != "assign" and full is not None:
                    # a previous writer's contribution is in the buffer:
                    # aggregate with it (each lowering computes its own
                    # complete reduction from the identity, so combining
                    # results with the agg op matches the reference's
                    # single accumulating buffer)
                    new = _AGG_TORCH[op.agg](full, val.to(full.dtype))
                else:
                    new = val
            else:
                if full is None:  # partially-written buffer: zero base
                    full = torch.zeros(decl_shape, dtype=torch_dtype(prog.buffers[buf].dtype),
                                       device=val.device)
                sl = tuple(slice(lo, hi) for lo, hi in region)
                if op.agg != "assign":
                    val = _AGG_TORCH[op.agg](full[sl], val.to(full.dtype))
                # functional update: the previous tensor may be a caller's
                new = full.clone()
                new[sl] = val.to(full.dtype)
            local[buf] = new
            if buf not in internal:
                updates[buf] = new
        return updates

    return group_fn


def _group_needed(plans, g: Sequence[str]) -> frozenset:
    """Buffers a group reads or writes."""
    needed = set()
    for n in g:
        blk, op, _fn = plans[n]
        needed.add(op.out_ref.from_buf)
        for r in blk.refs:
            if r.dir in (RefDir.IN, RefDir.INOUT):
                needed.add(r.from_buf)
    return frozenset(needed)


def lower_group_torch(prog: Program, names: Sequence[str]) -> Callable:
    """Lower the named semantic (frontend-shaped) op blocks as ONE unit:
    fn(arrays) -> {buffer: full tensor} updates.

    This is the per-unit fallback of the CUDA composer
    (``lower_cuda.lower_program_hybrid``): when one fusion group cannot
    lower to a kernel, only its member ops take the torch path, while the
    rest of the program keeps its kernels."""
    plans: Dict[str, Tuple[Block, FlatOp, Callable]] = {}
    want = set(names)
    for s in prog.entry.stmts:
        if isinstance(s, Block) and s.name in want:
            plans[s.name] = (s, analyze_flat(s), lower_block_torch(s))
    missing = [n for n in names if n not in plans]
    if missing:
        raise KeyError(f"op blocks {missing} not in program")
    fn = _group_executor(prog, plans, list(names), frozenset())
    needed = _group_needed(plans, list(names))

    def run(arrays: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return fn({b: arrays[b] for b in needed if b in arrays})

    run.needed = needed
    return run


def synchronize(tensors) -> None:
    """Wait for the card when any of ``tensors`` lives on it."""
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        torch.cuda.synchronize()


def lower_program_torch(prog: Program, groups: Optional[List[List[str]]] = None,
                        profile: bool = False
                        ) -> Callable[[Mapping[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Lower every op block; returns fn(inputs)->outputs dict.

    ``groups`` switches to **per-group lowering** (fusion groups from the
    pass pipeline): each group of semantic op-block names becomes one
    unit, and its internal intermediates stay local to the group (never
    entering the program-level tensor environment or the returned dict).

    ``profile=True`` wall-times each group (synchronizing the card after
    it), keeping the best observation per unit in ``run.unit_times`` keyed
    by the "+"-joined group member names.
    """
    plans: Dict[str, Tuple[Block, FlatOp, Callable]] = {}
    order: List[str] = []
    for s in prog.entry.stmts:
        if not isinstance(s, Block):
            continue
        plans[s.name] = (s, analyze_flat(s), lower_block_torch(s))
        order.append(s.name)

    if groups is None or sorted(n for g in groups for n in g) != sorted(order):
        groups = [[n] for n in order]

    # who reads each buffer, by op-block name (for internal-buffer elision)
    readers: Dict[str, set] = {}
    for name in order:
        for r in plans[name][0].refs:
            if r.dir in (RefDir.IN, RefDir.INOUT):
                readers.setdefault(r.from_buf, set()).add(name)

    elided: set = set()
    group_fns = []
    for g in groups:
        written = {plans[n][1].out_ref.from_buf for n in g}
        internal = {b for b in written
                    if b not in prog.outputs
                    and readers.get(b, set()) <= set(g)
                    and b != plans[g[-1]][1].out_ref.from_buf}
        elided |= internal
        needed = _group_needed(plans, g) | set(written)
        group_fn = _group_executor(prog, plans, g, frozenset(internal))
        group_fns.append(("+".join(g), group_fn, frozenset(needed)))

    unit_times: Dict[str, float] = {}

    def run(inputs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # Buffers are materialized lazily: a fully-overwriting producer
        # needs no zero-init launch; partially-written buffers start from
        # zeros inside their group.
        arrays: Dict[str, torch.Tensor] = {
            name: torch.as_tensor(inputs[name]) for name in prog.inputs}
        device = _device_of(arrays)
        for gname, gfn, needed in group_fns:
            if profile:
                t0 = time.perf_counter()
            updates = gfn({b: arrays[b] for b in needed if b in arrays})
            arrays.update(updates)
            if profile:
                synchronize(updates.values())
                dt = time.perf_counter() - t0
                prev = unit_times.get(gname)
                unit_times[gname] = dt if prev is None or dt < prev else prev
        for name, d in prog.buffers.items():
            if name not in arrays and name not in prog.inputs and name not in elided:
                arrays[name] = torch.zeros(d.shape, dtype=torch_dtype(d.dtype), device=device)
        return {n: arrays[n] for n in prog.buffers
                if n not in prog.inputs and n not in elided}

    run.n_kernels = len(group_fns)
    run.unit_times = unit_times
    return run
