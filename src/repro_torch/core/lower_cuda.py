"""CUDA backend: lower optimized (tiled/fused) Stripe blocks to the
hand-written CUDA C++ kernels (``csrc/contraction.cu``,
``csrc/elementwise.cu``, ``csrc/windowed.cu``).

The twin of the JAX package's Pallas backend.  Four parts:

* **Plan extraction**, copied from the Pallas backend and framework
  neutral: ``DimSpec``/``GridRef``, the tile-compute graph (``_TNode``),
  ``extract_contraction``, ``extract_elementwise`` and
  ``extract_windowed``.
* **The contraction emitter** (``_emit_contraction``): one fusion group —
  prologue DAGs on the operands, the contraction, the scale, the epilogue
  DAG (bias, activations, diamond joins, extra tensor inputs) — becomes one
  launch of the kernel.  The emitter flattens the group's block nest (grid
  -> tile -> leaf) into Stripe's own semantics: every index variable of
  every level gets, for each tensor the group touches, an element stride.
  Variables that address the output are parallel, *including output
  variables both operands share* (batch dims, e.g. the GQA heads of the
  serving ``scores``/``values`` programs); every other variable is summed,
  the TPU's sequential reduction grid axes included.  The plan's tile is
  an input to the flattening, not the launch shape.
* **The elementwise and windowed emitters** (``_emit_elementwise``,
  ``_emit_windowed``), flattened the same way: a map unit becomes one
  launch of the elementwise kernel; a halo, conv or masked-remainder unit
  one launch of the windowed kernel, whose inputs are addressed by affine
  coordinates (an out-of-range read is the reference's zero padding) and
  whose constraints are affine masks, so no operand is gathered.
* **The composer** ``lower_program_hybrid``: unit formation, wavefront
  order, output-region placement, refusal of overlapping writes, and a
  per-unit fallback to the torch backend for a unit no emitter takes (the
  reference's own legality fallbacks, e.g. a ``max=`` aggregation).

Tensors may be float32, bf16, f16, int8 or int32; every kernel accumulates
in the reference's ``_acc_dtype`` (int32 for an integer output, else
float32) and rounds once to the output's type.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from . import memplan
from .ir import (Block, Constant, Intrinsic, Load, Program, Refinement,
                 RefDir, Store, TensorDecl)
from .lower_torch import synchronize, torch_dtype
from ..kernels import _build
from ..kernels import contraction as K
from ..kernels import elementwise as EW
from ..kernels import windowed as WK

# Window positions one grid point may enumerate (the reference's unroll
# limit, kept so both backends take the same blocks).  The reference's
# MAX_HALO_BYTES has no counterpart: the windowed kernel reads halos in
# place instead of gathering them.
MAX_WINDOW_STEPS = 512


class UnsupportedCuda(Exception):
    """A block the CUDA emitters do not take (a legality fallback)."""


class _ProgramFallback(UnsupportedCuda):
    """A structural hazard no per-unit fallback can fix (e.g. two units
    accumulating into one buffer — composition by region placement would
    silently drop contributions, and the per-group torch executor would
    clobber them the same way).  Propagates out of the hybrid composer so
    the driver falls back wholesale."""


# --------------------------------------------------------------------------
# Pattern extraction
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DimSpec:
    """One dimension of a grid-block refinement: ``base + step*var`` start,
    ``size`` extent.  ``step < size`` (or ``base != 0``) is a halo window."""

    var: Optional[str]
    step: int
    base: int
    size: int

    @property
    def is_halo(self) -> bool:
        if self.var is None:
            return self.base != 0
        return self.step != self.size or self.base != 0


@dataclasses.dataclass
class GridRef:
    ref: Refinement
    block_shape: Tuple[int, ...]
    dim_vars: Tuple[Optional[str], ...]  # grid var addressing each dim
    dims: Tuple[DimSpec, ...] = ()

    @property
    def base(self) -> Tuple[int, ...]:
        return tuple(d.base for d in self.dims)

    @property
    def halo(self) -> bool:
        return any(d.is_halo for d in self.dims)


def _grid_ref(ref: Refinement, grid_ranges: Mapping[str, int],
              allow_base: bool = False, allow_halo: bool = False) -> GridRef:
    """Parse a grid-block refinement into per-dim (var, step, base, size).

    Default (strict) mode accepts only block-aligned views (step == size,
    base == 0) — the shape a plain BlockSpec can index.  ``allow_base``
    admits a constant base (the composer places the kernel's output region
    into the buffer); ``allow_halo`` admits overlapping windows (emitted
    over a materialized operand by the windowed path)."""
    dim_vars: List[Optional[str]] = []
    dims: List[DimSpec] = []
    for e, size in zip(ref.offsets, ref.shape):
        if e.is_const():
            if e.const != 0 and not (allow_base or allow_halo):
                raise UnsupportedCuda(f"non-zero const offset {e}")
            dim_vars.append(None)
            dims.append(DimSpec(None, 0, e.const, size))
        elif len(e.terms) == 1:
            (v, c) = e.terms[0]
            if v not in grid_ranges:
                raise UnsupportedCuda(f"offset var {v} is not a grid index")
            if c <= 0:
                raise UnsupportedCuda(f"non-positive offset step in {e}")
            if not allow_halo:
                if c != size:
                    raise UnsupportedCuda(
                        f"halo view: offset step {c} != block dim {size}")
                if e.const != 0 and not allow_base:
                    raise UnsupportedCuda(f"offset base {e.const} in {e}")
            dim_vars.append(v)
            dims.append(DimSpec(v, c, e.const, size))
        else:
            raise UnsupportedCuda(f"unsupported offset {e}")
    return GridRef(ref=ref, block_shape=tuple(ref.shape),
                   dim_vars=tuple(dim_vars), dims=tuple(dims))


@dataclasses.dataclass
class _TNode:
    """A node of the tile-compute graph (prologue/elementwise DAGs).

    Deliberately mirrors ``flat._Node`` (same kinds, same intrinsic
    tables) — the two walkers must stay in sync when intrinsics or DAG
    shapes are added, but operate at different granularities (whole-tile
    arrays here vs broadcast-materialized operands there)."""

    kind: str  # 'load' | 'const' | 'op'
    buf: str = ""
    value: float = 0.0
    op: str = ""
    args: Tuple["_TNode", ...] = ()

    def loads(self):
        if self.kind == "load":
            yield self
        for a in self.args:
            yield from a.loads()


def _leaf_root(stmts) -> _TNode:
    """Rebuild the expression DAG of a leaf statement list; returns the
    node stored by the (single) Store."""
    env: Dict[str, _TNode] = {}
    root: Optional[_TNode] = None
    for s in stmts:
        if isinstance(s, Load):
            env[s.into] = _TNode("load", buf=s.buf)
        elif isinstance(s, Constant):
            env[s.into] = _TNode("const", value=s.value)
        elif isinstance(s, Intrinsic):
            try:
                args = tuple(env[a] for a in s.args)
            except KeyError as e:
                raise UnsupportedCuda(f"undefined scalar {e} in leaf")
            env[s.into] = _TNode("op", op=s.op, args=args)
        elif isinstance(s, Store):
            root = env.get(s.scalar)
        elif isinstance(s, Block):
            raise UnsupportedCuda("nested block inside leaf")
    if root is None:
        raise UnsupportedCuda("leaf has no store")
    return root


def _split_sides(root: _TNode, sig_of: Mapping[str, Tuple]
                 ) -> Tuple[List[_TNode], float]:
    """Split the stored DAG into operand sides + a constant scale:
    top-level ``mul`` factors are grouped by the index pattern of their
    loads, so an elementwise prologue (e.g. ``gelu(A[i,c]) * B[c,j]``)
    stays attached to its operand side.  Returns 1 or 2 sides."""
    factors: List[_TNode] = []
    scale = 1.0
    stack = [root]
    while stack:
        n = stack.pop(0)
        if n.kind == "op" and n.op == "mul":
            stack = list(n.args) + stack
        elif n.kind == "const":
            scale *= n.value
        else:
            factors.append(n)
    groups: Dict[Tuple, List[_TNode]] = {}
    order: List[Tuple] = []
    for n in factors:
        sigs = set()
        for l in n.loads():
            if l.buf not in sig_of:
                raise UnsupportedCuda(f"leaf operand {l.buf} is not a grid input")
            sigs.add(sig_of[l.buf])
        if len(sigs) != 1:
            raise UnsupportedCuda("mixed index patterns inside one operand")
        sig = sigs.pop()
        if sig not in groups:
            groups[sig] = []
            order.append(sig)
        groups[sig].append(n)
    if not 1 <= len(order) <= 2:
        raise UnsupportedCuda(f"{len(order)} distinct operand groups (need 1 or 2)")

    def fold(ns: List[_TNode]) -> _TNode:
        out = ns[0]
        for n in ns[1:]:
            out = _TNode("op", op="mul", args=(out, n))
        return out

    return [fold(groups[s]) for s in order], scale


def _split_contraction(root: _TNode, sig_of: Mapping[str, Tuple]) -> Tuple[_TNode, _TNode, float]:
    sides, scale = _split_sides(root, sig_of)
    if len(sides) != 2:
        raise UnsupportedCuda(f"{len(sides)} distinct operand groups (need 2)")
    return sides[0], sides[1], scale


@dataclasses.dataclass
class ContractionPlan:
    grid_order: List[str]
    grid_sizes: Dict[str, int]
    in_refs: List[GridRef]
    out_ref: GridRef
    red_vars: List[str]
    lhs: _TNode
    rhs: _TNode
    lhs_bufs: List[str]  # grid-input names feeding each side, in spec order
    rhs_bufs: List[str]
    scale: float
    lhs_contract: Tuple[int, ...]
    rhs_contract: Tuple[int, ...]
    epilogue: List[object]
    acc_scalar: Optional[str]


@dataclasses.dataclass
class ElementwisePlan:
    grid_order: List[str]
    grid_sizes: Dict[str, int]
    in_refs: List[GridRef]
    out_ref: GridRef
    root: _TNode


def _leaf_of(block: Block) -> Block:
    cur = block
    while True:
        subs = cur.sub_blocks()
        if not subs:
            return cur
        if len(subs) != 1:
            raise UnsupportedCuda("multiple inner blocks")
        cur = subs[0]


def _is_constrained(block: Block) -> bool:
    """Does any block of this tree carry constraints?  The emitter trusts
    the passes' proofs instead of re-deriving them: ``boundary`` tags the
    pieces whose constraints ``prune_constraints`` fully discharged with
    ``interior`` (the whole tree is clean — skip the walk), and
    ``stencil`` tags the tiles whose stencil fit it established on an
    unconstrained body with ``dense`` (skip that block's check)."""
    if "interior" in block.tags:
        return False
    return any(b.constraints for b in block.walk() if "dense" not in b.tags)


def _check_no_constraints(block: Block) -> None:
    for b in block.walk():
        if b.constraints:
            raise UnsupportedCuda(
                f"constraints in block {b.name} (halo/overflow tiles)")


def _ensure_grid(outer: Block) -> Block:
    """Canonicalize a flat (``fits_inner``) or per-point fused block into
    the grid->tile shape the emitter expects, by splitting its output
    indices at full range (a 1-step grid per output dim)."""
    if "grid" in outer.tags:
        return outer
    from .tiling import split_block

    out_ref = next((r for r in outer.refs if r.dir in (RefDir.OUT, RefDir.INOUT)), None)
    if out_ref is None:
        raise UnsupportedCuda("no output ref")
    free = outer.idx_ranges()
    out_vars = [n for e in out_ref.offsets for n in e.names() if n in free]
    tiles = {v: free[v] for v in out_vars}
    if not tiles:
        raise UnsupportedCuda("no output indices to grid over")
    grid = split_block(outer, tiles, name_suffix="g", full_tiles=True)
    # the split is a pure canonicalization: proofs about the flat block
    # (boundary's interior tag) hold for its grid form
    if "interior" in outer.tags:
        grid.add_tag("interior")
    return grid


def _collect(outer: Block, allow_base: bool = False):
    """Common scaffolding: grid refs, local allocs, leaf stmts, epilogue.
    ``allow_base``: inputs may be viewed from a constant base (a boundary
    piece past the first tile)."""
    grid_ranges = {i.name: i.range for i in outer.idxs if not i.is_passthrough()}
    ins: List[GridRef] = []
    out: Optional[GridRef] = None
    local_alloc: Dict[str, Refinement] = {}
    for r in outer.refs:
        if r.dir == RefDir.IN:
            ins.append(_grid_ref(r, grid_ranges, allow_base=allow_base))
        elif r.dir in (RefDir.OUT, RefDir.INOUT):
            if out is not None:
                raise UnsupportedCuda("multiple outputs")
            out = _grid_ref(r, grid_ranges, allow_base=True)
        elif r.dir == RefDir.NONE:
            local_alloc[r.into] = r
    if out is None:
        raise UnsupportedCuda("no output ref")

    sub_blocks = outer.sub_blocks()
    epilogue: List[object] = []
    if sub_blocks:
        for b in sub_blocks[0].walk():
            for r in b.refs:
                if r.dir == RefDir.NONE:
                    local_alloc.setdefault(r.into, r)
        # Descend levels; at each level, trailing leaf statements after a
        # sub-block are the (pure elementwise) fused epilogue, which lifts
        # soundly from per-point to per-tile granularity.
        cur: Block = outer
        leaf_stmts: List = []
        while True:
            msubs = cur.sub_blocks()
            trailing = []
            seen = False
            for s in cur.stmts:
                if isinstance(s, Block):
                    seen = True
                elif seen:
                    trailing.append(s)
            if msubs and trailing:
                epilogue = trailing
                leaf_stmts = list(_leaf_of(msubs[0]).stmts)
                break
            if not msubs:
                leaf_stmts = list(cur.stmts)
                break
            if len(msubs) != 1:
                raise UnsupportedCuda("multiple inner blocks")
            cur = msubs[0]
    else:
        leaf_stmts = list(outer.stmts)
    return grid_ranges, ins, out, local_alloc, leaf_stmts, epilogue


def extract_contraction(outer: Block, allow_base: bool = False) -> ContractionPlan:
    grid_ranges, ins, out, local_alloc, leaf_stmts, epilogue = _collect(outer, allow_base)
    if (out.ref.agg or "assign") not in ("add", "assign"):
        # dot_general + the scratch accumulation only realize a SUM
        raise UnsupportedCuda(
            f"contraction aggregates with '{out.ref.agg}' (only add)")
    out_vars = {v for v in out.dim_vars if v}
    red_vars = [v for v in grid_ranges if v not in out_vars]
    grid_order = [v for v in grid_ranges if v in out_vars] + red_vars

    root = _leaf_root(leaf_stmts)
    sig_of = {g.ref.into: (g.dim_vars, g.block_shape) for g in ins}
    lhs, rhs, scale = _split_contraction(root, sig_of)

    acc_scalar: Optional[str] = None
    for s in epilogue:
        if isinstance(s, Load) and s.buf in local_alloc:
            acc_scalar = s.into

    def side_bufs(node: _TNode) -> List[str]:
        seen: List[str] = []
        for l in node.loads():
            if l.buf not in seen:
                seen.append(l.buf)
        return seen

    lhs_bufs, rhs_bufs = side_bufs(lhs), side_bufs(rhs)
    lhs_gr = next(g for g in ins if g.ref.into == lhs_bufs[0])
    rhs_gr = next(g for g in ins if g.ref.into == rhs_bufs[0])

    def contract_axes(gr: GridRef) -> List[int]:
        axes = []
        for d in range(gr.ref.rank):
            v = gr.dim_vars[d]
            if v is not None and v in out_vars:
                continue
            axes.append(d)
        return axes

    lhs_c, rhs_c = contract_axes(lhs_gr), contract_axes(rhs_gr)
    lhs_final, rhs_final, used = [], [], set()
    for a in lhs_c:
        for b in rhs_c:
            bv, av = rhs_gr.dim_vars[b], lhs_gr.dim_vars[a]
            if b in used or lhs_gr.block_shape[a] != rhs_gr.block_shape[b]:
                continue
            if av is not None and bv is not None and av != bv:
                continue  # distinct reduction vars never pair
            lhs_final.append(a)
            rhs_final.append(b)
            used.add(b)
            break
    if not lhs_final:
        raise UnsupportedCuda("no contraction dims found")

    return ContractionPlan(
        grid_order=grid_order, grid_sizes=grid_ranges, in_refs=ins, out_ref=out,
        red_vars=red_vars, lhs=lhs, rhs=rhs, lhs_bufs=lhs_bufs, rhs_bufs=rhs_bufs,
        scale=scale, lhs_contract=tuple(lhs_final), rhs_contract=tuple(rhs_final),
        epilogue=epilogue, acc_scalar=acc_scalar,
    )


def extract_elementwise(outer: Block) -> ElementwisePlan:
    grid_ranges, ins, out, _local, leaf_stmts, epilogue = _collect(outer)
    if epilogue:
        raise UnsupportedCuda("elementwise block with trailing epilogue")
    root = _leaf_root(leaf_stmts)
    # broadcast legality: each input's addressed dims must line up with the
    # trailing dims of the output tile (numpy broadcasting in the kernel)
    out_dv = list(out.dim_vars)
    for g in ins:
        dv = list(g.dim_vars)
        tail = out_dv[len(out_dv) - len(dv):] if len(dv) <= len(out_dv) else None
        if tail is None:
            raise UnsupportedCuda(f"input {g.ref.into} has higher rank than output")
        for d, v in enumerate(dv):
            if v is None and g.block_shape[d] == 1:
                continue
            if v != tail[d] and g.block_shape[d] != 1:
                raise UnsupportedCuda(
                    f"input {g.ref.into} dim {d} does not broadcast against the output")
    grid_order = [v for v in grid_ranges]
    if any(v not in {d for d in out.dim_vars if d} for v in grid_order):
        raise UnsupportedCuda("elementwise block with reduction index")
    return ElementwisePlan(grid_order=grid_order, grid_sizes=grid_ranges,
                           in_refs=ins, out_ref=out, root=root)


# --------------------------------------------------------------------------
# Windowed (halo / masked) extraction
# --------------------------------------------------------------------------
@dataclasses.dataclass
class WindowedPlan:
    """A constraint- or halo-carrying block as the windowed kernel sees it:
    grid refs (halo views allowed), the tile-level addressing of each
    input, enumerated window vars, and the constraint exprs that become
    masks over the output tile."""

    grid_order: List[str]
    grid_sizes: Dict[str, int]
    in_refs: List[GridRef]
    out_ref: GridRef
    red_vars: List[str]                      # grid vars revisiting the output
    tile_ranges: Dict[str, int]
    out_axis_vars: Tuple[Optional[str], ...]  # tile var per output dim
    inner_offsets: Dict[str, Tuple]          # ref.into -> tile-level offsets
    window_vars: List[str]
    agg: str                                 # "add" | "assign"
    sides: Optional[List[_TNode]]            # contraction sides (agg=add)
    root: Optional[_TNode]                   # full DAG (agg=assign)
    scale: float
    constraint_exprs: List                   # affine exprs, each ">= 0"


def extract_windowed(outer: Block) -> WindowedPlan:
    grid_ranges = {i.name: i.range for i in outer.idxs if not i.is_passthrough()}
    subs = outer.sub_blocks()
    if len(subs) != 1:
        raise UnsupportedCuda("windowed path needs exactly one tile block")
    if any(not isinstance(s, Block) for s in outer.stmts):
        raise UnsupportedCuda("windowed path does not support fused epilogues")
    tile = subs[0]
    if tile.sub_blocks():
        raise UnsupportedCuda("windowed path needs a flat tile block")

    ins: List[GridRef] = []
    out: Optional[GridRef] = None
    for r in outer.refs:
        if r.dir == RefDir.IN:
            ins.append(_grid_ref(r, grid_ranges, allow_halo=True))
        elif r.dir in (RefDir.OUT, RefDir.INOUT):
            if out is not None:
                raise UnsupportedCuda("multiple outputs")
            out = _grid_ref(r, grid_ranges, allow_base=True)
        elif r.dir == RefDir.NONE and not r.is_scalar_view():
            raise UnsupportedCuda("windowed path with non-scalar local view")
    if out is None:
        raise UnsupportedCuda("no output ref")
    agg = out.ref.agg or "assign"
    if agg not in ("add", "assign"):
        raise UnsupportedCuda(f"windowed path cannot aggregate with '{agg}'")

    tile_ranges = tile.idx_ranges()
    inner = {r.from_buf: r for r in tile.refs}

    # output tile addressing: one plain tile var (or const 0) per dim
    oref = inner.get(out.ref.into)
    if oref is None:
        raise UnsupportedCuda("tile block does not address the output view")
    out_axis_vars: List[Optional[str]] = []
    for e in oref.offsets:
        if e.is_const():
            if e.const != 0:
                raise UnsupportedCuda(f"non-zero inner output offset {e}")
            out_axis_vars.append(None)
        elif len(e.terms) == 1 and e.const == 0 and e.terms[0][1] == 1:
            out_axis_vars.append(e.terms[0][0])
        else:
            raise UnsupportedCuda(f"output tile offset {e} is not a plain index")
    out_vars = {v for v in out_axis_vars if v}

    # tile addressing of each input + window-var discovery
    inner_offsets: Dict[str, Tuple] = {}
    window: set = set()
    for gr in ins:
        ir = inner.get(gr.ref.into)
        if ir is None:
            raise UnsupportedCuda(f"tile block does not address input {gr.ref.into}")
        for e in ir.offsets:
            for n, c in e.terms:
                if n not in tile_ranges:
                    raise UnsupportedCuda(f"inner offset var {n} is not a tile index")
                if c <= 0:
                    raise UnsupportedCuda(f"negative inner offset step in {e}")
            names = [n for n in e.names() if tile_ranges.get(n, 1) > 1]
            if len(names) > 1:
                carriers = [n for n in names if n in out_vars] or names
                carrier = max(carriers, key=lambda n: tile_ranges[n])
                window.update(n for n in names if n != carrier)
        inner_offsets[gr.ref.into] = tuple(ir.offsets)

    # constraints close over window vars: any constraint var that is
    # neither an output-tile coordinate nor a grid index must be enumerated
    exprs = [c.expr for c in outer.constraints] + [c.expr for c in tile.constraints]
    for _ in range(4):
        extra = set()
        for e in exprs:
            for n in e.names():
                if n in out_vars or n in grid_ranges or n in window:
                    continue
                if n in tile_ranges:
                    extra.add(n)
                else:
                    raise UnsupportedCuda(f"constraint var {n} is not in scope")
        if not extra:
            break
        window |= extra
    if window & out_vars:
        raise UnsupportedCuda(
            f"window vars {sorted(window & out_vars)} address the output")
    window_vars = sorted(window)
    n_steps = 1
    for v in window_vars:
        n_steps *= tile_ranges[v]
    if n_steps > MAX_WINDOW_STEPS:
        raise UnsupportedCuda(f"window too large ({n_steps} unrolled steps)")

    out_grid_vars = {v for v in out.dim_vars if v}
    red_vars = [v for v in grid_ranges if v not in out_grid_vars]
    grid_order = [v for v in grid_ranges if v in out_grid_vars] + red_vars

    root = _leaf_root(tile.stmts)
    sides: Optional[List[_TNode]] = None
    scale = 1.0
    if agg == "add":
        sig_of = {gr.ref.into: tuple(str(e) for e in inner_offsets[gr.ref.into])
                  for gr in ins}
        sides, scale = _split_sides(root, sig_of)
        root = None
    else:
        # assign must be a pure per-point map: no enumerated windows, no
        # leftover reduction axes (a raced overwrite otherwise)
        if window_vars:
            raise UnsupportedCuda("assign block with window vars")
        if red_vars:
            raise UnsupportedCuda("assign block with grid reduction vars")
        leftover = [v for v, r in tile_ranges.items()
                    if r > 1 and v not in out_vars]
        if leftover:
            raise UnsupportedCuda(f"assign block with reduction tile vars {leftover}")

    return WindowedPlan(
        grid_order=grid_order, grid_sizes=grid_ranges, in_refs=ins, out_ref=out,
        red_vars=red_vars, tile_ranges=tile_ranges,
        out_axis_vars=tuple(out_axis_vars), inner_offsets=inner_offsets,
        window_vars=window_vars, agg=agg, sides=sides, root=root, scale=scale,
        constraint_exprs=exprs,
    )

# --------------------------------------------------------------------------
# Postfix compilation of the tile-compute DAGs
# --------------------------------------------------------------------------
_UNARY_CODE = {n: K.OP_UNARY + i for i, n in enumerate(K.UNARY_OPS)}
_BINARY_CODE = {n: K.OP_BINARY + i for i, n in enumerate(K.BINARY_OPS)}


class _Postfix:
    """Compiles DAGs to postfix programs sharing one constant table.  An
    integer unit (``int_mode``) takes only the ops closed over the
    integers: the kernels evaluate it in int32."""

    def __init__(self, int_mode: bool = False):
        self.consts: List[float] = []
        self.int_mode = int_mode

    def const(self, value: float) -> Tuple[int, int]:
        value = float(value)
        if value not in self.consts:
            self.consts.append(value)
        return (K.OP_CONST, self.consts.index(value))

    def op(self, name: str, nargs: int) -> Tuple[int, int]:
        if self.int_mode and name not in (K.INT_UNARY if nargs == 1 else K.INT_BINARY):
            raise UnsupportedCuda(f"intrinsic {name!r} on integers (an integer unit "
                                  f"evaluates in int32)")
        if nargs == 1 and name in _UNARY_CODE:
            return (_UNARY_CODE[name], 0)
        if nargs == 2 and name in _BINARY_CODE:
            return (_BINARY_CODE[name], 0)
        raise UnsupportedCuda(f"intrinsic {name!r} with {nargs} args has no kernel op-code")

    def tnode(self, n: _TNode, slot_of: Mapping[str, int]) -> List[Tuple[int, int]]:
        if n.kind == "load":
            return [(K.OP_LOAD, slot_of[n.buf])]
        if n.kind == "const":
            return [self.const(n.value)]
        out: List[Tuple[int, int]] = []
        for a in n.args:
            out += self.tnode(a, slot_of)
        return out + [self.op(n.op, len(n.args))]

    def epilogue(self, stmts, acc_scalar: Optional[str],
                 slot_of: Mapping[str, int]) -> List[Tuple[int, int]]:
        env: Dict[str, List[Tuple[int, int]]] = {}
        result: List[Tuple[int, int]] = [(K.OP_ACC, 0)]
        for s in stmts:
            if isinstance(s, Load):
                env[s.into] = ([(K.OP_ACC, 0)] if s.into == acc_scalar
                               else [(K.OP_LOAD, slot_of[s.buf])])
            elif isinstance(s, Constant):
                env[s.into] = [self.const(s.value)]
            elif isinstance(s, Intrinsic):
                code: List[Tuple[int, int]] = []
                for a in s.args:
                    code += env[a]
                env[s.into] = code + [self.op(s.op, len(s.args))]
            elif isinstance(s, Store):
                result = env[s.scalar]
        return result


# --------------------------------------------------------------------------
# Flattening a fusion group's block nest
# --------------------------------------------------------------------------
def _levels(outer: Block) -> Tuple[List[Block], Optional[int]]:
    """The chain of blocks from the grid block down to the leaf, and the
    index of the level whose trailing statements are the fused epilogue."""
    levels = [outer]
    epi: Optional[int] = None
    cur = outer
    while True:
        subs = cur.sub_blocks()
        if not subs:
            return levels, epi
        if len(subs) != 1:
            raise UnsupportedCuda("multiple inner blocks")
        seen = False
        for s in cur.stmts:
            if isinstance(s, Block):
                seen = True
            elif not seen:
                raise UnsupportedCuda(f"statement before the inner block of {cur.name}")
            elif epi not in (None, len(levels) - 1):
                raise UnsupportedCuda("fused epilogues at two levels")
            else:
                epi = len(levels) - 1
        cur = subs[0]
        levels.append(cur)


Coords = List[Tuple[Dict[str, int], int]]  # per dim: ({var: coef}, const)


class _Nest:
    """Index variables of every level of a block nest, and the element
    coordinates of a refinement as affine functions of them."""

    def __init__(self, levels: List[Block]):
        self.levels = levels
        self.ext: Dict[str, int] = {}
        self.level_of: Dict[str, int] = {}
        for li, b in enumerate(levels):
            for i in b.idxs:
                if not i.is_passthrough() and i.range > 1:
                    key = f"{li}:{i.name}"
                    self.ext[key] = i.range
                    self.level_of[key] = li

    def _name(self, li: int, name: str) -> Tuple[Dict[str, int], int]:
        for lj in range(li, -1, -1):
            for i in self.levels[lj].idxs:
                if i.name == name:
                    if i.is_passthrough():
                        if lj == 0:
                            raise UnsupportedCuda(f"pass-through index {name} at the grid")
                        return self.resolve(lj - 1, i.affine)
                    return {f"{lj}:{name}": 1}, 0
        raise UnsupportedCuda(f"index {name} is not in scope")

    def resolve(self, li: int, expr) -> Tuple[Dict[str, int], int]:
        coefs: Dict[str, int] = {}
        const = expr.const
        for n, c in expr.terms:
            sub, k = self._name(li, n)
            const += c * k
            for key, cc in sub.items():
                coefs[key] = coefs.get(key, 0) + c * cc
        return {k: c for k, c in coefs.items() if c != 0 and k in self.ext}, const

    def chain(self, li: int, name: str) -> Tuple[Optional[str], Optional[Refinement], Coords]:
        """Follow refinement ``name`` at level ``li`` out to its program
        buffer, summing the offsets of every level.  Returns (buffer, None,
        coords), or (None, local refinement, coords) when the chain ends at
        a block-local allocation."""
        dims: Optional[Coords] = None
        while li >= 0:
            blk = self.levels[li]
            try:
                r = blk.ref(name)
            except KeyError:
                raise UnsupportedCuda(f"{blk.name}: no refinement {name}") from None
            parts = [self.resolve(li, e) for e in r.offsets]
            if dims is None:
                dims = parts
            elif len(parts) != len(dims):
                raise UnsupportedCuda(f"refinement {name} changes rank")
            else:
                merged: Coords = []
                for (a, ka), (b, kb) in zip(dims, parts):
                    m = dict(a)
                    for key, c in b.items():
                        m[key] = m.get(key, 0) + c
                    merged.append(({k: c for k, c in m.items() if c != 0}, ka + kb))
                dims = merged
            if r.dir == RefDir.NONE:
                return None, r, dims
            name = r.from_buf
            li -= 1
        return name, None, dims


def _row_strides(shape: Sequence[int]) -> List[int]:
    out = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        out[d] = out[d + 1] * shape[d + 1]
    return out


def _reader(nest: _Nest, li: int, name: str, buffers: Mapping[str, TensorDecl],
            edges: Sequence[Tuple[Dict[str, int], int]] = ()
            ) -> Tuple[str, int, Dict[str, int]]:
    """(buffer, element base, element stride per variable) of one read.
    ``edges`` (a ragged piece's cut output dims: the variables' output
    coefficients, and the rows kept) bound a coordinate that walks a cut
    dim at a multiple of its output position by the rows that exist."""
    buf, _local, dims = nest.chain(li, name)
    if buf is None:
        raise UnsupportedCuda(f"{name} reads a block-local buffer")
    decl = buffers.get(buf)
    if decl is None:
        raise UnsupportedCuda(f"{name} reads unknown buffer {buf}")
    _check_dtype(buf, decl)
    shape = tuple(decl.shape)
    if len(shape) != len(dims):
        raise UnsupportedCuda(f"{name} addresses rank {len(dims)} of rank-{len(shape)} {buf}")
    strides = _row_strides(shape)
    base = 0
    vstride: Dict[str, int] = {}
    for d, ((coefs, const), size, st) in enumerate(zip(dims, shape, strides)):
        lo = const + sum(min(0, c * (nest.ext[k] - 1)) for k, c in coefs.items())
        hi = const + sum(max(0, c * (nest.ext[k] - 1)) for k, c in coefs.items())
        for ecoefs, rows in edges:
            k0 = next(iter(ecoefs))
            t = coefs.get(k0, 0) // ecoefs[k0]
            if t > 0 and all(coefs.get(k, 0) == t * c for k, c in ecoefs.items()):
                hi -= sum(t * c * (nest.ext[k] - 1) for k, c in ecoefs.items()) - t * (rows - 1)
        if lo < 0 or hi >= size:
            raise UnsupportedCuda(f"{name} reads [{lo}, {hi}] of dim {d} of {buf}{shape}")
        base += const * st
        for k, c in coefs.items():
            vstride[k] = vstride.get(k, 0) + c * st
    return buf, base, vstride


def _check_dtype(buf: str, decl: TensorDecl) -> str:
    if str(decl.dtype) not in _build.DTYPE_CODES:
        raise UnsupportedCuda(f"{buf} is {decl.dtype}; the kernels take "
                              f"{', '.join(_build.DTYPE_CODES)}")
    return str(decl.dtype)


def _output_map(nest: _Nest, out_li: int, out_name: str, out_ref: GridRef,
                grid_sizes: Mapping[str, int], buffers: Mapping[str, TensorDecl]):
    """The output region of a unit whose store is refinement ``out_name``
    at level ``out_li``: (region shape, region base in the buffer, output
    dimension and coefficient of every variable that addresses it, output
    type).  Each output dimension must be covered exactly once."""
    out_buf, _local, out_dims = nest.chain(out_li, out_name)
    if out_buf is None or out_buf != out_ref.ref.from_buf:
        raise UnsupportedCuda(f"the unit's store does not reach {out_ref.ref.from_buf}")
    decl = buffers.get(out_buf)
    if decl is None:
        raise UnsupportedCuda(f"output {out_buf} is not declared")
    out_dtype = _check_dtype(out_buf, decl)
    out_shape = tuple(s * (grid_sizes[v] if v else 1)
                      for s, v in zip(out_ref.block_shape, out_ref.dim_vars))
    base = out_ref.base
    out_of: Dict[str, Tuple[int, int]] = {}
    for d, (coefs, const) in enumerate(out_dims):
        if const != base[d]:
            raise UnsupportedCuda(f"inner constant offset on output dim {d}")
        for key, c in coefs.items():
            if c <= 0 or key in out_of:
                raise UnsupportedCuda(f"output variable {key} is not a plain index")
            out_of[key] = (d, c)
    for d, size in enumerate(out_shape):
        span = 0
        for c, e in sorted((c, nest.ext[k]) for k, (dd, c) in out_of.items() if dd == d):
            if c <= span:
                raise UnsupportedCuda(f"output dim {d} is written twice")
            span += c * (e - 1)
        if span + 1 != size:
            raise UnsupportedCuda(f"output dim {d}: variables cover {span + 1} of {size}")
    return out_shape, base, out_of, out_dtype


def _launch_order(out_keys: List[str], ostr: Mapping[str, int], ext: Mapping[str, int],
                  big: Mapping[str, int]) -> List[str]:
    """Output variable 0 is the one with the smallest output stride (the
    threads of a warp store side by side); then the variables the largest
    operand ``big`` does not depend on (blocks that read its same columns
    run side by side), then by extent."""
    if not out_keys:
        return []
    v0 = min(out_keys, key=lambda k: (ostr[k], -ext[k]))
    rest = sorted((k for k in out_keys if k != v0),
                  key=lambda k: (big.get(k, 0) != 0, ext[k]))
    return [v0] + rest


def _merge_vars(keys: List[str], ext: Dict[str, int], tables: List[Dict[str, int]],
                same=lambda a, b: True) -> List[str]:
    """Undo tile splits: merge an outer variable ``b`` into an inner ``a``
    when their strides compose in every table (``stride[b] == stride[a] *
    ext[a]``), so one variable walks the whole logical dimension.  Updates
    ``ext`` and ``tables`` in place; returns the remaining variables."""
    keys = list(keys)
    while True:
        pair = next(((a, b) for a in keys for b in keys
                     if a != b and same(a, b)
                     and all(t.get(b, 0) == t.get(a, 0) * ext[a] for t in tables)), None)
        if pair is None:
            return keys
        a, b = pair
        ext[a] *= ext[b]
        keys.remove(b)
        for t in tables:
            t.pop(b, None)


def _as_input(a, decl: TensorDecl) -> torch.Tensor:
    t = torch.as_tensor(a)
    if tuple(t.shape) != tuple(decl.shape):
        raise ValueError(f"{decl.name}: got shape {tuple(t.shape)}, declared {tuple(decl.shape)}")
    return t


def _edge_cut(nest: _Nest, out_of: Mapping[str, Tuple[int, int]]
              ) -> Dict[int, Tuple[Dict[str, int], int]]:
    """The output dims a ragged piece cuts, and where: ``{dim: (the dim's
    variables at their output coefficients, rows kept)}``.  A boundary
    piece of an output dim the tile does not divide carries the constraint
    "this dim's position in the region <= r - 1" (the sum of the dim's
    variables at their output coefficients): the piece is the contraction
    over the first r rows.  Any other constraint (one over a reduction
    variable, a halo, two dims at once) raises."""
    cut: Dict[int, Tuple[Dict[str, int], int]] = {}
    for li, blk in enumerate(nest.levels):
        if "dense" in blk.tags:
            continue  # the stencil pass proved its constraints redundant
        for c in blk.constraints:
            coefs, const = nest.resolve(li, c.expr)
            dims = {out_of[k][0] if k in out_of else None for k in coefs}
            if len(dims) != 1 or None in dims:
                raise UnsupportedCuda(f"constraint {c} is not the edge of one output dim")
            (d,) = dims
            on_d = {k: cc for k, (dd, cc) in out_of.items() if dd == d}
            if coefs != {k: -cc for k, cc in on_d.items()} or const < 0:
                raise UnsupportedCuda(f"constraint {c} is not the edge of output dim {d}")
            rows = min(const + 1, cut.get(d, (None, const + 1))[1])
            cut[d] = (on_d, rows)
    return cut


def _emit_contraction(plan: ContractionPlan, outer: Block,
                      buffers: Mapping[str, TensorDecl],
                      mp: Optional[memplan.BlockPlan] = None,
                      ragged: bool = False) -> Callable:
    """One fusion group as one launch of the contraction kernel.  With
    ``ragged`` the group is a boundary piece whose constraints cut output
    dims (``_edge_cut``): its launch covers the rows kept."""
    has_red = bool(plan.red_vars)
    # The memory plan must agree with the emitter's own reduction analysis,
    # exactly as the Pallas emitter demands (same legality, same units).
    if mp is not None:
        if (mp.acc_bytes > 0) != has_red or set(mp.red_vars) != set(plan.red_vars):
            raise UnsupportedCuda(
                f"memory plan disagrees with emitter: plan acc={mp.acc_bytes}B "
                f"red={sorted(mp.red_vars)} vs emitter red={sorted(plan.red_vars)}")
        out_elems = math.prod(plan.out_ref.block_shape)
        if has_red and mp.acc_bytes != out_elems * 4:
            raise UnsupportedCuda(
                f"planned scratch {mp.acc_bytes}B != f32 out tile {out_elems * 4}B")

    levels, epi_level = _levels(outer)
    nest = _Nest(levels)
    leaf_li = len(levels) - 1
    leaf_store = _leaf_store(levels)
    if epi_level is None:
        out_li, out_name = leaf_li, leaf_store.buf
    else:
        _buf, local, _dims = nest.chain(leaf_li, leaf_store.buf)
        if local is None or not local.is_scalar_view():
            raise UnsupportedCuda("the fused contraction does not accumulate into a scalar local")
        stores = [s for s in plan.epilogue if isinstance(s, Store)]
        if len(stores) != 1:
            raise UnsupportedCuda(f"epilogue has {len(stores)} stores")
        out_li, out_name = epi_level, stores[0].buf
    # output variables: one dim each, a mixed-radix cover of the region
    out_shape, base, out_of, out_dtype = _output_map(nest, out_li, out_name, plan.out_ref,
                                                     plan.grid_sizes, buffers)
    if epi_level is not None and any(nest.level_of[k] > epi_level for k in out_of):
        raise UnsupportedCuda("an inner level writes the fused accumulator")
    red_keys = [k for k in nest.ext if k not in out_of]
    cut = _edge_cut(nest, out_of) if ragged else {}
    edges = list(cut.values())
    out_shape = tuple(min(n, cut[d][1]) if d in cut else n for d, n in enumerate(out_shape))

    # operands: lhs loads then rhs loads, as leaf refinements
    slot_names: List[str] = []
    for side in (plan.lhs, plan.rhs):
        for ld in side.loads():
            if ld.buf not in slot_names:
                slot_names.append(ld.buf)
    readers = [_reader(nest, leaf_li, n, buffers, edges) for n in slot_names]
    epi_names: List[str] = []
    for s in plan.epilogue:
        if isinstance(s, Load) and s.into != plan.acc_scalar and s.buf not in epi_names:
            epi_names.append(s.buf)
    ereaders = [_reader(nest, epi_level, n, buffers, edges) for n in epi_names]
    for (buf, _b, vs), n in zip(ereaders, epi_names):
        if any(vs.get(k, 0) for k in red_keys):
            raise UnsupportedCuda(f"epilogue input {n} varies over the reduction")

    # the plan's tile split the logical dims into grid and tile variables:
    # merge them back, so the launch shape follows the tensors, not the tile
    ext = dict(nest.ext)
    rs = _row_strides(out_shape)
    ostr = {k: c * rs[d] for k, (d, c) in out_of.items()}
    vtables = [r[2] for r in readers + ereaders]
    out_keys = _merge_vars(list(out_of), ext, [ostr] + vtables,
                           same=lambda a, b: out_of[a][0] == out_of[b][0])
    red_keys = _merge_vars(red_keys, ext, [r[2] for r in readers])
    for d in cut:
        keys = [k for k in out_keys if out_of[k][0] == d]
        if len(keys) != 1 or out_of[keys[0]][1] != 1:
            raise UnsupportedCuda(f"the cut output dim {d} is not one unit-stride variable")
        ext[keys[0]] = out_shape[d]

    big = max(readers, key=lambda r: math.prod(buffers[r[0]].shape))[2] if readers else {}
    out_order = _launch_order(out_keys, ostr, ext, big)
    red_order = sorted(red_keys, key=lambda k: -ext[k])

    def slot(r) -> K.Slot:
        buf, b, vs = r
        return K.Slot(buf=buf, base=b, ostride=tuple(vs.get(k, 0) for k in out_order),
                      rstride=tuple(vs.get(k, 0) for k in red_order),
                      dtype=str(buffers[buf].dtype))

    pf = _Postfix(int_mode=K.acc_dtype(out_dtype) == "int32")
    slot_of = {n: i for i, n in enumerate(slot_names)}
    lhs = tuple(pf.tnode(plan.lhs, slot_of))
    rhs = tuple(pf.tnode(plan.rhs, slot_of))
    epi = (tuple(pf.epilogue(plan.epilogue, plan.acc_scalar,
                             {n: i for i, n in enumerate(epi_names)}))
           if plan.epilogue else ())
    limits = [(len(out_order), K.MAXV, "output variables"),
              (len(red_order), K.MAXV, "reduction variables"),
              (len(slot_names), K.MAXS, "operands"), (len(epi_names), K.MAXE, "epilogue inputs"),
              (max(len(lhs), len(rhs), len(epi)), K.MAXP, "program length"),
              (len(pf.consts), K.MAXC, "constants"), (len(out_shape), K.MAXD, "output rank"),
              (max(K.stack_depth(p) for p in (lhs, rhs, epi or ((K.OP_ACC, 0),))),
               K.MAXSTACK, "stack depth")]
    for n, cap, what in limits:
        if n > cap:
            raise UnsupportedCuda(f"{n} {what} (the kernel takes {cap})")

    kplan = K.KernelPlan(
        out_vars=tuple(out_order), out_ext=tuple(ext[k] for k in out_order),
        out_dim=tuple(out_of[k][0] for k in out_order),
        out_coef=tuple(out_of[k][1] for k in out_order), out_shape=out_shape,
        red_vars=tuple(red_order), red_ext=tuple(ext[k] for k in red_order),
        slots=tuple(slot(r) for r in readers), eslots=tuple(slot(r) for r in ereaders),
        lhs=lhs, rhs=rhs, epi=epi, consts=tuple(pf.consts), scale=float(plan.scale),
        out_dtype=out_dtype)

    return _contraction_fn(kplan, buffers, base)


def _contraction_fn(kplan: K.KernelPlan, buffers: Mapping[str, TensorDecl],
                    base: Tuple[int, ...]) -> Callable:
    """The launch of ``kplan``, writing its region at ``base``."""
    out_shape = kplan.out_shape

    def operands(arrays):
        return ([_as_input(arrays[s.buf], buffers[s.buf]) for s in kplan.slots],
                [_as_input(arrays[s.buf], buffers[s.buf]) for s in kplan.eslots])

    def fn(arrays: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return K.contraction(kplan, *operands(arrays), getattr(fn, "out_clip", out_shape))

    def plain(arrays: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return K.contraction_plain(kplan, *operands(arrays), getattr(fn, "out_clip", out_shape))

    fn.out_shape = out_shape
    fn.out_dtype = torch_dtype(kplan.out_dtype)
    fn.out_base = base
    fn.in_bufs = [s.buf for s in kplan.slots + kplan.eslots]
    fn.plan = kplan
    fn.plain = plain
    fn.kernel = "contraction"
    return fn


def _joined(a: Callable, b: Callable, buffers: Mapping[str, TensorDecl]) -> Optional[Callable]:
    """One launch for two contraction pieces of one unit whose regions
    meet along one output dim, ``b`` right after ``a``, walked by one
    unit-stride variable (an interior piece and the ragged edge the
    boundary pass split off it); None when they do not."""
    if a.kernel != "contraction" or b.kernel != "contraction" or a.out_buf != b.out_buf:
        return None
    pa, pb = a.plan, b.plan
    same = ("out_vars", "out_dim", "out_coef", "red_vars", "red_ext", "lhs", "rhs", "epi",
            "consts", "scale", "out_dtype")
    if any(getattr(pa, f) != getattr(pb, f) for f in same):
        return None
    dims = [d for d, (x, y) in enumerate(zip(a.out_base, b.out_base)) if x != y]
    if len(dims) != 1:
        return None
    (d,) = dims
    on_d = [i for i, dd in enumerate(pa.out_dim) if dd == d]
    if (len(on_d) != 1 or pa.out_coef[on_d[0]] != 1
            or b.out_base[d] != a.out_base[d] + pa.out_shape[d]
            or any(pa.out_shape[e] != pb.out_shape[e] for e in range(len(pa.out_shape))
                   if e != d)):
        return None
    (i,) = on_d
    if pa.out_ext[i] != pa.out_shape[d] or pb.out_ext[i] != pb.out_shape[d] or any(
            x != y for v, (x, y) in enumerate(zip(pa.out_ext, pb.out_ext)) if v != i):
        return None
    for sa, sb in zip(pa.slots + pa.eslots, pb.slots + pb.eslots):
        if (sa.buf, sa.ostride, sa.rstride, sa.dtype) != (sb.buf, sb.ostride, sb.rstride, sb.dtype) \
                or sb.base - sa.base != pa.out_ext[i] * sa.ostride[i]:
            return None
    ext = list(pa.out_ext)
    ext[i] += pb.out_ext[i]
    shape = list(pa.out_shape)
    shape[d] += pb.out_shape[d]
    plan = dataclasses.replace(pa, out_ext=tuple(ext), out_shape=tuple(shape), _cparams={})
    fn = _contraction_fn(plan, buffers, a.out_base)
    fn.out_buf = a.out_buf
    return fn


def _join_pieces(fns: List[Callable], buffers: Mapping[str, TensorDecl]) -> List[Callable]:
    """Join a unit's contraction pieces (``_joined``) while any two meet."""
    fns = list(fns)
    while True:
        pair = next(((i, j, f) for i in range(len(fns)) for j in range(len(fns))
                     if i != j for f in [_joined(fns[i], fns[j], buffers)] if f is not None),
                    None)
        if pair is None:
            return fns
        i, j, f = pair
        fns[i] = f
        del fns[j]


def _leaf_store(levels: List[Block]) -> Store:
    stores = [s for s in levels[-1].stmts if isinstance(s, Store)]
    if len(stores) != 1:
        raise UnsupportedCuda(f"leaf has {len(stores)} stores")
    return stores[0]


def _load_names(*nodes: _TNode) -> List[str]:
    names: List[str] = []
    for n in nodes:
        for ld in n.loads():
            if ld.buf not in names:
                names.append(ld.buf)
    return names


def _check_limits(limits) -> None:
    for n, cap, what in limits:
        if n > cap:
            raise UnsupportedCuda(f"{n} {what} (the kernel takes {cap})")


def _emit_elementwise(plan: ElementwisePlan, outer: Block,
                      buffers: Mapping[str, TensorDecl]) -> Callable:
    """One map unit as one launch of the elementwise kernel: the block
    nest flattened to variables that all address the output, each input
    read through its per-variable strides (0 where it broadcasts)."""
    levels, epi_level = _levels(outer)
    if epi_level is not None:
        raise UnsupportedCuda("elementwise block with trailing epilogue")
    nest = _Nest(levels)
    leaf_li = len(levels) - 1
    out_shape, base, out_of, out_dtype = _output_map(
        nest, leaf_li, _leaf_store(levels).buf, plan.out_ref, plan.grid_sizes, buffers)
    extra = [k for k in nest.ext if k not in out_of]
    if extra:
        raise UnsupportedCuda(f"elementwise variables {extra} do not address the output")
    names = _load_names(plan.root)
    if not names:
        raise UnsupportedCuda("elementwise unit with no input")
    readers = [_reader(nest, leaf_li, n, buffers) for n in names]

    ext = dict(nest.ext)
    rs = _row_strides(out_shape)
    ostr = {k: c * rs[d] for k, (d, c) in out_of.items()}
    out_keys = _merge_vars(list(out_of), ext, [ostr] + [r[2] for r in readers],
                           same=lambda a, b: out_of[a][0] == out_of[b][0])
    order = _launch_order(out_keys, ostr, ext, {})
    pf = _Postfix(int_mode=K.acc_dtype(out_dtype) == "int32")
    prog = tuple(pf.tnode(plan.root, {n: i for i, n in enumerate(names)}))
    _check_limits([(len(order), K.MAXV, "output variables"), (len(names), K.MAXE, "inputs"),
                   (len(prog), K.MAXP, "program length"), (len(pf.consts), K.MAXC, "constants"),
                   (len(out_shape), K.MAXD, "output rank"),
                   (K.stack_depth(prog), K.MAXSTACK, "stack depth")])
    mplan = EW.MapPlan(
        out_vars=tuple(order), out_ext=tuple(ext[k] for k in order),
        out_dim=tuple(out_of[k][0] for k in order),
        out_coef=tuple(out_of[k][1] for k in order), out_shape=out_shape,
        ins=tuple(K.Slot(buf=buf, base=b, ostride=tuple(vs.get(k, 0) for k in order),
                         rstride=(), dtype=str(buffers[buf].dtype))
                  for buf, b, vs in readers),
        prog=prog, consts=tuple(pf.consts), out_dtype=out_dtype)

    def inputs(arrays):
        return [_as_input(arrays[s.buf], buffers[s.buf]) for s in mplan.ins]

    def fn(arrays: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return EW.elementwise(mplan, inputs(arrays), getattr(fn, "out_clip", out_shape))

    def plain(arrays: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return EW.elementwise_plain(mplan, inputs(arrays), getattr(fn, "out_clip", out_shape))

    fn.out_shape = out_shape
    fn.out_dtype = torch_dtype(out_dtype)
    fn.out_base = base
    fn.in_bufs = [s.buf for s in mplan.ins]
    fn.plan = mplan
    fn.plain = plain
    fn.kernel = "elementwise"
    return fn


def _emit_windowed(plan: WindowedPlan, outer: Block, buffers: Mapping[str, TensorDecl],
                   mp: Optional[memplan.BlockPlan] = None) -> Callable:
    """One halo / conv / masked-remainder unit as one launch of the
    windowed kernel: the grid and tile variables flattened, every input
    coordinate and every constraint an affine function of them."""
    has_red = bool(plan.red_vars)
    if mp is not None and ((mp.acc_bytes > 0) != has_red
                           or set(mp.red_vars) != set(plan.red_vars)):
        raise UnsupportedCuda(
            f"memory plan disagrees with emitter: plan acc={mp.acc_bytes}B "
            f"red={sorted(mp.red_vars)} vs emitter red={sorted(plan.red_vars)}")
    levels, _epi = _levels(outer)
    nest = _Nest(levels)
    tile_li = len(levels) - 1
    out_shape, base, out_of, out_dtype = _output_map(
        nest, tile_li, _leaf_store(levels).buf, plan.out_ref, plan.grid_sizes, buffers)
    red_keys = [k for k in nest.ext if k not in out_of]

    sides = plan.sides if plan.sides is not None else [plan.root]
    names = _load_names(*sides)
    if not names:
        raise UnsupportedCuda("windowed unit with no input")
    inputs: List[Tuple[str, Tuple[int, ...], str, Coords]] = []
    for n in names:
        buf, _local, dims = nest.chain(tile_li, n)
        if buf is None:
            raise UnsupportedCuda(f"{n} reads a block-local buffer")
        decl = buffers.get(buf)
        if decl is None:
            raise UnsupportedCuda(f"{n} reads unknown buffer {buf}")
        if len(decl.shape) != len(dims):
            raise UnsupportedCuda(f"{n} addresses rank {len(dims)} of rank-{len(decl.shape)} {buf}")
        if any(c < 0 for coefs, _k in dims for c in coefs.values()):
            raise UnsupportedCuda(f"{n} walks {buf} backwards")
        inputs.append((buf, tuple(decl.shape), _check_dtype(buf, decl), dims))
    cons: Coords = [nest.resolve(0, c.expr) for c in levels[0].constraints]
    cons += [nest.resolve(li, c.expr) for li in range(1, len(levels))
             for c in levels[li].constraints]

    ext = dict(nest.ext)
    rs = _row_strides(out_shape)
    ostr = {k: c * rs[d] for k, (d, c) in out_of.items()}
    tables = [dict(coefs) for _buf, _shape, _dt, dims in inputs for coefs, _k in dims]
    tables += [dict(coefs) for coefs, _k in cons]
    out_keys = _merge_vars(list(out_of), ext, [ostr] + tables,
                           same=lambda a, b: out_of[a][0] == out_of[b][0])
    red_keys = _merge_vars(red_keys, ext, tables)
    out_order = _launch_order(out_keys, ostr, ext, {})
    it = iter(tables)
    inputs = [(buf, shape, dt, [(next(it), k) for _c, k in dims])
              for buf, shape, dt, dims in inputs]
    cons = [(next(it), k) for _c, k in cons]
    # reduction variable 0, the kernel's inner loop: the largest one that
    # moves no input coordinate that can leave its dimension and no
    # constraint (a conv's channels, not its taps)
    guarded = {k for coefs, _k in cons for k in coefs}
    for _buf, shape, _dt, dims in inputs:
        for (coefs, const), size in zip(dims, shape):
            lo = const + sum(min(0, c * (ext[k] - 1)) for k, c in coefs.items())
            hi = const + sum(max(0, c * (ext[k] - 1)) for k, c in coefs.items())
            if lo < 0 or hi >= size:
                guarded.update(coefs)
    red_order = sorted(red_keys, key=lambda k: (k in guarded, -ext[k]))

    def affine(coefs: Mapping[str, int], const: int) -> WK.Affine:
        return (const, tuple(coefs.get(k, 0) for k in out_order),
                tuple(coefs.get(k, 0) for k in red_order))

    # the plain version enumerates the reference's window variables: the
    # reduction variables of a constraint, and those that share an input
    # dimension with an output variable
    taps = {k for coefs, _k in cons for k in coefs if k in red_order}
    for _buf, _shape, _dt, dims in inputs:
        for coefs, _k in dims:
            if any(k in out_order for k in coefs):
                taps.update(k for k in coefs if k in red_order)
    int_mode = K.acc_dtype(out_dtype) == "int32"
    pf = _Postfix(int_mode=int_mode)
    slot_of = {n: i for i, n in enumerate(names)}
    progs = [tuple(pf.tnode(side, slot_of)) for side in sides]
    wplan = WK.WinPlan(
        out_vars=tuple(out_order), out_ext=tuple(ext[k] for k in out_order),
        out_dim=tuple(out_of[k][0] for k in out_order),
        out_coef=tuple(out_of[k][1] for k in out_order), out_shape=out_shape,
        red_vars=tuple(red_order), red_ext=tuple(ext[k] for k in red_order),
        ins=tuple(WK.WinInput(buf=buf, shape=shape, dtype=dt,
                              dims=tuple(affine(c, k) for c, k in dims))
                  for buf, shape, dt, dims in inputs),
        constraints=tuple(affine(c, k) for c, k in cons),
        lhs=progs[0], rhs=progs[1] if len(progs) == 2 else (), n_sides=len(progs),
        consts=tuple(pf.consts), scale=float(plan.scale),
        taps=tuple(k for k in red_order if k in taps), out_dtype=out_dtype)
    _check_limits([(len(out_order), K.MAXV, "output variables"),
                   (len(red_order), K.MAXV, "reduction variables"),
                   (len(names), WK.MAXS, "inputs"),
                   (wplan.n_tracked(), WK.MAXQ, "tracked offsets, coordinates and constraints"),
                   (max(len(p) for p in progs), K.MAXP, "program length"),
                   (len(pf.consts), K.MAXC, "constants"), (len(out_shape), K.MAXD, "output rank"),
                   (max(K.stack_depth(p) for p in progs), K.MAXSTACK, "stack depth")])

    def arrays_of(arrays):
        return [_as_input(arrays[i.buf], buffers[i.buf]) for i in wplan.ins]

    def fn(arrays: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return WK.windowed(wplan, arrays_of(arrays), getattr(fn, "out_clip", out_shape))

    def plain(arrays: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return WK.windowed_plain(wplan, arrays_of(arrays), getattr(fn, "out_clip", out_shape))

    fn.out_shape = out_shape
    fn.out_dtype = torch_dtype(out_dtype)
    fn.out_base = base
    fn.in_bufs = [i.buf for i in wplan.ins]
    fn.plan = wplan
    fn.plain = plain
    fn.kernel = "windowed"
    return fn


def lower_op_cuda(outer: Block, pipeline_depth: int = 2,
                  buffers: Optional[Mapping[str, TensorDecl]] = None) -> Callable:
    """Returns fn(arrays: dict) -> output region for one optimized op block
    or fusion group (one kernel launch).  ``pipeline_depth`` is the
    hardware's pipeline depth (``HardwareConfig.pipeline_depth``), threaded
    into the memory plan; ``buffers`` (the program's declarations) gives the
    shapes the kernel's strides are computed from.

    Emission paths are tried in the Pallas backend's order — dense
    contraction / elementwise for constraint-free aligned blocks, then the
    windowed path — and when *every* path rejects the block, the raised
    ``UnsupportedCuda`` carries each path's reason."""
    outer = _ensure_grid(outer)
    out_ref = next((r for r in outer.refs if r.dir in (RefDir.OUT, RefDir.INOUT)), None)
    if out_ref is None:
        raise UnsupportedCuda("no output ref")
    if buffers is None:
        raise UnsupportedCuda("the CUDA emitter needs the program's buffer declarations")
    mp = memplan.plan_block(outer, depth=pipeline_depth)
    agg = out_ref.agg or "assign"
    constrained = _is_constrained(outer)

    fn: Optional[Callable] = None
    errors: List[str] = []

    def attempt(name: str, build: Callable[[], Callable]) -> None:
        nonlocal fn
        if fn is not None:
            return
        try:
            fn = build()
        except UnsupportedCuda as e:
            errors.append(f"{name}: {e}")

    contraction = lambda: _emit_contraction(  # noqa: E731
        extract_contraction(outer), outer, buffers, mp=mp)
    elementwise = lambda: _emit_elementwise(  # noqa: E731
        extract_elementwise(outer), outer, buffers)
    if not constrained:
        if agg == "assign" and not outer.sub_blocks():
            attempt("elementwise", elementwise)
        elif agg == "assign":
            # a fused group's outer agg is on its local accumulator; decide
            # by whether a reduction sub-structure exists — both reasons
            # are recorded when neither path fits
            attempt("contraction", contraction)
            attempt("elementwise", elementwise)
        else:
            attempt("contraction", contraction)
    # the general halo/masked path: constraint-carrying blocks (boundary
    # remainders, conv halos) and halo views of constraint-free interiors
    attempt("windowed", lambda: _emit_windowed(extract_windowed(outer), outer, buffers, mp=mp))
    if fn is None and constrained and (agg != "assign" or outer.sub_blocks()):
        # a boundary piece of a ragged output dim that the windowed path
        # refuses (a nested tile) runs the contraction over the rows that
        # exist; a block with any other constraint keeps the windowed
        # path's reason alone, as in the reference
        try:
            fn = _emit_contraction(extract_contraction(outer, allow_base=True), outer, buffers,
                                   mp=mp, ragged=True)
        except UnsupportedCuda:
            pass
    if fn is None:
        raise UnsupportedCuda("; ".join(errors))
    fn.out_buf = out_ref.from_buf
    return fn


# --------------------------------------------------------------------------
# Program composition: per-block hybrid lowering
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _Unit:
    """One lowering unit: the top-level blocks sharing a semantic member
    set (a fusion group, or the boundary pieces of one op — pieces
    partition an iteration space and must lower, or fall back, together)."""

    members: List[str]
    blocks: List[Block]
    first: int
    level: int

    @property
    def name(self) -> str:
        return "+".join(self.members)


def _units_of(prog: Program) -> List[_Unit]:
    from .passes.fuse import members_of

    units: Dict[Tuple[str, ...], _Unit] = {}
    order: List[Tuple[str, ...]] = []
    for i, s in enumerate(prog.entry.stmts):
        if not isinstance(s, Block):
            continue
        key = tuple(members_of(s))
        if key not in units:
            units[key] = _Unit(members=list(key), blocks=[], first=i, level=1 << 30)
            order.append(key)
        u = units[key]
        u.blocks.append(s)
        for t in s.tags:
            if t.startswith("sched:"):
                u.level = min(u.level, int(t.split(":", 1)[1]))
    for u in units.values():
        if u.level == 1 << 30:
            u.level = u.first
    return [units[k] for k in order]


def _clip_extents(fn, decl: TensorDecl, block_name: str) -> Tuple[int, ...]:
    """In-bounds extent of the kernel's output region (an overflow-rounded
    boundary piece writes a view whose tail rows the constraints proved
    dead — the kernel stores nothing beyond the clip)."""
    base = fn.out_base
    if len(base) != len(decl.shape) or len(fn.out_shape) != len(decl.shape):
        raise UnsupportedCuda(
            f"{block_name}: kernel writes rank-{len(fn.out_shape)} region "
            f"into rank-{len(decl.shape)} buffer {decl.name}")
    clip = []
    for b, s, d in zip(base, fn.out_shape, decl.shape):
        if b < 0 or b >= d:
            raise UnsupportedCuda(
                f"{block_name}: output region base {base} outside buffer "
                f"{decl.name}{decl.shape}")
        clip.append(min(s, d - b))
    return tuple(clip)


def _place(env: Dict[str, torch.Tensor], decl: TensorDecl, fn,
           out: torch.Tensor) -> torch.Tensor:
    """Place a kernel's (clipped) output region into its buffer: identity
    when the kernel covers the whole buffer, else a slice assignment into
    the buffer, which is updated in place — a buffer written by regions
    belongs to this run (its first region allocates it as zeros), and the
    composer refuses overlapping regions."""
    base = fn.out_base
    if all(b == 0 for b in base) and tuple(out.shape) == tuple(decl.shape):
        return out
    cur = env.get(decl.name)
    if cur is None:
        cur = torch.zeros(tuple(decl.shape), dtype=torch_dtype(decl.dtype), device=out.device)
    cur[tuple(slice(b, b + c) for b, c in zip(base, out.shape))] = out.to(cur.dtype)
    return cur


def lower_program_hybrid(prog: Program, pipeline_depth: int = 2,
                         profile: bool = False) -> Callable:
    """Lower every op block / fusion group to one CUDA kernel launch and
    compose the units in wavefront order; intermediates between groups
    live in device memory.

    The backend degrades **per unit**: a unit whose blocks cannot lower
    falls back to the torch backend for just those semantic ops
    (``lower_group_torch``), the reason is recorded on the returned
    callable (``block_backends`` / ``block_reasons``), and every other
    unit keeps its kernels.

    ``profile=True`` wall-times every unit per call (synchronizing the
    card after it), keeping the best observation per unit in
    ``run.unit_times``.  ``run.steps`` lists (unit, backend, kernels or
    torch function) in execution order."""
    blocks = [s for s in prog.entry.stmts if isinstance(s, Block)]
    if not blocks:
        raise UnsupportedCuda("no op blocks")
    units = _units_of(prog)
    semantic = prog.source

    steps: List[Tuple[_Unit, str, object]] = []
    backends: Dict[str, str] = {}
    reasons: Dict[str, str] = {}
    written_regions: Dict[str, List[Tuple[Tuple[int, ...], Tuple[int, ...]]]] = {}
    written: set = set()
    n_cuda = 0
    for u in units:
        try:
            kernels = []
            regions = []
            for b in u.blocks:
                fn = lower_op_cuda(b, pipeline_depth=pipeline_depth, buffers=prog.buffers)
                if fn.out_buf not in prog.buffers:
                    raise UnsupportedCuda(
                        f"{b.name}: kernel writes unknown buffer {fn.out_buf}")
                kernels.append(fn)
            # the pieces of one ragged output dim run as one launch
            kernels = _join_pieces(kernels, prog.buffers)
            for fn in kernels:
                decl = prog.buffers[fn.out_buf]
                fn.out_clip = _clip_extents(fn, decl, u.name)
                base = fn.out_base
                for obase, oclip in written_regions.get(fn.out_buf, []) + regions:
                    if all(b0 < o0 + c0 and o0 < b0 + c1 for b0, c1, o0, c0 in
                           zip(base, fn.out_clip, obase, oclip)):
                        # two writers of one region cannot be composed by
                        # placement (and the torch group executor would
                        # clobber, not accumulate) — refuse the program
                        raise _ProgramFallback(
                            f"{u.name}: overlapping writes to {fn.out_buf}")
                regions.append((base, fn.out_clip))
            for fn, region in zip(kernels, regions):
                written_regions.setdefault(fn.out_buf, []).append(region)
                written.add(fn.out_buf)
            steps.append((u, "cuda", kernels))
            backends[u.name] = "cuda"
            n_cuda += len(kernels)
        except _ProgramFallback:
            raise
        except UnsupportedCuda as e:
            if semantic is None:
                raise UnsupportedCuda(
                    f"{u.blocks[0].name}: {e} (and no semantic source for a "
                    f"per-block torch fallback)")
            from .lower_torch import lower_group_torch

            gfn = lower_group_torch(semantic, u.members)
            steps.append((u, "torch", gfn))
            backends[u.name] = "torch"
            reasons[u.name] = str(e)
            for n in u.members:
                for s in semantic.entry.stmts:
                    if isinstance(s, Block) and s.name == n:
                        for r in s.refs:
                            if r.dir in (RefDir.OUT, RefDir.INOUT):
                                if r.from_buf in written:
                                    raise _ProgramFallback(
                                        f"{s.name}: multiple units write "
                                        f"{r.from_buf}")
                                written.add(r.from_buf)
                                # a torch unit writes the whole buffer: any
                                # later writer overlaps by construction
                                d = prog.buffers.get(r.from_buf)
                                if d is not None:
                                    written_regions.setdefault(
                                        r.from_buf, []).append(
                                        ((0,) * len(d.shape), tuple(d.shape)))

    missing = [o for o in prog.outputs if o not in written]
    if missing:
        raise UnsupportedCuda(f"outputs {missing} not produced by any kernel")
    # wavefront composition: units ordered by schedule level (ties by
    # program order) — the order the pipelined cost model prices
    steps.sort(key=lambda s: (s[0].level, s[0].first))
    outs = list(prog.outputs)
    buffers = prog.buffers

    unit_times: Dict[str, float] = {}

    def run(arrays: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        env: Dict[str, torch.Tensor] = {k: torch.as_tensor(v) for k, v in arrays.items()}
        for u, kind, obj in steps:
            if profile:
                t0 = time.perf_counter()
            if kind == "cuda":
                for fn in obj:
                    env[fn.out_buf] = _place(env, buffers[fn.out_buf], fn, fn(env))
                if profile:
                    synchronize([env[fn.out_buf] for fn in obj])
            else:
                updates = obj(env)
                env.update(updates)
                if profile:
                    synchronize(updates.values())
            if profile:
                dt = time.perf_counter() - t0
                prev = unit_times.get(u.name)
                unit_times[u.name] = dt if prev is None or dt < prev else prev
        return {n: env[n] for n in outs}

    run.n_kernels = n_cuda + sum(1 for _, kind, _ in steps if kind == "torch")
    run.n_cuda = n_cuda
    run.block_backends = backends
    run.block_reasons = reasons
    run.unit_times = unit_times
    run.steps = steps
    return run
