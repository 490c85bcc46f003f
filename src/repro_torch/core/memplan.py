"""Liveness-driven inner-memory (VMEM) planning.

The nested polyhedral model makes memory placement a first-class,
optimizable decision (paper §2.3/§3.2): every refinement of a grid block
names a view that must be materialized in the inner memory while the
grid streams over tiles.  This module turns that into an explicit
**memory plan**:

* **View classification** — a grid block's tile views are *streamed*
  (their offsets are addressed by a grid index, so the Pallas pipeline
  re-fetches them as the grid steps; they need ``pipeline_depth`` arena
  slots for fetch/compute overlap), *resident* (grid-invariant views —
  e.g. an untiled weight — fetched once and held in a single slot), or
  the *accumulator* (an output revisited across reduction grid steps:
  one slot, written at flush, plus a float32 scratch tile that carries
  the partial sums between steps — exactly the scratch
  ``lower_pallas`` allocates).
* **Live intervals** — inside a flat (single-tile) block, a view is
  live only over the span of body statements that touch it, in the
  scheduled statement order; across the program, a block's whole arena
  is live only during its wavefront level.  (Inside a *grid* block
  every view persists across grid steps, so intervals there are whole-
  body by construction.)
* **Interval-graph best-fit allocation** — views are placed into one
  arena address space; a dead view's space is reused by the best-fit
  (smallest sufficient) gap, every slot aligned to ``ARENA_ALIGN``.

The plan replaces two blanket approximations:

* the bump allocator in ``passes/schedule.py`` that assigned addresses
  with zero reuse, and
* the ``mem_bytes * 2`` feasibility rule in ``cost.evaluate_tiling``
  that double-buffered *every* view — the planner's exact footprint
  double-buffers only the streamed ones, so the autotiler can legally
  pick tiles up to ~2x larger under the same VMEM capacity.

For before/after reporting, every :class:`BlockPlan` also carries
``bump_bytes``: the legacy model priced on the same view list (no
liveness, no slot classes, everything double-buffered).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

from .ir import Block, Load, RefDir, Refinement, Store, dtype_bytes

ARENA_ALIGN = 512  # bytes; every arena slot starts on this boundary


def align_up(n: int, align: int = ARENA_ALIGN) -> int:
    return (int(n) + align - 1) & ~(align - 1)


# --------------------------------------------------------------------------
# Views and allocations
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ViewSpec:
    """One object the planner must place in the inner-memory arena."""

    name: str
    nbytes: int          # bytes of ONE slot, unaligned
    slots: int = 1       # pipeline slots (streamed views get pipeline_depth)
    start: int = 0       # live interval [start, end], inclusive, in
    end: int = 0         # scheduled-statement-order positions
    kind: str = "resident"  # stream | halo | resident | acc | scratch | local
    halo_bytes: int = 0  # margin bytes of a halo-windowed streamed slot
    #                      (slot = tile core + this overlap, already in
    #                      nbytes — recorded so reports can price the
    #                      overlap the conv windows carry)


@dataclasses.dataclass(frozen=True)
class Allocation:
    view: ViewSpec
    addr: int
    nbytes: int  # total allocated bytes: align_up(view.nbytes) * view.slots


def allocate(views: Sequence[ViewSpec], align: int = ARENA_ALIGN
             ) -> Tuple[List[Allocation], int]:
    """Interval-graph best-fit arena allocation.

    Views are placed in order of live-interval start (larger requests
    first on ties, name as the final deterministic tie-break).  A view
    whose interval has ended releases its space; the allocator fills the
    best-fit (smallest sufficient) gap between still-live allocations
    before growing the arena top.  Two views whose live intervals
    overlap are never given overlapping address ranges (the hypothesis
    property in ``tests/test_memplan.py``).

    Returns ``(allocations, peak_bytes)``.
    """
    live: List[Allocation] = []
    out: List[Allocation] = []
    peak = 0
    order = sorted(views, key=lambda v: (v.start, -(align_up(v.nbytes, align)
                                                    * max(v.slots, 1)), v.name))
    for v in order:
        total = align_up(v.nbytes, align) * max(v.slots, 1)
        live = [a for a in live if a.view.end >= v.start]
        best_addr: Optional[int] = None
        best_gap: Optional[int] = None
        cursor = 0
        for a in sorted(live, key=lambda a: a.addr):
            gap = a.addr - cursor
            if gap >= total and (best_gap is None or gap < best_gap):
                best_addr, best_gap = cursor, gap
            cursor = max(cursor, a.addr + a.nbytes)
        addr = cursor if best_addr is None else best_addr
        alloc = Allocation(view=v, addr=addr, nbytes=total)
        live.append(alloc)
        out.append(alloc)
        peak = max(peak, addr + total)
    return out, peak


def bump_bytes(views: Iterable[ViewSpec], align: int = ARENA_ALIGN) -> int:
    """The legacy arena model on the same view list: no liveness reuse,
    no slot classes — every view blanket-double-buffered (the old
    ``mem_bytes * 2`` rule, expressed in the address assigner's aligned
    arithmetic).  The f32 partial-sum scratch is priced once: it is a
    real buffer both models must hold, and only the planner's *slot*
    policy is under comparison — doubling it would inflate the baseline
    with an allocation the legacy rule never made."""
    return sum((1 if v.kind == "scratch" else 2) * align_up(v.nbytes, align)
               for v in views)


# --------------------------------------------------------------------------
# Block plans
# --------------------------------------------------------------------------
@dataclasses.dataclass
class BlockPlan:
    """The memory plan of one top-level block (grid or single-tile)."""

    block: str
    allocs: List[Allocation]
    peak_bytes: int
    bump_bytes: int
    depth: int
    grid: bool
    red_vars: Tuple[str, ...] = ()      # grid vars that revisit the output
    parallel_vars: Tuple[str, ...] = ()  # grid vars that stream the output
    acc_bytes: int = 0                  # f32 accumulator scratch (0 = none)
    halo_bytes: int = 0                 # total halo margin across slots

    def addr_of(self, name: str) -> Optional[int]:
        for a in self.allocs:
            if a.view.name == name:
                return a.addr
        return None

    def to_json(self) -> Dict:
        return {
            "block": self.block,
            "peak_bytes": self.peak_bytes,
            "bump_bytes": self.bump_bytes,
            "depth": self.depth,
            "acc_bytes": self.acc_bytes,
            "halo_bytes": self.halo_bytes,
            "slots": {a.view.name: {"addr": a.addr, "bytes": a.nbytes,
                                    "kind": a.view.kind, "slots": a.view.slots,
                                    "halo_bytes": a.view.halo_bytes}
                      for a in self.allocs},
        }


def view_span_bytes(ref: Refinement, ranges: Mapping[str, int]) -> int:
    """Bytes of the view ``ref`` spans when its offset variables sweep
    ``ranges`` — the resident footprint of a single-tile block's view."""
    elems = 1
    for e, orig in zip(ref.offsets, ref.shape):
        span = 0
        for n, c in e.terms:
            span += abs(c) * (ranges.get(n, 1) - 1)
        elems *= span + orig
    return elems * dtype_bytes(ref.dtype)


def _touches(stmt, name: str) -> bool:
    if isinstance(stmt, Block):
        if any(r.from_buf == name for r in stmt.refs):
            return True
        return any(_touches(s, name) for s in stmt.stmts)
    if isinstance(stmt, (Load, Store)):
        return stmt.buf == name
    return False


def _body_interval(body: Sequence, name: str) -> Tuple[int, int]:
    """Live interval of ``name`` over the block body's statement order
    (whole body when the name is never found — conservative)."""
    positions = [i for i, s in enumerate(body) if _touches(s, name)]
    if not positions:
        return 0, max(len(body) - 1, 0)
    return positions[0], positions[-1]


def slots_for(is_output: bool, streamed: bool, revisited: bool, depth: int
              ) -> Tuple[str, int]:
    """(kind, slots) of one tile view under the pipeline model."""
    if is_output:
        if revisited:
            return "acc", 1          # written once at flush; scratch carries
        return ("stream", max(depth, 1)) if streamed else ("resident", 1)
    return ("stream", max(depth, 1)) if streamed else ("resident", 1)


def plan_block(block: Block, depth: int = 2) -> BlockPlan:
    """Plan the inner-memory arena of one top-level block.

    For a ``grid``-tagged block the refs' view shapes *are* the tile
    views the pipeline materializes; every view persists across grid
    steps, so intervals are whole-body and the classification (streamed
    / resident / accumulator) does the work.  For a flat (single-tile)
    block, views span the block's own index ranges and are live only
    over the body statements that touch them — the liveness reuse case.
    """
    grid = "grid" in block.tags
    grid_vars: Set[str] = (
        {i.name for i in block.idxs if not i.is_passthrough()} if grid else set())
    ranges = block.idx_ranges()

    out_ref: Optional[Refinement] = None
    for r in block.refs:
        if r.dir in (RefDir.OUT, RefDir.INOUT):
            out_ref = r
    out_vars: Set[str] = set()
    if out_ref is not None:
        for e in out_ref.offsets:
            out_vars.update(n for n in e.names() if n in grid_vars)
    red_vars = tuple(v for v in grid_vars if v not in out_vars)
    parallel_vars = tuple(v for v in grid_vars if v in out_vars)

    body: Sequence = block.stmts
    if grid:
        subs = block.sub_blocks()
        if len(subs) == 1:
            body = subs[0].stmts

    views: List[ViewSpec] = []
    for r in block.refs:
        if r.dir == RefDir.NONE:
            if r.is_scalar_view():
                continue  # per-iteration scalar temporaries live in registers
            nbytes = view_span_bytes(r, ranges)
            s, e = (0, max(len(body) - 1, 0)) if grid else _body_interval(body, r.into)
            views.append(ViewSpec(name=r.into, nbytes=nbytes, slots=1,
                                  start=s, end=e, kind="local"))
            continue
        ref_vars = {n for e in r.offsets for n in e.names()}
        streamed = bool(ref_vars & grid_vars)
        is_out = r.dir in (RefDir.OUT, RefDir.INOUT)
        revisited = is_out and bool(red_vars)
        kind, slots = slots_for(is_out, streamed, revisited, depth)
        nbytes = prod_bytes(r) if grid else view_span_bytes(r, ranges)
        halo = halo_margin_bytes(r, grid_vars) if grid else 0
        if halo > 0 and kind == "stream":
            # a halo-windowed streamed slot: the pipeline fetches the tile
            # core PLUS the overlap margin every grid step (priced in
            # nbytes already — the view shape carries the halo)
            kind = "halo"
        if grid:
            s, e = 0, max(len(body) - 1, 0)
        else:
            s, e = _body_interval(body, r.into)
        views.append(ViewSpec(name=r.into, nbytes=nbytes, slots=slots,
                              start=s, end=e, kind=kind, halo_bytes=halo))

    acc_bytes = 0
    if out_ref is not None and red_vars:
        # the cross-grid-step partial-sum carrier lower_pallas allocates
        elems = 1
        for s in out_ref.shape:
            elems *= s
        acc_bytes = elems * 4  # float32 accumulation
        views.append(ViewSpec(name=f"{out_ref.into}.acc", nbytes=acc_bytes,
                              slots=1, start=0, end=max(len(body) - 1, 0),
                              kind="scratch"))

    allocs, peak = allocate(views)
    return BlockPlan(block=block.name, allocs=allocs, peak_bytes=peak,
                     bump_bytes=bump_bytes(views), depth=depth, grid=grid,
                     red_vars=red_vars, parallel_vars=parallel_vars,
                     acc_bytes=acc_bytes,
                     halo_bytes=sum(v.halo_bytes * max(v.slots, 1) for v in views))


def halo_margin_bytes(ref: Refinement, grid_vars: Set[str]) -> int:
    """Overlap margin of one grid-streamed view: bytes beyond the tile
    *core* (the grid step) that a halo window re-fetches every grid step.
    A dim stepped by a grid var with coefficient < extent (the conv case:
    offset ``8*x - 1`` with extent 10) contributes ``extent - step``
    margin; block-aligned dims contribute none."""
    core = 1
    full = 1
    for e, size in zip(ref.offsets, ref.shape):
        step = sum(abs(c) for n, c in e.terms if n in grid_vars)
        core *= step if 0 < step < size else size
        full *= size
    return (full - core) * dtype_bytes(ref.dtype)


def prod_bytes(ref: Refinement) -> int:
    n = dtype_bytes(ref.dtype)
    for s in ref.shape:
        n *= s
    return n


def assign_addresses(block: Block, plan: BlockPlan, unit: str) -> None:
    """Write the planned slot base addresses into the block's inner
    refinements located in ``unit`` (the views through which the tile is
    addressed), replacing the old no-reuse bump assignment."""
    for b in block.walk():
        if b is block:
            continue
        for i, r in enumerate(b.refs):
            if r.location is None or r.location.unit != unit or r.location.addr is not None:
                continue
            addr = plan.addr_of(r.from_buf)
            if addr is None:
                addr = plan.addr_of(r.into)
            if addr is not None:
                b.refs[i] = _with_addr(r, addr)


def _with_addr(r: Refinement, addr: int) -> Refinement:
    from .ir import Location

    out = r.clone()
    out.location = Location(unit=r.location.unit, bank=r.location.bank, addr=addr)
    return out


# --------------------------------------------------------------------------
# Tile-footprint model (autotile feasibility / fusion pressure)
# --------------------------------------------------------------------------
def tile_footprint_bytes(entries: Iterable[Tuple[int, str, int]],
                         align: int = ARENA_ALIGN) -> int:
    """Exact planned footprint of one tile: ``entries`` are
    ``(nbytes, kind, slots)`` triples as produced by :func:`slots_for`.
    All views of one tile are concurrently live (the pipeline holds
    them across grid steps), so the footprint is the slot sum — the
    reuse the planner buys over the legacy rule is in the *slots*
    (streamed-only double-buffering), not the intervals."""
    return sum(align_up(b, align) * max(s, 1) for b, _k, s in entries)


# --------------------------------------------------------------------------
# Program-level plan (wavefront-scheduled statement order)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ProgramPlan:
    """One arena across the whole program: each top-level block's arena
    is live only during its wavefront level, so sequential blocks reuse
    the same address space while same-level (parallel) blocks coexist."""

    block_plans: Dict[str, BlockPlan]
    block_base: Dict[str, int]     # arena base offset per block
    peak_bytes: int                # liveness-packed program arena
    bump_bytes: int                # no-reuse: sum of per-block bump arenas
    n_levels: int

    def to_json(self) -> Dict:
        return {
            "peak_bytes": self.peak_bytes,
            "bump_bytes": self.bump_bytes,
            "n_levels": self.n_levels,
            "blocks": {n: {"base": self.block_base.get(n, 0),
                           "peak_bytes": p.peak_bytes,
                           "bump_bytes": p.bump_bytes}
                       for n, p in self.block_plans.items()},
        }


def plan_program(blocks_with_levels: Sequence[Tuple[Block, int]],
                 depth: int = 2) -> ProgramPlan:
    """Plan every top-level block and pack the per-block arenas into one
    program arena over the wavefront-scheduled statement order."""
    plans: Dict[str, BlockPlan] = {}
    views: List[ViewSpec] = []
    bump = 0
    levels: Set[int] = set()
    for blk, lvl in blocks_with_levels:
        plan = plan_block(blk, depth=depth)
        plans[blk.name] = plan
        levels.add(lvl)
        bump += plan.bump_bytes
        if plan.peak_bytes > 0:
            views.append(ViewSpec(name=blk.name, nbytes=plan.peak_bytes,
                                  slots=1, start=lvl, end=lvl, kind="block"))
    allocs, peak = allocate(views)
    base = {a.view.name: a.addr for a in allocs}
    return ProgramPlan(block_plans=plans, block_base=base, peak_bytes=peak,
                       bump_bytes=bump, n_levels=len(levels))
