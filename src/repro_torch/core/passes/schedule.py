"""Scheduling (paper §2.3 / §3.2): build the dependency DAG between block
statements from refinement aliasing, order them, mark independent groups
parallel, and run the **liveness-driven memory planner** (core/memplan.py)
over the wavefront-scheduled statement order — per-block VMEM arenas with
interval-graph best-fit slot allocation (streamed views double-buffered to
the hardware's ``pipeline_depth``, grid-invariant views resident in one
slot, revisited outputs one slot plus their f32 partial-sum scratch), plus
a program-level arena packed across wavefront levels.

Every planned block is tagged ``arena:<bytes>`` (the planner's peak) and
``arena_bump:<bytes>`` (the same views under the legacy no-reuse,
blanket-double-buffer model) so reports and benchmarks can show the
before/after; the pass report carries per-block wavefront levels, both
arena figures, and the packed program plan — the inputs of
``cost.score_pass_trace``'s pipelined wavefront latency model.

``params["memplan"] = False`` restores the legacy bump assignment.
"""
from __future__ import annotations

from typing import Iterable, List, Mapping, Set

from .. import memplan
from ..hwconfig import HardwareConfig
from ..ir import Block, Program, RefDir, dtype_bytes
from . import register

ARENA_ALIGN = memplan.ARENA_ALIGN


def arena_bytes(sizes: Iterable[int]) -> int:
    """Total arena bytes a no-reuse bump assigner consumes for views of
    the given byte sizes (each allocation rounded up to ``ARENA_ALIGN``).
    Kept as the legacy pricing primitive (``memplan=False`` paths)."""
    addr = 0
    for size in sizes:
        addr += memplan.align_up(size)
    return addr


def dependency_dag(blocks: List[Block]) -> List[Set[int]]:
    """deps[i] = set of j<i that statement i must wait for (RAW/WAR/WAW)."""
    deps: List[Set[int]] = [set() for _ in blocks]
    for i, b in enumerate(blocks):
        my_r = {r.from_buf for r in b.refs if r.dir in (RefDir.IN, RefDir.INOUT)}
        my_w = {r.from_buf for r in b.refs if r.dir in (RefDir.OUT, RefDir.INOUT)}
        for j in range(i):
            o = blocks[j]
            o_r = {r.from_buf for r in o.refs if r.dir in (RefDir.IN, RefDir.INOUT)}
            o_w = {r.from_buf for r in o.refs if r.dir in (RefDir.OUT, RefDir.INOUT)}
            if (my_r & o_w) or (my_w & o_r) or (my_w & o_w):
                deps[i].add(j)
    return deps


def wavefronts(deps: List[Set[int]]) -> List[int]:
    """Earliest-start level per statement (independent stmts share levels)."""
    level = [0] * len(deps)
    for i in range(len(deps)):
        level[i] = 1 + max((level[j] for j in deps[i]), default=-1)
    return level


def program_arena_peak(prog: Program) -> int:
    """Largest planned arena (bytes) across the program's blocks, read
    back from the ``arena:<bytes>`` tags the pass leaves — the VMEM
    pressure axis of the explore subsystem's Pareto report."""
    peak = 0
    for s in prog.entry.stmts:
        if not isinstance(s, Block):
            continue
        for g in s.walk():
            for t in g.tags:
                if t.startswith("arena:"):
                    peak = max(peak, int(t.split(":", 1)[1]))
    return peak


def _legacy_bump_assign(b: Block, unit: str, report) -> None:
    """The pre-planner behavior: walk grid blocks and bump-assign inner
    view addresses with zero reuse."""
    from ..ir import Location

    for g in b.walk():
        if "grid" not in g.tags:
            continue
        addr = 0
        for inner in g.sub_blocks():
            for r in inner.refs:
                if r.location is not None and r.location.unit == unit and r.location.addr is None:
                    size = dtype_bytes(r.dtype)
                    for s in r.shape:
                        size *= s
                    r.location = Location(unit=r.location.unit, bank=r.location.bank, addr=addr)
                    addr += arena_bytes([size])
        if addr > 0:
            g.add_tag(f"arena:{addr}")
            if report is not None:
                report.append({"block": b.name, "arena_bytes": addr})


@register("schedule")
def schedule_pass(prog: Program, hw: HardwareConfig, params: Mapping) -> Program:
    report = params.get("_report")
    blocks = [s for s in prog.entry.stmts if isinstance(s, Block)]
    deps = dependency_dag(blocks)
    levels = wavefronts(deps)
    for b, lvl in zip(blocks, levels):
        b.add_tag(f"sched:{lvl}")

    unit = params.get("unit", hw.inner_mem().name)
    if not params.get("memplan", True):
        for b in blocks:
            _legacy_bump_assign(b, unit, report)
        return prog

    # liveness-driven memory planning over the wavefront-scheduled order
    plan = memplan.plan_program(list(zip(blocks, levels)), depth=hw.pipeline_depth)
    for b, lvl in zip(blocks, levels):
        bp = plan.block_plans.get(b.name)
        if bp is None:
            continue
        memplan.assign_addresses(b, bp, unit)
        if bp.peak_bytes > 0:
            b.add_tag(f"arena:{bp.peak_bytes}", f"arena_bump:{bp.bump_bytes}")
        if report is not None:
            rec = {"block": b.name, "level": lvl,
                   "arena_bytes": bp.peak_bytes,
                   "arena_bump_bytes": bp.bump_bytes,
                   "acc_bytes": bp.acc_bytes,
                   "depth": bp.depth}
            if bp.halo_bytes:
                # halo-windowed streamed slots: margin bytes the pipeline
                # re-fetches each grid step (slot = tile + this margin)
                rec["halo_bytes"] = bp.halo_bytes
            report.append(rec)
    if report is not None:
        report.append({"program_plan": plan.to_json()})
    return prog
