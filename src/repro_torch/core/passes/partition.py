"""Banking & partitioning (paper §2.3).

Splits an outer parallel index across ``n_units`` compute units and tags
the tensors with a bank assignment (``Location.bank`` affine in the
partition index).  At the framework level this pass's decision is
consumed by ``repro_torch.parallel.sharding``: the partitioned index maps to a
mesh axis and GSPMD performs the actual distribution — Stripe decides the
*logical* split; pjit/shard_map execute it.
"""
from __future__ import annotations

from typing import Mapping

from ..affine import Affine
from ..hwconfig import HardwareConfig
from ..ir import Block, Location, Program, RefDir
from ..tiling import split_block
from . import register


def partition_block(block: Block, n_units: int, unit: str = "core") -> Block:
    """Split the largest parallel (output) index across n_units banks."""
    from .stencil import _roles

    out_vars, _red = _roles(block)
    cands = [v for v in out_vars if block.idx(v).range % n_units == 0]
    if not cands:
        return block
    v = max(cands, key=lambda x: block.idx(x).range)
    per = block.idx(v).range // n_units
    outer = split_block(block, {v: per}, name_suffix="p")
    outer.tags = (outer.tags - {"grid"}) | {"partitioned"}
    outer.add_tag(f"partition:{v}:{n_units}")
    for r in outer.refs:
        if any(v in e.names() for e in r.offsets):
            r.location = Location(unit=unit, bank=Affine.var(v))
    return outer


def _annotate_mesh(prog: Program, hw: HardwareConfig, params: Mapping) -> Program:
    """Mesh-annotation mode: the config carries a device mesh
    (``hw.with_mesh``), so run the shard planner and record its split /
    collective decisions into the pass report — ``cost.score_pass_trace``
    scales the per-block roofline by the split factor and charges the
    exposed communication time, which is how an ``explore`` sweep over
    mesh shapes scores points without touching any devices.  The blocks
    are tagged but **not** restructured (the driver's mesh path does the
    actual segment cutting at lowering time); a program the planner
    cannot shard reports the reason and passes through unchanged."""
    n = hw.mesh_devices()
    if n <= 1:
        return prog
    from ..shardplan import UnsupportedMesh, plan_program

    report = params.get("_report")
    try:
        plan = plan_program(prog.source or prog, n, hw, hw.mesh)
    except UnsupportedMesh as e:
        if report is not None:
            report.append({"mesh": list(hw.mesh), "fallback": str(e)})
        return prog
    splits = plan.splits()
    for s in prog.entry.stmts:
        if not isinstance(s, Block):
            continue
        for member in s.name.split("+"):
            base = member.split(".")[0]
            hit = splits.get(member) or splits.get(base) or splits.get(s.name)
            if hit:
                s.add_tag("partitioned")
                s.add_tag(f"partition:{hit}:{n}")
                break
    if report is not None:
        report.extend(plan.report(scale_compute=True))
    return prog


@register("partition")
def partition_pass(prog: Program, hw: HardwareConfig, params: Mapping) -> Program:
    n_units = params.get("n_units", 1)
    if n_units <= 1:
        return _annotate_mesh(prog, hw, params)
    new_stmts = []
    for s in prog.entry.stmts:
        if isinstance(s, Block) and "contraction" in s.tags and "grid" not in s.tags and "partitioned" not in s.tags:
            new_stmts.append(partition_block(s, n_units, params.get("unit", "core")))
        else:
            new_stmts.append(s)
    prog.entry.stmts = new_stmts
    return prog
