"""Scalarization & memory localization (paper §2.3) + location assignment.

* assigns hardware ``Location``\\ s level-by-level: refinements at program
  scope live in the outermost memory (HBM); views inside a grid block live
  in the inner memory (VMEM); scalar-shaped local accumulators live in
  registers,
* garbage-collects intermediate buffers that fusion scalarized away (no
  remaining readers/writers), removing their outer-memory allocation.
"""
from __future__ import annotations

from typing import Mapping

from ..hwconfig import HardwareConfig
from ..ir import Block, Location, Program, RefDir
from . import register


def _assign(block: Block, hw: HardwareConfig, level: int, inner_name: str) -> None:
    units = [m.name for m in hw.mem_units]
    for r in block.refs:
        if r.location is not None:
            continue
        if r.dir == RefDir.NONE and r.is_scalar_view():
            r.location = Location(unit=units[-1])  # register file
        elif level == 0:
            r.location = Location(unit=units[0])
        else:
            r.location = Location(unit=inner_name)
    for s in block.stmts:
        if isinstance(s, Block):
            nxt = level + (1 if "grid" in block.tags or "tile" in block.tags or level > 0 else 1)
            _assign(s, hw, nxt, inner_name)


@register("localize")
def localize_pass(prog: Program, hw: HardwareConfig, params: Mapping) -> Program:
    inner = params.get("inner", hw.inner_mem().name)
    for s in prog.entry.stmts:
        if isinstance(s, Block):
            _assign(s, hw, 0, inner)
    # GC buffers no block references anymore (scalarized intermediates)
    live = set(prog.inputs) | set(prog.outputs)
    for s in prog.entry.stmts:
        if isinstance(s, Block):
            for r in s.refs:
                if r.dir != RefDir.NONE:
                    live.add(r.from_buf)
    dead = [b for b in prog.buffers if b not in live]
    for b in dead:
        del prog.buffers[b]
        prog.entry.refs = [r for r in prog.entry.refs if r.from_buf != b]
    if dead:
        prog.entry.comments += f" localize: scalarized {dead}"
    return prog
