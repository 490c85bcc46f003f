"""Microarchitectural stenciling (paper §2.3).

Finds tiled contraction blocks whose inner tile can be reshaped to the
hardware stencil (e.g. the MXU's 128x128x128 systolic matmul) and splits
them again so the innermost block matches the stencil exactly, tagging it
with the compute-unit name for the lowerer.
"""
from __future__ import annotations

from typing import Mapping

from ..hwconfig import HardwareConfig
from ..ir import Block, Program, RefDir
from ..tiling import split_block
from . import register


def _roles(block: Block):
    """Classify free idxs of a flat contraction block into (out_vars,
    reduction_vars) from the OUT refinement's access."""
    out_ref = None
    for r in block.refs:
        if r.dir in (RefDir.OUT, RefDir.INOUT):
            out_ref = r
    if out_ref is None:
        return [], []
    out_vars = []
    for e in out_ref.offsets:
        for n in e.names():
            if n not in out_vars:
                out_vars.append(n)
    free = [i.name for i in block.idxs if not i.is_passthrough()]
    red = [v for v in free if v not in out_vars]
    return [v for v in out_vars if v in free], red


@register("stencil")
def stencil_pass(prog: Program, hw: HardwareConfig, params: Mapping) -> Program:
    sten = None
    for s in hw.stencils:
        if s.name == params.get("stencil", "mxu"):
            sten = s
    if sten is None:
        return prog
    min_dim = params.get("min_dim", 16)

    def visit(blk: Block) -> None:
        for i, s in enumerate(blk.stmts):
            if not isinstance(s, Block):
                continue
            flat = "contraction" in s.tags and not s.sub_blocks() and "stenciled" not in s.tags
            if flat and ("tile" in s.tags or "fits_inner" in s.tags or "grid" not in s.tags):
                out_vars, red = _roles(s)
                if not out_vars or not red:
                    continue
                n_var = out_vars[-1]
                k_var = max(red, key=lambda v: s.idx(v).range)
                m_var = out_vars[-2] if len(out_vars) >= 2 else None
                ranges = {x.name: x.range for x in s.idxs if not x.is_passthrough()}
                tiles = {}
                for var, mult in ((m_var, sten.dims[0]), (n_var, sten.dims[1]), (k_var, sten.dims[2])):
                    if var is None:
                        continue
                    r = ranges[var]
                    if r >= max(mult, min_dim) and r % mult == 0 and r > mult:
                        tiles[var] = mult
                if not tiles:
                    # already stencil-sized (or too small): just tag it
                    if all(ranges.get(v, 0) <= d for v, d in ((m_var, sten.dims[0]), (n_var, sten.dims[1]), (k_var, sten.dims[2])) if v):
                        s.add_tag(sten.name)
                        if not s.constraints:
                            # proof for the lowerer: the stencil fit was
                            # established on an unconstrained tile — no
                            # masking needed to feed the compute unit
                            s.add_tag("dense")
                    continue
                new = split_block(s, tiles, name_suffix="s")
                if "tile" in s.tags:
                    # splitting the inner tile of an existing grid: the new
                    # outer stays a tile of its parent grid
                    new.tags = (new.tags - {"grid"}) | {"tile", "stenciled"}
                else:
                    new.tags = new.tags | {"stenciled"}
                inner = new.stmts[0]
                assert isinstance(inner, Block)
                inner.add_tag(sten.name, "stenciled")
                if not inner.constraints:
                    inner.add_tag("dense")
                blk.stmts[i] = new
            else:
                visit(s)

    visit(prog.entry)
    return prog
