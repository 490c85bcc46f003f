"""Separating interior and boundary tiles (paper §2.3).

For a tiled ("grid") block whose constraints only bite at the edges of an
outer index (overflow tiles from non-dividing tile sizes, or conv halos),
split that index range into interior/boundary pieces and drop every
constraint that the interior piece provably satisfies — the interior
block becomes constraint-free (dense, vectorizable), and irregularity is
confined to the boundary blocks.
"""
from __future__ import annotations

from typing import List, Mapping

from ..hwconfig import HardwareConfig
from ..ir import Block, Program
from ..tiling import outer_bounds_of, prune_constraints, shift_index
from . import register


def _n_constraints(blk: Block) -> int:
    n = len(blk.constraints)
    for s in blk.stmts:
        if isinstance(s, Block):
            n += _n_constraints(s)
    return n


def split_boundary(outer: Block, mode: str = "remainder", max_splits: int = 2) -> List[Block]:
    """Returns a list of blocks that partition ``outer``'s iteration space.

    ``max_splits`` is a **per-index** budget: each index may cut at most
    that many pieces, and one index's splits never consume another's
    budget (a 2-D conv splits both spatial axes; the old global budget
    left the second axis unsplit and constraint-carrying).

    Pieces are named deterministically by the *segment start* of every
    split index (``<name>.<idx><lo>``), so a piece covering the same
    sub-range always gets the same name regardless of how many sibling
    segments the mode produced — stable keys for the tiling oracle, the
    memory-plan tags, and the pass trace.  Pieces the constraint pruning
    proved constraint-free are tagged ``interior`` (the Pallas emitter
    trusts the proof and lowers them densely, without re-deriving the
    constraints); the rest are tagged ``boundary`` (masked-store path)."""
    pieces = [outer]
    for idx in list(outer.idxs):
        if idx.is_passthrough() or idx.range < 2:
            continue
        v, n = idx.name, idx.range
        cut_points = [n - 1] if mode == "remainder" else sorted({1, n - 1})
        splits_this_idx = 0
        new_pieces: List[Block] = []
        for p in pieces:
            if splits_this_idx >= max_splits or not any(
                i.name == v and i.range == n for i in p.idxs
            ):
                new_pieces.append(p)
                continue
            base = _n_constraints(p)
            # try splitting at the last tile (remainder) and optionally first
            segs = []
            prev = 0
            for c in cut_points:
                if c > prev:
                    segs.append((prev, c))
                prev = c
            segs.append((prev, n))
            cand = []
            for lo, hi in segs:
                piece = shift_index(p, v, hi - lo, lo)
                prune_constraints(piece, outer_bounds_of(piece))
                cand.append(piece)
            if sum(_n_constraints(c) for c in cand) < base * len(cand) and any(
                _n_constraints(c) < base for c in cand
            ):
                for (lo, _hi), c in zip(segs, cand):
                    c.name = f"{p.name}.{v}{lo}"
                    c.add_tag("boundary_split")
                new_pieces.extend(cand)
                splits_this_idx += 1
            else:
                new_pieces.append(p)
        pieces = new_pieces
    for p in pieces:
        if "boundary_split" in p.tags:
            p.add_tag("interior" if _n_constraints(p) == 0 else "boundary")
    return pieces


@register("boundary")
def boundary_pass(prog: Program, hw: HardwareConfig, params: Mapping) -> Program:
    mode = params.get("mode", "remainder")
    new_stmts = []
    for s in prog.entry.stmts:
        if isinstance(s, Block) and "grid" in s.tags and _n_constraints(s) > 0:
            new_stmts.extend(split_boundary(s, mode=mode, max_splits=params.get("max_splits", 2)))
        else:
            new_stmts.append(s)
    prog.entry.stmts = new_stmts
    return prog
