"""Block splitting — the rewrite at the heart of §3.3.

``split_block`` turns a flat parallel polyhedral block into an outer
"grid" block iterating over tiles and an inner block iterating within a
tile, exactly as in the paper's Fig. 5:

* index ``v`` (range R, tile T) becomes outer ``v``: ``ceil(R/T)`` and
  inner ``v_i``: ``T``;
* accesses are rewritten via the substitution ``v -> T*v + v_i``; each
  refinement splits into an outer view (offset = the outer-index part +
  the minimum inner contribution; shape = inner span + 1 — which is how
  the conv halo manifests as view size 5 with stride-3 steps in Fig. 5b)
  and an inner view relative to it;
* when T does not divide R the outer range is rounded up and an overflow
  constraint ``R-1 - (T*v + v_i) >= 0`` is added to the inner block,
  referencing the explicitly-passed parent index ``v``;
* pre-existing constraints are substituted and pulled into the inner
  block (paper: "the existing constraints can be pulled into the inner
  block").
"""
from __future__ import annotations

import copy
from typing import Dict, List, Mapping, Tuple

from .affine import Affine, aff
from .ir import Block, Refinement
from .poly import Constraint, Index, ceil_div


def _inner_min_span(expr: Affine, inner_ranges: Mapping[str, int]) -> Tuple[int, int]:
    """(min contribution, span) of the inner-variable part of ``expr``."""
    mn = 0
    span = 0
    for n, c in expr.terms:
        if n in inner_ranges:
            r = inner_ranges[n]
            mn += min(0, c * (r - 1))
            span += abs(c) * (r - 1)
    return mn, span


def split_block(block: Block, tiles: Mapping[str, int], name_suffix: str = "t",
                full_tiles: bool = False) -> Block:
    """Split ``block`` by per-index tile sizes.  Indices absent from
    ``tiles`` (or with tile >= range) stay fully inner.  Returns the new
    outer block containing the inner block.

    With ``full_tiles=True`` an index whose tile equals its range still
    becomes a (range-1) grid dimension instead of staying inner — the
    canonical grid shape the Pallas backend expects even when the whole
    op fits one tile."""
    free = {i.name: i.range for i in block.idxs if not i.is_passthrough()}
    limit = (lambda t, r: t <= r) if full_tiles else (lambda t, r: t < r)
    tiled = {v: t for v, t in tiles.items() if v in free and limit(t, free[v])}

    # substitution on original index names
    subst = {v: Affine.var(v, t) + Affine.var(f"{v}_{name_suffix}") for v, t in tiled.items()}
    inner_ranges = {f"{v}_{name_suffix}": t for v, t in tiled.items()}
    inner_ranges.update({u: r for u, r in free.items() if u not in tiled})

    outer = Block(
        name=f"{block.name}.grid",
        idxs=[Index(v, ceil_div(free[v], t)) for v, t in tiled.items()],
        tags=set(block.tags) | {"grid"},
        passed=list(block.passed),
    )
    inner = Block(
        name=f"{block.name}.tile",
        idxs=(
            [Index(f"{v}_{name_suffix}", t) for v, t in tiled.items()]
            + [Index(u, r) for u, r in free.items() if u not in tiled]
            + [i for i in block.idxs if i.is_passthrough()]
        ),
        tags=(set(block.tags) - {"grid"}) | {"tile"},
        passed=list(block.passed) + sorted(tiled),
    )

    # ---- refinements ------------------------------------------------------
    for r in block.refs:
        if r.dir == "none":
            # iteration-local temporaries move inward with the iteration
            # (Def. 2: temporaries are not shared between iterations).
            inner.refs.append(r.clone())
            continue
        out_offs: List[Affine] = []
        in_offs: List[Affine] = []
        shape: List[int] = []
        for e, orig_extent in zip(r.offsets, r.shape):
            es = e.substitute(subst)
            mn, span = _inner_min_span(es, inner_ranges)
            outer_part = Affine.make(
                {n: c for n, c in es.terms if n not in inner_ranges}, es.const + mn
            )
            inner_part = es - outer_part  # inner terms minus mn
            out_offs.append(outer_part)
            in_offs.append(inner_part)
            shape.append(span + orig_extent)  # orig_extent is 1 for scalar views
        outer.refs.append(r.clone(offsets=tuple(out_offs), shape=tuple(shape)))
        inner.refs.append(r.clone(offsets=tuple(in_offs), from_buf=r.into))

    # ---- constraints ------------------------------------------------------
    for c in block.constraints:
        inner.constraints.append(Constraint(c.expr.substitute(subst)))
    for v, t in tiled.items():
        if free[v] % t != 0:
            # overflow removal: R-1 - (T*v + v_i) >= 0
            expr = aff(free[v] - 1) - (Affine.var(v, t) + Affine.var(f"{v}_{name_suffix}"))
            inner.constraints.append(Constraint(expr))

    new_names = [f"{v}_{name_suffix}" for v in tiled] + list(tiled)
    inner.stmts = []
    for s in block.stmts:
        if isinstance(s, Block):
            sub = substitute_block(s, subst)
            sub.passed = list(dict.fromkeys(sub.passed + new_names))
            inner.stmts.append(sub)
        else:
            inner.stmts.append(copy.deepcopy(s))
    outer.stmts = [inner]
    return outer


def substitute_block(block: Block, subst: Mapping[str, Affine]) -> Block:
    """Deep substitution of (parent) index names through a block tree.
    Local indices shadow: a name redefined by this block is not replaced
    inside it."""
    local = {i.name for i in block.idxs if not i.is_passthrough()}
    live = {k: v for k, v in subst.items() if k not in local}
    if not live:
        return block
    out = Block(
        name=block.name,
        idxs=[
            i if i.affine is None else Index(i.name, i.range, i.affine.substitute(live))
            for i in block.idxs
        ],
        constraints=[Constraint(c.expr.substitute(live)) for c in block.constraints],
        refs=[r.clone(offsets=tuple(o.substitute(live) for o in r.offsets)) for r in block.refs],
        tags=set(block.tags),
        passed=list(block.passed),
        comments=block.comments,
    )
    out.stmts = [
        substitute_block(s, live) if isinstance(s, Block) else copy.deepcopy(s)
        for s in block.stmts
    ]
    return out


def shift_index(block: Block, idx_name: str, new_range: int, shift: int) -> Block:
    """Clone ``block`` with index ``idx_name`` restricted to
    ``[shift, shift+new_range)`` (re-based at 0).  Inner content referencing
    the index (through ``passed``) is substituted ``v -> v + shift``."""
    nb = block.clone()
    nb.idxs = [Index(i.name, new_range, i.affine) if i.name == idx_name else i for i in nb.idxs]
    if shift:
        subst = {idx_name: Affine.var(idx_name) + shift}
        # own refs/constraints reference the shifted var directly
        nb.refs = [r.clone(offsets=tuple(o.substitute(subst) for o in r.offsets)) for r in nb.refs]
        nb.constraints = [Constraint(c.expr.substitute(subst)) for c in nb.constraints]
        nb.stmts = [
            substitute_block(s, subst) if isinstance(s, Block) else copy.deepcopy(s)
            for s in nb.stmts
        ]
    return nb


def outer_bounds_of(block: Block, parent: Mapping[str, Tuple[int, int]] | None = None) -> Dict[str, Tuple[int, int]]:
    b = dict(parent or {})
    for i in block.idxs:
        if not i.is_passthrough():
            b[i.name] = (0, i.range - 1)
    return b


def prune_constraints(block: Block, bounds: Mapping[str, Tuple[int, int]]) -> None:
    """Drop constraints provably satisfied over ``bounds`` (recursively)."""
    from .poly import Polyhedron

    poly = Polyhedron(block.idxs, block.constraints)
    keep = []
    for c in block.constraints:
        lo, _ = poly.expr_bounds(c.expr, bounds)
        if lo < 0:
            keep.append(c)
    block.constraints = keep
    inner_bounds = outer_bounds_of(block, bounds)
    for s in block.stmts:
        if isinstance(s, Block):
            prune_constraints(s, inner_bounds)
