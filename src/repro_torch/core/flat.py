"""Frontend-shaped (flat) block analysis, free of any array framework.

``analyze_flat`` rebuilds the expression DAG of a flat op block (one
polyhedron, a scalar-view load/compute/store body) and ``_product_leaves``
recognizes a pure product of loads times a constant.  The fusion and
transpose passes use both to classify blocks, and ``lower_torch`` lowers
from them; keeping them here lets the passes import no tensor library.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .ir import Block, Constant, Intrinsic, Load, Refinement, Store


@dataclasses.dataclass
class _Node:
    kind: str  # 'load' | 'const' | 'op'
    ref: Optional[Refinement] = None
    value: float = 0.0
    op: str = ""
    args: Tuple["_Node", ...] = ()


@dataclasses.dataclass
class FlatOp:
    block: Block
    out_ref: Refinement
    agg: str
    root: _Node
    ranges: Dict[str, int]
    out_vars: List[str]  # one per non-degenerate output dim


def analyze_flat(block: Block) -> FlatOp:
    env: Dict[str, _Node] = {}
    out_ref = None
    root = None
    for s in block.stmts:
        if isinstance(s, Load):
            env[s.into] = _Node("load", ref=block.ref(s.buf))
        elif isinstance(s, Constant):
            env[s.into] = _Node("const", value=s.value)
        elif isinstance(s, Intrinsic):
            env[s.into] = _Node("op", op=s.op, args=tuple(env[a] for a in s.args))
        elif isinstance(s, Store):
            out_ref = block.ref(s.buf)
            root = env[s.scalar]
        elif isinstance(s, Block):
            raise ValueError("analyze_flat: nested block (not frontend-shaped)")
    if out_ref is None or root is None:
        raise ValueError("analyze_flat: no store")
    out_vars = []
    for e in out_ref.offsets:
        if len(e.terms) == 1 and e.const == 0 and e.terms[0][1] == 1:
            out_vars.append(e.terms[0][0])
        elif e.is_const():
            out_vars.append(None)  # degenerate dim, fixed position
        else:
            raise ValueError(f"output access must be plain index, got {e}")
    return FlatOp(
        block=block, out_ref=out_ref, agg=out_ref.agg or "assign", root=root,
        ranges=block.idx_ranges(), out_vars=[v for v in out_vars if v is not None],
    )


def _product_leaves(n: _Node) -> Optional[Tuple[List[_Node], float]]:
    if n.kind == "load":
        return [n], 1.0
    if n.kind == "const":
        return [], n.value
    if n.kind == "op" and n.op == "mul":
        leaves: List[_Node] = []
        scale = 1.0
        for a in n.args:
            sub = _product_leaves(a)
            if sub is None:
                return None
            leaves.extend(sub[0])
            scale *= sub[1]
        return leaves, scale
    return None
