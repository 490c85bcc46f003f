"""Tile-like frontend: mathematical tensor expressions -> Stripe blocks.

PlaidML lowers its Tile language ("Einstein notation with aggregations")
into flat Stripe blocks; optimization passes then restructure them.  This
module provides the same entry point:

    tp = TileProgram("conv")
    tp.input("I", (12, 16, 8), "int8")
    tp.input("F", (3, 3, 8, 16), "int8")
    tp.output("O", (12, 16, 16), "int8")
    tp.op("O[x, y, k] += I[x + i - 1, y + j - 1, c] * F[i, j, c, k]")
    prog = tp.build()

Index ranges are inferred from tensor shapes where an index appears alone
(Tile-style); remaining ranges are given explicitly.  Accesses that can
step out of bounds get boundary ("halo") constraints, exactly as in the
paper's Fig. 5.

Aggregations: ``+=`` (add), ``max=``, ``min=``, ``*=`` (mul) over a product
of tensor accesses; ``=`` defines an elementwise/assign op whose right-hand
side may be any expression DAG of accesses, scalars, and intrinsics.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .affine import Affine, aff
from .ir import (
    Block,
    Constant,
    Constraint,
    Intrinsic,
    Load,
    Program,
    RefDir,
    Refinement,
    Store,
    TensorDecl,
    row_major_strides,
)
from .poly import Index

_AGG_TOKEN = {"+=": "add", "max=": "max", "min=": "min", "*=": "mul", "=": "assign"}

INTRINSICS = {
    "add", "sub", "mul", "div", "neg", "exp", "log", "tanh", "sqrt", "rsqrt",
    "sigmoid", "relu", "abs", "max", "min", "square", "cast", "erf", "gelu",
    "silu", "sign", "floor",
}


# --------------------------------------------------------------------------
# Access parsing
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Access:
    tensor: str
    exprs: Tuple[Affine, ...]


def _parse_affine(node: ast.expr) -> Affine:
    if isinstance(node, ast.Name):
        return Affine.var(node.id)
    if isinstance(node, ast.Constant):
        if not isinstance(node.value, int):
            raise ValueError(f"non-integer constant in index expr: {node.value!r}")
        return aff(node.value)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_parse_affine(node.operand)
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Add):
            return _parse_affine(node.left) + _parse_affine(node.right)
        if isinstance(node.op, ast.Sub):
            return _parse_affine(node.left) - _parse_affine(node.right)
        if isinstance(node.op, ast.Mult):
            l, r = _parse_affine(node.left), _parse_affine(node.right)
            if l.is_const():
                return r * l.const
            if r.is_const():
                return l * r.const
            raise ValueError("non-affine index expression (var*var)")
        if isinstance(node.op, ast.FloorDiv):
            raise ValueError("floor division is not affine in Stripe accesses")
    raise ValueError(f"unsupported index expression: {ast.dump(node)}")


def _parse_access(node: ast.Subscript) -> Access:
    if not isinstance(node.value, ast.Name):
        raise ValueError("access base must be a tensor name")
    sl = node.slice
    elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
    return Access(node.value.id, tuple(_parse_affine(e) for e in elts))


# --------------------------------------------------------------------------
# Expression DAG (for elementwise ops)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ENode:
    kind: str  # 'access' | 'const' | 'op'
    access: Optional[Access] = None
    value: Optional[float] = None
    op: Optional[str] = None
    args: Tuple["ENode", ...] = ()


_BINOP = {ast.Add: "add", ast.Sub: "sub", ast.Mult: "mul", ast.Div: "div", ast.Pow: "pow"}


def _parse_enode(node: ast.expr) -> ENode:
    if isinstance(node, ast.Subscript):
        return ENode("access", access=_parse_access(node))
    if isinstance(node, ast.Constant):
        return ENode("const", value=float(node.value))
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return ENode("op", op="neg", args=(_parse_enode(node.operand),))
    if isinstance(node, ast.BinOp) and type(node.op) in _BINOP:
        return ENode("op", op=_BINOP[type(node.op)], args=(_parse_enode(node.left), _parse_enode(node.right)))
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        fn = node.func.id
        if fn not in INTRINSICS:
            raise ValueError(f"unknown intrinsic '{fn}'")
        return ENode("op", op=fn, args=tuple(_parse_enode(a) for a in node.args))
    raise ValueError(f"unsupported expression: {ast.dump(node)}")


def _flatten_product(n: ENode) -> Optional[List[Access]]:
    """If the DAG is a pure product of accesses, return them; else None."""
    if n.kind == "access":
        return [n.access]
    if n.kind == "op" and n.op == "mul":
        parts = []
        for a in n.args:
            sub = _flatten_product(a)
            if sub is None:
                return None
            parts.extend(sub)
        return parts
    return None


def _walk_accesses(n: ENode):
    if n.kind == "access":
        yield n.access
    for a in n.args:
        yield from _walk_accesses(a)


# --------------------------------------------------------------------------
# Op statement
# --------------------------------------------------------------------------
@dataclasses.dataclass
class OpSpec:
    name: str
    out: Access
    agg: str
    rhs: ENode
    ranges: Dict[str, int]  # resolved index ranges
    constraints: List[Constraint]


def _infer(op_text: str, decls: Mapping[str, TensorDecl], explicit: Mapping[str, int]) -> OpSpec:
    m = re.match(r"^(.*?)\s*(\+=|max=|min=|\*=|=)\s*(.*)$", op_text.strip(), re.S)
    if not m:
        raise ValueError(f"cannot parse op: {op_text!r}")
    lhs_text, agg_tok, rhs_text = m.groups()
    agg = _AGG_TOKEN[agg_tok]
    lhs = ast.parse(lhs_text.strip(), mode="eval").body
    if not isinstance(lhs, ast.Subscript):
        raise ValueError("left-hand side must be a tensor access")
    out = _parse_access(lhs)
    rhs = _parse_enode(ast.parse(rhs_text.strip(), mode="eval").body)

    for a in (out, *(list(_walk_accesses(rhs)))):
        if a.tensor not in decls:
            raise ValueError(f"unknown tensor '{a.tensor}' in {op_text!r}")
        if len(a.exprs) != decls[a.tensor].rank:
            raise ValueError(f"rank mismatch accessing '{a.tensor}'")

    # Output accesses must be plain distinct indices (frontend restriction).
    out_vars: List[str] = []
    for e in out.exprs:
        if len(e.terms) != 1 or e.const != 0 or e.terms[0][1] != 1:
            raise ValueError(f"output access must be a plain index, got {e}")
        out_vars.append(e.terms[0][0])
    if len(set(out_vars)) != len(out_vars):
        raise ValueError("repeated index in output access")

    # ---- range inference: idx alone in a dim => bounded by that dim ------
    ranges: Dict[str, int] = dict(explicit)
    all_accesses = [out] + list(_walk_accesses(rhs))
    for acc in all_accesses:
        shape = decls[acc.tensor].shape
        for e, size in zip(acc.exprs, shape):
            if len(e.terms) == 1:
                (n, c), k = e.terms[0], e.const
                if n in explicit:
                    continue
                if c > 0:
                    bound = (size - 1 - k) // c + 1
                    ranges[n] = min(ranges.get(n, bound), bound)
    missing = set()
    for acc in all_accesses:
        for e in acc.exprs:
            for n in e.names():
                if n not in ranges:
                    missing.add(n)
    if missing:
        raise ValueError(f"cannot infer ranges for {sorted(missing)}; pass ranges=")

    # ---- halo constraints for accesses that can step out of bounds -------
    from .poly import Polyhedron

    poly = Polyhedron([Index(n, r) for n, r in ranges.items()])
    constraints: List[Constraint] = []
    seen = set()
    for acc in all_accesses:
        shape = decls[acc.tensor].shape
        for e, size in zip(acc.exprs, shape):
            if e.is_const():
                if not (0 <= e.const < size):
                    raise ValueError(f"constant access {e} out of bounds for {acc.tensor}")
                continue
            lo, hi = poly.expr_bounds(e)
            if lo < 0 and (key := ("lo", str(e))) not in seen:
                seen.add(key)
                constraints.append(Constraint(e))
            if hi > size - 1 and (key := ("hi", str(e))) not in seen:
                seen.add(key)
                constraints.append(Constraint(aff(size - 1) - e))

    return OpSpec(name="", out=out, agg=agg, rhs=rhs, ranges=ranges, constraints=constraints)


# --------------------------------------------------------------------------
# Lowering an OpSpec to a flat Stripe block (paper Fig. 5a shape)
# --------------------------------------------------------------------------
def lower_op_to_block(spec: OpSpec, decls: Mapping[str, TensorDecl], name: str) -> Block:
    idxs = [Index(n, r) for n, r in sorted(spec.ranges.items())]
    blk = Block(name=name, idxs=idxs, constraints=list(spec.constraints), tags={"contraction" if spec.agg != "assign" else "elementwise", "frontend"})

    # Refinements: one scalar view per distinct access.
    scalars: Dict[int, str] = {}
    load_names: Dict[str, str] = {}  # key: tensor+exprs string -> local name
    counter = [0]

    def add_input(acc: Access) -> str:
        key = acc.tensor + "[" + ",".join(map(str, acc.exprs)) + "]"
        if key in load_names:
            return load_names[key]
        local = acc.tensor if not blk.has_ref(acc.tensor) else f"{acc.tensor}_{counter[0]}"
        counter[0] += 1
        d = decls[acc.tensor]
        blk.refs.append(
            Refinement(
                dir=RefDir.IN, from_buf=acc.tensor, into=local,
                offsets=acc.exprs, shape=(1,) * d.rank, dtype=d.dtype,
                strides=row_major_strides(d.shape),
            )
        )
        sc = f"s{len(load_names)}"
        blk.stmts.append(Load(local, sc))
        load_names[key] = sc
        return sc

    def emit(n: ENode) -> str:
        if n.kind == "access":
            return add_input(n.access)
        if n.kind == "const":
            sc = f"c{counter[0]}"
            counter[0] += 1
            blk.stmts.append(Constant(n.value, sc))
            return sc
        args = tuple(emit(a) for a in n.args)
        sc = f"t{counter[0]}"
        counter[0] += 1
        blk.stmts.append(Intrinsic(n.op, args, sc))
        return sc

    result = emit(spec.rhs)

    od = decls[spec.out.tensor]
    blk.refs.append(
        Refinement(
            dir=RefDir.OUT, from_buf=spec.out.tensor, into=spec.out.tensor + "_out",
            offsets=spec.out.exprs, shape=(1,) * od.rank, dtype=od.dtype,
            strides=row_major_strides(od.shape), agg=spec.agg,
        )
    )
    blk.stmts.append(Store(spec.out.tensor + "_out", result))
    return blk


# --------------------------------------------------------------------------
# TileProgram builder
# --------------------------------------------------------------------------
class TileProgram:
    def __init__(self, name: str = "main"):
        self.name = name
        self.decls: Dict[str, TensorDecl] = {}
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.ops: List[Tuple[str, OpSpec]] = []

    def input(self, name: str, shape: Sequence[int], dtype: str = "float32") -> str:
        self.decls[name] = TensorDecl(name, tuple(shape), dtype)
        self.inputs.append(name)
        return name

    def output(self, name: str, shape: Sequence[int], dtype: str = "float32") -> str:
        self.decls[name] = TensorDecl(name, tuple(shape), dtype)
        self.outputs.append(name)
        return name

    def temp(self, name: str, shape: Sequence[int], dtype: str = "float32") -> str:
        self.decls[name] = TensorDecl(name, tuple(shape), dtype)
        return name

    def op(self, text: str, ranges: Mapping[str, int] | None = None, name: str = "") -> "TileProgram":
        spec = _infer(text, self.decls, ranges or {})
        self.ops.append((name or f"op{len(self.ops)}", spec))
        return self

    def build(self) -> Program:
        entry = Block(name=self.name, tags={"main"})
        for n, d in self.decls.items():
            # temps are INOUT at program scope: real storage shared between
            # the op blocks (iteration-local temporaries use RefDir.NONE)
            dir_ = RefDir.IN if n in self.inputs else (RefDir.OUT if n in self.outputs else RefDir.INOUT)
            entry.refs.append(
                Refinement(
                    dir=dir_,
                    from_buf=n, into=n, offsets=(aff(0),) * d.rank,
                    shape=d.shape, dtype=d.dtype, strides=row_major_strides(d.shape),
                )
            )
        for opname, spec in self.ops:
            entry.stmts.append(lower_op_to_block(spec, self.decls, opname))
        return Program(buffers=dict(self.decls), entry=entry, inputs=list(self.inputs), outputs=list(self.outputs))


def single_op_program(text: str, tensors: Mapping[str, Tuple[Sequence[int], str]], out: str, ranges: Mapping[str, int] | None = None, name: str = "op") -> Program:
    """Convenience: one-op program. ``tensors`` maps name->(shape,dtype)."""
    tp = TileProgram(name)
    for n, (shape, dtype) in tensors.items():
        if n == out:
            tp.output(n, shape, dtype)
        else:
            tp.input(n, shape, dtype)
    tp.op(text, ranges)
    return tp.build()
