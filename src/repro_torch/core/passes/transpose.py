"""Microarchitectural transposition (paper §2.3).

Contractions bound for the MXU want each operand's contiguous (stride-1)
dimension to carry either the reduction index or the output's contiguous
index.  Operands violating this (e.g. ``A[c, i]`` in ``O[i,j] += A[c,i] *
B[c,j]`` read column-major) are relaid: the pass inserts an explicit
transpose-copy op producing a permuted temporary and rewrites the
contraction to read it.
"""
from __future__ import annotations

from typing import Mapping

from ..affine import Affine
from ..hwconfig import HardwareConfig
from ..ir import Block, Load, Program, RefDir, Refinement, Store, TensorDecl, row_major_strides
from ..flat import analyze_flat, _product_leaves
from . import register


def _single_var(e) -> str | None:
    if len(e.terms) == 1 and e.const == 0 and e.terms[0][1] == 1:
        return e.terms[0][0]
    return None


@register("transpose")
def transpose_pass(prog: Program, hw: HardwareConfig, params: Mapping) -> Program:
    new_stmts = []
    n_tr = 0
    for s in prog.entry.stmts:
        if not (isinstance(s, Block) and "contraction" in s.tags and "grid" not in s.tags):
            new_stmts.append(s)
            continue
        try:
            op = analyze_flat(s)
            prod = _product_leaves(op.root)
        except ValueError:
            new_stmts.append(s)
            continue
        if prod is None or not op.out_vars:
            new_stmts.append(s)
            continue
        leaves, _ = prod
        n_var = op.out_vars[-1]
        red_vars = {v for v in op.ranges if v not in op.out_vars}
        for leaf in leaves:
            ref = leaf.ref
            if ref.rank != 2 or ref.dir != RefDir.IN:
                continue
            last = _single_var(ref.offsets[-1])
            first = _single_var(ref.offsets[0])
            if last is None or first is None:
                continue
            # bad layout: contiguous dim carries a non-contiguous output var
            if last not in red_vars and last != n_var and (first in red_vars or first == n_var):
                src = ref.from_buf
                decl = prog.buffers[src]
                t_name = f"{src}_T{n_tr}"
                n_tr += 1
                tshape = (decl.shape[1], decl.shape[0])
                prog.buffers[t_name] = TensorDecl(t_name, tshape, decl.dtype)
                prog.entry.refs.append(
                    Refinement(dir=RefDir.INOUT, from_buf=t_name, into=t_name,
                               offsets=(Affine.var("a") * 0, Affine.var("a") * 0),
                               shape=tshape, dtype=decl.dtype,
                               strides=row_major_strides(tshape)))
                # transpose copy block: T[a,b] = S[b,a]
                tb = Block(name=f"transpose_{src}", tags={"elementwise", "transpose"})
                from ..poly import Index

                tb.idxs = [Index("a", tshape[0]), Index("b", tshape[1])]
                tb.refs = [
                    Refinement(dir=RefDir.IN, from_buf=src, into="S",
                               offsets=(Affine.var("b"), Affine.var("a")),
                               shape=(1, 1), dtype=decl.dtype,
                               strides=row_major_strides(decl.shape)),
                    Refinement(dir=RefDir.OUT, from_buf=t_name, into="T",
                               offsets=(Affine.var("a"), Affine.var("b")),
                               shape=(1, 1), dtype=decl.dtype, agg="assign",
                               strides=row_major_strides(tshape)),
                ]
                tb.stmts = [Load("S", "v"), Store("T", "v")]
                new_stmts.append(tb)
                # rewrite the contraction operand
                ref.from_buf = t_name
                ref.offsets = (ref.offsets[1], ref.offsets[0])
                ref.strides = row_major_strides(tshape)
                s.add_tag("transposed_operand")
        new_stmts.append(s)
    prog.entry.stmts = new_stmts
    return prog
