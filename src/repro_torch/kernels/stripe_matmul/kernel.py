"""Stripe-generated matmul kernel.

Unlike a hand-written kernel, this one is *compiled*: the op is expressed
in the Tile frontend, the ``h100`` pass pipeline (fuse -> autotile ->
boundary -> localize -> schedule) tiles it and fuses the epilogue, and
``lower_op_cuda`` turns the one fused block into a launch of the CUDA
contraction kernel (its plain version for CPU tensors).  This module just
exposes the build entry point.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

from ...core.driver import compile_cached
from ...core.frontend import TileProgram
from ...core.hwconfig import get_config
from ...core.ir import Block
from ...core.lower_cuda import lower_op_cuda
from ...core.passes import compile_program


def _program(m: int, k: int, n: int, act: Optional[str], has_bias: bool) -> TileProgram:
    tp = TileProgram("stripe_matmul")
    tp.input("X", (m, k))
    tp.input("W", (k, n))
    if has_bias:
        tp.input("B", (n,))
    if act or has_bias:
        tp.temp("T", (m, n))
        tp.output("O", (m, n))
        tp.op("T[i, j] += X[i, c] * W[c, j]")
        expr = "T[i, j]"
        if has_bias:
            expr = f"({expr} + B[j])"
        if act:
            expr = f"{act}({expr})"
        tp.op(f"O[i, j] = {expr}")
    else:
        tp.output("O", (m, n))
        tp.op("O[i, j] += X[i, c] * W[c, j]")
    return tp


@functools.lru_cache(maxsize=256)
def build_matmul_kernel(m: int, k: int, n: int, act: Optional[str] = None,
                        has_bias: bool = False) -> Callable:
    """call(x, w, b=None) -> act(x @ w + b), float32, one kernel launch."""
    hw = get_config("h100")
    prog, _record = compile_cached(_program(m, k, n, act, has_bias).build(), hw)
    blocks = [s for s in prog.entry.stmts if isinstance(s, Block)]
    assert len(blocks) == 1, f"expected one fused block, got {len(blocks)}"
    fn = lower_op_cuda(blocks[0], pipeline_depth=hw.pipeline_depth, buffers=prog.buffers)

    def call(x, w, b=None):
        arrays = {"X": x, "W": w}
        if has_bias:
            arrays["B"] = b
        return fn(arrays)

    call.kernel = fn
    return call


def describe_kernel(m: int, k: int, n: int) -> str:
    """Pretty-print the optimized IR (for docs/benchmarks)."""
    return compile_program(_program(m, k, n, None, False).build(), get_config("h100")).pretty()
