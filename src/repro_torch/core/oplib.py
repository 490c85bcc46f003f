"""Op library: the bridge between the NN layers and the Stripe compiler.

Every dense contraction in the models routes through here: the op is
expressed in the Tile frontend, compiled through the hardware-config pass
pipeline (fuse -> autotile -> stencil -> boundary -> localize ->
schedule), and lowered with the selected backend:

* ``torch`` — plain PyTorch (an einsum; the twin of the JAX package's
              ``jnp``), the default;
* ``cuda``  — the compiled program through ``lower_cuda``: one launch of
              a hand-written CUDA kernel per unit for tensors on the card
              (the twin of ``pallas``); on CPU tensors each kernel's plain
              version runs instead (the twin of ``pallas_interpret``).

Backend selection: ``set_backend()`` or the ``REPRO_TORCH_BACKEND``
environment variable.  Compilation results are cached per (op text,
shapes, dtypes, backend), under the JAX package's own ``tpu_v5e`` config,
so the IR, tilings and units are the reference's.
"""
from __future__ import annotations

import functools
import os
from typing import Callable, Dict, Optional

import torch

from .frontend import TileProgram
from .hwconfig import HardwareConfig, get_config
from .ir import Program
from .lower_cuda import UnsupportedCuda, lower_program_hybrid
from .lower_torch import _J_UNARY, lower_program_torch
from .passes import compile_program

BACKENDS = ("torch", "cuda")

_BACKEND = os.environ.get("REPRO_TORCH_BACKEND", "torch")


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in BACKENDS:
        raise ValueError(f"unknown oplib backend {name!r}; expected one of {BACKENDS}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


class CompiledOp:
    """A Stripe-compiled tensor program with torch and cuda lowerings.

    Under ``cuda`` the program lowers per unit (``lower_program_hybrid``):
    a unit no kernel takes runs its torch version, recorded in
    ``block_backends`` / ``block_reasons``, and a program no unit of which
    lowers runs the torch lowering whole (``block_reasons["<program>"]``),
    the reference's legality fallback.  A kernel that cannot be built or
    launched raises: that is never a fallback."""

    def __init__(self, prog: Program, hw: HardwareConfig, backend: str):
        self.optimized = compile_program(prog, hw)
        self.backend = backend
        self.torch_fn = lower_program_torch(self.optimized.source)
        self.cuda_fn: Optional[Callable] = None
        self.block_backends: Dict[str, str] = {}
        self.block_reasons: Dict[str, str] = {}
        if backend == "cuda":
            try:
                # one kernel launch per fusion group, composed in program order
                self.cuda_fn = lower_program_hybrid(
                    self.optimized, pipeline_depth=hw.pipeline_depth)
                self.block_backends = dict(self.cuda_fn.block_backends)
                self.block_reasons = dict(self.cuda_fn.block_reasons)
            except UnsupportedCuda as e:
                self.block_reasons = {"<program>": str(e)}

    def __call__(self, arrays):
        if self.cuda_fn is not None:
            return self.cuda_fn(arrays)
        return self.torch_fn(arrays)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


@functools.lru_cache(maxsize=512)
def _compiled_linear(m: int, k: int, n: int, dtype: str, acc_dtype: str,
                     act: Optional[str], has_bias: bool, backend: str) -> CompiledOp:
    tp = TileProgram("linear")
    tp.input("X", (m, k), dtype)
    tp.input("W", (k, n), dtype)
    if has_bias:
        tp.input("B", (n,), acc_dtype)
    needs_epilogue = has_bias or act
    if needs_epilogue:
        tp.temp("T", (m, n))
        tp.output("O", (m, n), dtype)
        tp.op("T[i, j] += X[i, c] * W[c, j]")
        expr = "T[i, j]"
        if has_bias:
            expr = f"({expr} + B[j])"
        if act:
            expr = f"{act}({expr})"
        tp.op(f"O[i, j] = {expr}")
    else:
        tp.output("O", (m, n), dtype)
        tp.op("O[i, j] += X[i, c] * W[c, j]")
    return CompiledOp(tp.build(), get_config("tpu_v5e"), backend)


def linear(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           act: Optional[str] = None) -> torch.Tensor:
    """Stripe-compiled linear layer: ``act(x @ w + bias)``.

    On the torch backend this is a plain einsum; on the cuda backend it
    runs the Stripe-generated fused kernel (``act`` is the Stripe
    intrinsic: ``gelu`` is the exact erf form, as in the JAX package).
    """
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[-1]
    m = 1
    for s in lead:
        m *= s
    backend = _BACKEND
    if backend == "torch":
        # fast path: identical semantics, no per-shape Program build
        out = torch.einsum("mk,kn->mn", x.reshape(m, k), w)
        if bias is not None:
            out = out + bias
        if act is not None:
            out = _J_UNARY[act](out)
        return out.reshape(*lead, n)
    op = _compiled_linear(m, k, n, _dtype_name(x.dtype),
                          _dtype_name(bias.dtype) if bias is not None else "float32",
                          act, bias is not None, backend)
    arrays = {"X": x.reshape(m, k), "W": w}
    if bias is not None:
        arrays["B"] = bias
    out = op(arrays)["O"]
    return out.reshape(*lead, n)
