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
import threading
from typing import Callable, Dict, Optional

import torch

from .frontend import TileProgram
from .hwconfig import HardwareConfig, get_config
from .ir import Program
from .lower_cuda import UnsupportedCuda, lower_program_hybrid
from .lower_torch import _J_UNARY, lower_program_torch
from .passes import compile_program
from ..kernels import _build
from ..kernels import contraction as _contraction
from ..kernels import elementwise as _elementwise
from ..kernels import windowed as _windowed
from ..parallel import spmd

BACKENDS = ("torch", "cuda")

_BACKEND = os.environ.get("REPRO_TORCH_BACKEND", "torch")


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in BACKENDS:
        raise ValueError(f"unknown oplib backend {name!r}; expected one of {BACKENDS}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


# The ranks of a sharded call (``parallel/sharded.py``: one host thread a
# rank) share the compiled ops, whose kernel launches fill launch records
# kept on their plans, and the kernels' launch counters: one rank at a
# time compiles or runs an op on the host (its launches are asynchronous,
# so the card still overlaps them).
_LOCK = threading.Lock()
# the unit kernels' launches by rank of a shard_map call, by kernel and
# path ("contraction/skinny", "elementwise", ...), and the units the
# per-unit legality check sent to torch ("torch_units"), since the caller
# last cleared it; ``rank_fallbacks`` holds each such unit's reason
launches_by_rank: Dict[int, Dict[str, int]] = {}
rank_fallbacks: Dict[str, str] = {}


def _launch_counts() -> Dict[str, int]:
    out = {f"contraction/{p}": n for p, n in _contraction.launches_by_path.items()}
    out["elementwise"] = _elementwise.launches
    out["windowed"] = _windowed.launches
    return out


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
    intrinsic: ``gelu`` is the exact erf form, as in the JAX package),
    which has no backward: under autograd, with an input that requires
    grad, it raises ``KernelAutogradError`` (ROADMAP C11).
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
    _build.refuse_autograd("oplib.linear on the cuda backend", x, w, bias)
    arrays = {"X": x.reshape(m, k), "W": w}
    if bias is not None:
        arrays["B"] = bias
    rank = spmd.current_rank()
    with _LOCK:
        op = _compiled_linear(m, k, n, _dtype_name(x.dtype),
                              _dtype_name(bias.dtype) if bias is not None else "float32",
                              act, bias is not None, backend)
        before = _launch_counts() if rank is not None else None
        out = op(arrays)["O"]
        if rank is not None:
            mine = launches_by_rank.setdefault(rank, {})
            for key, count in _launch_counts().items():
                if count != before[key]:
                    mine[key] = mine.get(key, 0) + count - before[key]
            off = ({u: op.block_reasons.get(u, "") for u, b in op.block_backends.items()
                    if b != "cuda"} if op.cuda_fn is not None else dict(op.block_reasons))
            if off:
                mine["torch_units"] = mine.get("torch_units", 0) + len(off)
                for unit, why in off.items():
                    rank_fallbacks[f"linear {m}x{k}x{n} act={act} {unit}"] = why
    return out.reshape(*lead, n)
