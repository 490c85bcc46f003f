"""The fusion-group contraction kernel: its plan, its binding, its launch
counter, and its plain PyTorch version.

``csrc/contraction.cu`` is one fixed CUDA C++ source for ``sm_90a`` that
takes a fusion group as data (a :class:`KernelPlan`): output and reduction
variables with their extents, per-variable element strides and the element
type of every operand, and the prologue / epilogue DAGs as postfix
programs.  It replaces the TPU kernel
``src/repro/core/lower_pallas.py::_emit_contraction``.  The plan is built
from a Stripe fusion group by :mod:`repro_torch.core.lower_cuda`; this
module knows no IR.

Types follow the reference's ``_acc_dtype``: the group accumulates in
int32 when its output is an integer, else in float32; every operand
converts to that type as it is read, and the result is rounded once to the
output's type.

The library is built by :mod:`repro_torch.kernels._build` at first use.
:func:`contraction` launches the kernel for CUDA tensors (raising on any
failure: there is no fallback) and runs :func:`contraction_plain`, the
plain PyTorch version of the same function, only for tensors on the CPU.
``launches`` counts kernel launches.  This module also holds what the three
kernels share on the host side: the op-codes and the postfix evaluator.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import _build
from ._build import KernelBuildError, KernelLaunchError  # noqa: F401 (re-exported)

# ---------------------------------------------------------------- op-codes
# Must match csrc/dag.cuh.
OP_LOAD, OP_CONST, OP_ACC = 0, 1, 2
OP_UNARY, OP_BINARY = 16, 48
UNARY_OPS = ("neg", "exp", "log", "tanh", "sqrt", "rsqrt", "sigmoid", "relu",
             "abs", "square", "erf", "gelu", "silu", "sign", "floor", "cast")
BINARY_OPS = ("add", "sub", "mul", "div", "max", "min", "pow")

# the ops an integer program may use (closed over the integers)
INT_UNARY = ("neg", "relu", "abs", "square", "sign", "floor", "cast")
INT_BINARY = ("add", "sub", "mul", "max", "min")

MAXV, MAXS, MAXE, MAXP, MAXC, MAXD, MAXSTACK = 8, 6, 6, 32, 8, 8, 8

Program = Tuple[Tuple[int, int], ...]  # postfix (op-code, argument) pairs

# Kernel launches since import (or since the caller last reset it).  Only
# the wrapper's launch path adds to it.
launches = 0


@dataclasses.dataclass(frozen=True)
class Slot:
    """One tensor the kernel reads: element offset ``base`` plus, per
    variable, an element stride (0 where the tensor lacks the variable),
    and its element type."""

    buf: str
    base: int
    ostride: Tuple[int, ...]  # per output variable
    rstride: Tuple[int, ...]  # per reduction variable
    dtype: str = "float32"


def acc_dtype(out_dtype: str) -> str:
    """The reference's accumulator type (``_acc_dtype``): int32 for an
    integer output, else float32 (the kernels take no float64)."""
    return "int32" if str(out_dtype).startswith(("int", "uint")) else "float32"


@dataclasses.dataclass
class KernelPlan:
    """A fusion group as the kernel sees it.

    Output variable 0 is walked by the threads of a block; reduction
    variable 0 is the inner loop.  Each output variable addresses one
    output dimension (``out_dim``) with coefficient ``out_coef``; the
    region the group writes has shape ``out_shape``."""

    out_vars: Tuple[str, ...]
    out_ext: Tuple[int, ...]
    out_dim: Tuple[int, ...]
    out_coef: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    red_vars: Tuple[str, ...]
    red_ext: Tuple[int, ...]
    slots: Tuple[Slot, ...]
    eslots: Tuple[Slot, ...]
    lhs: Program
    rhs: Program
    epi: Program
    consts: Tuple[float, ...]
    scale: float
    out_dtype: str = "float32"
    _cparams: Dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def fast(self) -> bool:
        return self.lhs == ((OP_LOAD, 0),) and self.rhs == ((OP_LOAD, 1),)

    @property
    def acc(self) -> str:
        return acc_dtype(self.out_dtype)

    def reduction_points(self) -> int:
        return math.prod(self.red_ext)

    def output_points(self) -> int:
        return math.prod(self.out_ext)


# ------------------------------------------------------- postfix evaluation
def run_postfix(prog: Program, loads: Sequence, acc, consts: Sequence[float], ops) -> object:
    """Evaluate a postfix program.  ``ops`` supplies ``unary(name, x)`` and
    ``binary(name, a, b)`` for the value type at hand (scalars, arrays or
    (tensor, vars) pairs)."""
    st: List = []
    for code, arg in prog:
        if code == OP_LOAD:
            st.append(loads[arg])
        elif code == OP_CONST:
            st.append(ops.const(consts[arg]))
        elif code == OP_ACC:
            st.append(acc)
        elif code < OP_BINARY:
            st.append(ops.unary(UNARY_OPS[code - OP_UNARY], st.pop()))
        else:
            b = st.pop()
            st.append(ops.binary(BINARY_OPS[code - OP_BINARY], st.pop(), b))
    if len(st) != 1:
        raise ValueError(f"malformed postfix program {prog}")
    return st[0]


def stack_depth(prog: Program) -> int:
    depth = best = 0
    for code, _ in prog:
        if code in (OP_LOAD, OP_CONST, OP_ACC):
            depth += 1
        elif code >= OP_BINARY:
            depth -= 1
        best = max(best, depth)
    return best


class _TensorOps:
    """Postfix operations on (tensor, vars) pairs, broadcasting by name;
    constants take the evaluation type ``dtype``."""

    def __init__(self, ext: Dict[str, int], device, dtype=torch.float32):
        self.ext = ext
        self.device = device
        self.dtype = dtype

    def const(self, v):
        if not self.dtype.is_floating_point:
            v = int(v)
        return torch.tensor(v, dtype=self.dtype, device=self.device), ()

    def unary(self, name, x):
        from ..core.lower_torch import _J_UNARY
        return _J_UNARY[name](x[0]), x[1]

    def _align(self, x, union):
        t, vs = x
        if not vs:
            return t
        t = t.permute([vs.index(v) for v in union if v in vs])
        return t.reshape([self.ext[v] if v in vs else 1 for v in union])

    def binary(self, name, a, b):
        from ..core.lower_torch import _J_BINARY
        union = tuple(a[1]) + tuple(v for v in b[1] if v not in a[1])
        return _J_BINARY[name](self._align(a, union), self._align(b, union)), union


def _slot_view(t: torch.Tensor, slot: Slot, names: Sequence[str], exts: Sequence[int]):
    """The elements ``slot`` reads, one axis per variable it depends on;
    returns (view, variable names)."""
    strides = slot.ostride + slot.rstride
    keep = [(n, e, s) for n, e, s in zip(names, exts, strides) if s != 0]
    t = t.contiguous()
    view = torch.as_strided(t, [e for _, e, _ in keep], [s for _, _, s in keep],
                            t.storage_offset() + slot.base)
    return view, tuple(n for n, _, _ in keep)


def _expand_to(x, names: Sequence[str], ext: Dict[str, int], ops: _TensorOps):
    t, vs = x
    t = ops._align((t, vs), tuple(names)) if vs else t.reshape([1] * len(names))
    return t.expand([ext[n] for n in names])


def einsum_acc(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the operands' type, which is the accumulator's.
    CUDA has no integer matrix product: int32 operands go through float64,
    which holds every partial sum of int8 products exactly below 2**53."""
    if a.dtype == torch.int32 and a.is_cuda:
        return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64)).to(torch.int32)
    return torch.einsum(eq, a, b)


def contraction_plain(plan: KernelPlan, slots: Sequence[torch.Tensor],
                      eslots: Sequence[torch.Tensor],
                      clip: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the operands converted to
    the accumulator's type, the prologue DAGs, ``torch.einsum``, the scale
    and the epilogue DAG, rounded to the output's type.  Returns the output
    region cut to ``clip``."""
    from ..core.lower_torch import torch_dtype

    clip = tuple(plan.out_shape if clip is None else clip)
    device = slots[0].device if slots else torch.device("cpu")
    ext = dict(zip(plan.out_vars + plan.red_vars, plan.out_ext + plan.red_ext))
    acc_t = torch_dtype(plan.acc)
    ops = _TensorOps(ext, device, acc_t)
    names, exts = plan.out_vars + plan.red_vars, plan.out_ext + plan.red_ext
    views = [_slot_view(t.to(acc_t), s, names, exts) for t, s in zip(slots, plan.slots)]
    lhs = run_postfix(plan.lhs, views, None, plan.consts, ops)
    rhs = run_postfix(plan.rhs, views, None, plan.consts, ops)
    letters = {v: chr(ord("a") + i) for i, v in enumerate(plan.out_vars + plan.red_vars)}
    present = [v for v in plan.out_vars if v in lhs[1] or v in rhs[1]]
    eq = ("".join(letters[v] for v in lhs[1]) + "," + "".join(letters[v] for v in rhs[1])
          + "->" + "".join(letters[v] for v in present))
    acc = einsum_acc(eq, lhs[0], rhs[0])
    # a reduction variable neither side depends on adds the same product
    # once per point, as the kernel's loop does
    absent = math.prod(e for v, e in zip(plan.red_vars, plan.red_ext)
                       if v not in lhs[1] and v not in rhs[1])
    if absent != 1:
        acc = acc * absent
    if plan.scale != 1.0:
        acc = acc * ops.const(plan.scale)[0]
    val = (acc, tuple(present))
    if plan.epi:
        evs = [_slot_view(t.to(acc_t), s, names, exts) for t, s in zip(eslots, plan.eslots)]
        val = run_postfix(plan.epi, evs, val, plan.consts, ops)
    return place_region(_expand_to(val, plan.out_vars, ext, ops), plan, clip)


def place_region(res: torch.Tensor, plan, clip: Tuple[int, ...]) -> torch.Tensor:
    """Write ``res`` (one axis per output variable of ``plan``) into a zero
    output region of the plan's shape and output type; cut it to ``clip``."""
    from ..core.lower_torch import torch_dtype

    region = torch.zeros(plan.out_shape, dtype=torch_dtype(plan.out_dtype), device=res.device)
    rstr = _row_strides(plan.out_shape)
    torch.as_strided(region, list(plan.out_ext),
                     [c * rstr[d] for d, c in zip(plan.out_dim, plan.out_coef)]).copy_(res)
    if tuple(clip) != tuple(plan.out_shape):
        region = region[tuple(slice(0, c) for c in clip)].contiguous()
    return region


def _row_strides(shape: Sequence[int]) -> List[int]:
    out = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        out[d] = out[d + 1] * shape[d + 1]
    return out


# ---------------------------------------------------------- C binding
class _Prog(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("code", ctypes.c_int * MAXP),
                ("arg", ctypes.c_int * MAXP)]


class _Params(ctypes.Structure):
    _fields_ = [
        ("out", ctypes.c_void_p),
        ("slot", ctypes.c_void_p * MAXS),
        ("eslot", ctypes.c_void_p * MAXE),
        ("slot_base", ctypes.c_longlong * MAXS),
        ("slot_ostride", (ctypes.c_longlong * MAXV) * MAXS),
        ("slot_rstride", (ctypes.c_longlong * MAXV) * MAXS),
        ("eslot_base", ctypes.c_longlong * MAXE),
        ("eslot_ostride", (ctypes.c_longlong * MAXV) * MAXE),
        ("out_ostride", ctypes.c_longlong * MAXV),
        ("scale", ctypes.c_double),
        ("consts", ctypes.c_double * MAXC),
        ("slot_dt", ctypes.c_int * MAXS),
        ("eslot_dt", ctypes.c_int * MAXE),
        ("out_dt", ctypes.c_int),
        ("acc_int", ctypes.c_int),
        ("out_ext", ctypes.c_int * MAXV),
        ("out_dim", ctypes.c_int * MAXV),
        ("out_coef", ctypes.c_int * MAXV),
        ("out_clip", ctypes.c_int * MAXD),
        ("red_ext", ctypes.c_int * MAXV),
        ("out_rank", ctypes.c_int),
        ("n_out", ctypes.c_int),
        ("n_red", ctypes.c_int),
        ("n_slot", ctypes.c_int),
        ("n_eslot", ctypes.c_int),
        ("block_x", ctypes.c_int),
        ("block_k", ctypes.c_int),
        ("fast", ctypes.c_int),
        ("lhs", _Prog),
        ("rhs", _Prog),
        ("epi", _Prog),
    ]


def _bind(lib: ctypes.CDLL) -> None:
    lib.stripe_contraction_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                              ctypes.c_void_p]
    lib.stripe_contraction_launch.restype = ctypes.c_int
    lib.stripe_contraction_layout.argtypes = [ctypes.c_void_p]
    lib.stripe_contraction_layout.restype = None
    _build.check_layout(lib.stripe_contraction_layout,
                        (ctypes.sizeof(_Params), _Params.slot_base.offset,
                         _Params.out_ext.offset, _Params.scale.offset,
                         _Params.lhs.offset, _Params.epi.offset))


def load_library() -> ctypes.CDLL:
    """Build (at first use, with the other kernels) and bind the library;
    raises KernelBuildError."""
    return _build.load("contraction", _bind)


def _fill_prog(dst: _Prog, prog: Program) -> None:
    dst.n = len(prog)
    for i, (c, a) in enumerate(prog):
        dst.code[i] = c
        dst.arg[i] = a


def launch_shape(plan: KernelPlan) -> Tuple[int, int]:
    """(outputs per block, threads splitting each output's reduction): a
    warp covers 32 neighbouring outputs, and the reduction is split until
    about 2**18 threads are in flight (at most 32 ways, at least 32 steps
    of reduction variable 0 per thread, 1024 threads per block)."""
    e0 = plan.out_ext[0] if plan.out_ext else 1
    inner = plan.red_ext[0] if plan.red_ext else 1
    bx = 32
    while bx < min(e0, 256):
        bx *= 2
    tk = 1
    while tk < 32 and plan.output_points() * tk < 2**18 and inner >= 64 * tk:
        tk *= 2
    return min(bx, 1024 // tk), tk


def _params(plan: KernelPlan, clip: Tuple[int, ...]) -> Tuple[_Params, int]:
    """The launch parameters of ``plan`` for one clip, pointers left 0."""
    hit = plan._cparams.get(clip)
    if hit is not None:
        return hit
    p = _Params()
    for s, slot in enumerate(plan.slots):
        p.slot_dt[s] = _build.dtype_code(slot.dtype)
        p.slot_base[s] = slot.base
        for i, v in enumerate(slot.ostride):
            p.slot_ostride[s][i] = v
        for j, v in enumerate(slot.rstride):
            p.slot_rstride[s][j] = v
    for s, slot in enumerate(plan.eslots):
        p.eslot_dt[s] = _build.dtype_code(slot.dtype)
        p.eslot_base[s] = slot.base
        for i, v in enumerate(slot.ostride):
            p.eslot_ostride[s][i] = v
    rstr = _row_strides(clip)
    for i, (e, d, c) in enumerate(zip(plan.out_ext, plan.out_dim, plan.out_coef)):
        p.out_ext[i] = e
        p.out_dim[i] = d
        p.out_coef[i] = c
        p.out_ostride[i] = c * rstr[d]
    for d, c in enumerate(clip):
        p.out_clip[d] = c
    for j, e in enumerate(plan.red_ext):
        p.red_ext[j] = e
    p.out_rank = len(clip)
    p.n_out = len(plan.out_ext)
    p.n_red = len(plan.red_ext)
    p.n_slot = len(plan.slots)
    p.n_eslot = len(plan.eslots)
    p.block_x, p.block_k = launch_shape(plan)
    p.fast = int(plan.fast)
    p.out_dt = _build.dtype_code(plan.out_dtype)
    p.acc_int = int(plan.acc == "int32")
    p.scale = plan.scale
    for i, c in enumerate(plan.consts):
        p.consts[i] = c
    _fill_prog(p.lhs, plan.lhs)
    _fill_prog(p.rhs, plan.rhs)
    _fill_prog(p.epi, plan.epi)
    n_blocks = -(-(plan.out_ext[0] if plan.out_ext else 1) // p.block_x)
    for e in plan.out_ext[1:]:
        n_blocks *= e
    plan._cparams[clip] = (p, n_blocks)
    return p, n_blocks


def contraction(plan: KernelPlan, slots: Sequence[torch.Tensor],
                eslots: Sequence[torch.Tensor],
                clip: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Run one fusion group: the kernel for CUDA tensors, the plain version
    for CPU tensors.  Returns the output region cut to ``clip``."""
    global launches
    clip = tuple(plan.out_shape if clip is None else clip)
    tensors = list(slots) + list(eslots)
    if not tensors or not tensors[0].is_cuda:
        if any(t.is_cuda for t in tensors):
            raise ValueError("contraction: operands on the CPU and on the card")
        for t, s in zip(tensors, plan.slots + plan.eslots):
            _build.check_type(t, f"operand {s.buf}", s.dtype)
        return contraction_plain(plan, slots, eslots, clip)
    from ..core.lower_torch import torch_dtype

    device = tensors[0].device
    slots = [_build.check_cuda(t, f"operand {s.buf}", device, s.dtype)
             for t, s in zip(slots, plan.slots)]
    eslots = [_build.check_cuda(t, f"epilogue input {s.buf}", device, s.dtype)
              for t, s in zip(eslots, plan.eslots)]
    lib = load_library()
    p, n_blocks = _params(plan, clip)
    out = torch.empty(clip, dtype=torch_dtype(plan.out_dtype), device=device)
    p.out = out.data_ptr()
    for s, t in enumerate(slots):
        p.slot[s] = t.data_ptr()
    for s, t in enumerate(eslots):
        p.eslot[s] = t.data_ptr()
    if n_blocks > 0 and out.numel() > 0:
        rc = lib.stripe_contraction_launch(ctypes.addressof(p), n_blocks,
                                           _build.stream_of(device))
        _build.launch_rc(rc, "contraction")
        launches += 1
    return out
