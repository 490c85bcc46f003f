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

:func:`gemm_view` reads a plan whose two sides are plain loads as one
batched GEMM (batch, M, N, K variables, each operand's strides, how its
tiles reach shared memory, the tile, the split of K) and picks the
kernel's path: ``skinny`` (M <= 16), ``tiled`` (float32 register tiles on
the CUDA cores, or ``wgmma`` for bf16 / f16 / int8), or, for a plan the
view refuses (:func:`refusal` says why), the ``general`` loop.

The library is built by :mod:`repro_torch.kernels._build` at first use.
:func:`contraction` launches the kernel for CUDA tensors (raising on any
failure: there is no fallback) and runs :func:`contraction_plain`, the
plain PyTorch version of the same function, only for tensors on the CPU.
``launches`` counts kernel launches, ``launches_by_path`` the same
launches by path.  This module also holds what the three kernels share on
the host side: the op-codes and the postfix evaluator.
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


# ------------------------------------------------------------ the GEMM view
# The paths of csrc/contraction.cu (Params.path): the general loop, and
# the three regimes of a plan the GEMM view accepts.
PATH_GENERAL, PATH_SKINNY, PATH_FFMA, PATH_WGMMA = 0, 1, 2, 3
PATHS = ("skinny", "tiled", "general")

# Launches by path since import (or since the caller last reset them);
# they add up to ``launches``.
launches_by_path = {p: 0 for p in PATHS}

SKINNY_ROWS = 16       # the skinny path takes M <= 16 rows
SKINNY_MT = (4, 16)    # its row tiles (one instantiation each)
SKINNY_X = 8192        # lhs elements a skinny CTA keeps in shared memory (32 KB)
SM_COUNT = 132         # streaming multiprocessors of the H100 SXM
_SIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1, "int32": 4}
_HALF = ("bfloat16", "float16")


@dataclasses.dataclass(frozen=True)
class Operand:
    """One side of the GEMM view: ``a`` (the M side) or ``b`` (the N side).
    Element (batch..., r, k) lies at ``base + sum(batch[i] * idx[i]) +
    r * s_mn + k * s_k`` of plan slot ``slot``."""

    slot: int
    dtype: str
    base: int
    batch: Tuple[int, ...]
    s_mn: int
    s_k: int
    unit: Optional[str]  # "k" or "mn": the dim of stride 1; None for neither
    aligned16: bool      # base, batch strides and the other dim's stride in 16-byte steps
    load: str            # how its tiles reach shared memory: "ld" (loads), "cp.async16",
                         # "cp.async4", "tma" (K-major, in place), "tma-mn" (a 16-bit
                         # B, N-major, in place) or "pack+tma" (copied K-major first)


@dataclasses.dataclass(frozen=True)
class GemmView:
    """A plan as one (batched) product C[b, m, n] = sum_k A[b, m, k] B[b, k, n].

    ``m``/``n`` index ``plan.out_vars`` and ``k`` ``plan.red_vars`` (None
    where the plan lacks the dim: extent 1); ``batch`` indexes the output
    variables both operands read.  ``swapped``: the plan's rhs is the M
    side (the product commutes, bit for bit)."""

    path: str    # "skinny" or "tiled"
    mma: str     # "fma" (skinny), "ffma" (tiled, float32 register tiles), "wgmma"
    a: Operand
    b: Operand
    batch: Tuple[int, ...]
    batch_ext: Tuple[int, ...]
    m: Optional[int]
    n: Optional[int]
    k: Optional[int]
    M: int
    N: int
    K: int
    swapped: bool
    tile: Tuple[int, int, int]  # (BM, BN, BK); skinny: BM is the row tile
    stages: int
    splits: int                 # K split over CTAs; partials meet in a second pass
    k_split: int                # K per split, a multiple of BK
    kv: bool                    # skinny: B has unit stride along K
    deferred: bool              # tiled, one split, an epilogue program: the sums go
                                # to scratch and the finishing pass applies it

    @property
    def nbatch(self) -> int:
        return math.prod(self.batch_ext)

    def blocks(self) -> int:
        bm, bn, _ = self.tile
        m_tiles = 1 if self.path == "skinny" else -(-self.M // bm)
        return m_tiles * -(-self.N // bn) * self.splits * self.nbatch

    def work(self) -> Tuple[int, int, int, int]:
        """(bytes, partials offset, packed A offset, packed B offset) of the
        scratch the launch needs; an offset is -1 where it needs none."""
        off, total = [-1, -1, -1], 0
        if self.splits > 1 or self.deferred:
            off[0], total = 0, self.splits * self.nbatch * self.M * self.N * 4
        for j, (op, rows) in enumerate(((self.a, self.M), (self.b, self.N))):
            if op.load == "pack+tma":
                total = -(-total // 256) * 256
                off[1 + j] = total
                total += self.nbatch * rows * self.k_packed(op) * _SIZE[op.dtype]
        return (total, *off)

    def k_packed(self, op: Operand) -> int:
        """Row length of a packed operand: K rounded up to whole 128-byte rows."""
        per = 128 // _SIZE[op.dtype]
        return -(-self.K // per) * per


def _splits(K: int, tiles: int, bk: int, slots: int, kmin: int,
            kmax: Optional[int], part_cost: float) -> Tuple[int, int]:
    """(splits, K per split) for ``tiles`` output tiles on a card that runs
    ``slots`` CTAs at once: the split that takes the fewest waves per unit
    of work (a last wave that is mostly empty costs a whole one), each
    split ``part_cost`` dearer for writing and adding its partials, at
    least ``kmin`` of K per split and at most ``kmax``."""
    lo = -(-K // kmax) if kmax else 1
    best = (math.inf, lo)
    for s in range(lo, max(lo, K // kmin) + 1):
        cost = -(-tiles * s // slots) / s * (1 + part_cost * s)
        if cost < best[0]:
            best = (cost, s)
    ks = -(-(-(-K // best[1])) // bk) * bk
    return -(-K // ks), ks


def _classify(plan: KernelPlan, aligned: Tuple[bool, bool] = (True, True)):
    """(GemmView, None) or (None, the reason the general loop runs)."""
    key = ("view", aligned)
    hit = plan._cparams.get(key)
    if hit is not None:
        return hit
    res = _classify_uncached(plan, aligned)
    plan._cparams[key] = res
    return res


def _classify_uncached(plan: KernelPlan, aligned: Tuple[bool, bool]):
    if not plan.fast:
        return None, "a side is not a plain load (prologue program)"
    s0, s1 = plan.slots[0], plan.slots[1]
    batch, ms, ns, ks = [], [], [], []
    for i, (v, e) in enumerate(zip(plan.out_vars, plan.out_ext)):
        a, b = s0.ostride[i] != 0, s1.ostride[i] != 0
        if e == 1:
            continue
        if a and b:
            batch.append(i)
        elif a or b:
            (ms if a else ns).append(i)
        else:
            return None, f"output variable {v} is read by neither operand"
    for j, (v, e) in enumerate(zip(plan.red_vars, plan.red_ext)):
        a, b = s0.rstride[j] != 0, s1.rstride[j] != 0
        if e == 1:
            continue
        if not (a and b):
            return None, f"reduction variable {v} is read by {int(a) + int(b)} operand(s), not both"
        ks.append(j)
    if len(ms) > 1 or len(ns) > 1 or len(ks) > 1:
        return None, (f"{len(ms)} M, {len(ns)} N and {len(ks)} K variables after merging "
                      "(the view takes at most one of each)")
    m, n, k = (ms or [None])[0], (ns or [None])[0], (ks or [None])[0]
    if m is not None and n is not None and plan.out_dim[m] == plan.out_dim[n]:
        return None, "M and N address the same output dim"
    M = plan.out_ext[m] if m is not None else 1
    N = plan.out_ext[n] if n is not None else 1
    K = plan.red_ext[k] if k is not None else 1
    swapped = M > SKINNY_ROWS >= N
    sa, sb = (1, 0) if swapped else (0, 1)
    if swapped:
        m, n, M, N = n, m, N, M
    path = "skinny" if M <= SKINNY_ROWS else "tiled"
    ta, tb = plan.slots[sa].dtype, plan.slots[sb].dtype
    acc_int = plan.acc == "int32"
    if path == "skinny":
        ok = (ta == tb == "int8") if acc_int else (ta == tb and ta in ("float32",) + _HALF)
        mma = "fma" if ok else None
    elif ta == tb and ((ta in _HALF and not acc_int) or (ta == "int8" and acc_int)):
        mma = "wgmma"
    elif not acc_int and ta == "float32" and tb in ("float32", "bfloat16"):
        mma = "ffma"
    else:
        mma = None
    if mma is None:
        return None, f"the {path} path takes no {ta} x {tb} -> {plan.acc} product"

    def operand(si: int, r: Optional[int], rows: int, ptr_ok: bool, load) -> Operand:
        sl = plan.slots[si]
        size = _SIZE[sl.dtype]
        s_mn = sl.ostride[r] if r is not None else 0
        s_k = sl.rstride[k] if k is not None else 0
        bstr = tuple(sl.ostride[i] for i in batch)
        unit = "k" if s_k == 1 and K > 1 else "mn" if s_mn == 1 and rows > 1 else None
        other = (s_mn, rows) if unit == "k" else (s_k, K)
        al = (ptr_ok and unit is not None and (sl.base * size) % 16 == 0
              and all((x * size) % 16 == 0 for x in bstr)
              and (other[1] == 1 or (other[0] * size) % 16 == 0))
        return Operand(slot=si, dtype=sl.dtype, base=sl.base, batch=bstr, s_mn=s_mn, s_k=s_k,
                       unit=unit, aligned16=al, load=load(sl.dtype, unit, al))

    if path == "skinny":
        a = operand(sa, m, M, aligned[sa], lambda *_: "ld")
        probe = operand(sb, n, N, aligned[sb], lambda *_: "")
        kv = probe.unit == "k"
        b = dataclasses.replace(probe, load="cp.async16" if probe.aligned16 else "ld")
        mt = next(t for t in SKINNY_MT if t >= M)
        tile = (mt, 32, 64) if kv else (mt, 128, 32)
        # 2 CTAs a streaming multiprocessor (registers, shared memory); a
        # partial is M x 128 sums against a K slab of the weight: cheap
        stages, slots, kmin, kmax, part = 4, 2 * SM_COUNT, 2 * tile[2], SKINNY_X // mt, 0.01
    elif mma == "ffma":
        def ffma_load(dt, unit, al):
            if dt != "float32":
                return "ld"
            return "cp.async16" if unit == "mn" and al else "cp.async4"

        a = operand(sa, m, M, aligned[sa], ffma_load)
        b = operand(sb, n, N, aligned[sb], ffma_load)
        # one CTA a streaming multiprocessor (163 registers a thread); a
        # partial is a 64 KB tile written and read again (6% a split: at
        # 7 splits llama3-8b's prefill gate ran slower than at 3)
        kv, tile, stages = False, (128, 128, 16), 3
        slots, kmin, kmax, part = SM_COUNT, 64, None, 0.06
    else:
        def tma_load(dt, unit, al):
            return "tma" if unit == "k" and al and not batch else "pack+tma"

        def tma_load_b(dt, unit, al):  # wgmma reads a 16-bit B transposed
            if unit == "mn" and al and not batch and dt in _HALF:
                return "tma-mn"
            return tma_load(dt, unit, al)

        a = operand(sa, m, M, aligned[sa], tma_load)
        b = operand(sb, n, N, aligned[sb], tma_load_b)
        kv, tile, stages = False, (128, 128, 128 // _SIZE[ta]), 4
    batch_ext = tuple(plan.out_ext[i] for i in batch)
    nbatch = math.prod(batch_ext)
    if mma == "wgmma":
        splits, k_split = 1, -(-K // tile[2]) * tile[2]
    else:
        m_tiles = 1 if path == "skinny" else -(-M // tile[0])
        tiles = m_tiles * -(-N // tile[1]) * nbatch
        splits, k_split = _splits(K, tiles, tile[2], slots, kmin, kmax, part)
    deferred = path == "tiled" and splits == 1 and bool(plan.epi)
    return GemmView(path=path, mma=mma, a=a, b=b, batch=tuple(batch), batch_ext=batch_ext,
                    m=m, n=n, k=k, M=M, N=N, K=K, swapped=swapped, tile=tile, stages=stages,
                    splits=splits, k_split=k_split, kv=kv, deferred=deferred), None


def gemm_view(plan: KernelPlan, aligned: Tuple[bool, bool] = (True, True)) -> Optional[GemmView]:
    """The plan as one batched GEMM, or None: then :func:`refusal` gives the
    reason and the kernel runs its general loop.  ``aligned``: whether the
    two operand tensors start at 16-byte boundaries (the launch knows)."""
    return _classify(plan, aligned)[0]


def refusal(plan: KernelPlan) -> Optional[str]:
    """Why :func:`gemm_view` refuses ``plan`` (None when it accepts it)."""
    return _classify(plan)[1]


def plan_path(plan: KernelPlan) -> str:
    """The path a launch of ``plan`` takes: "skinny", "tiled" or "general"."""
    view = gemm_view(plan)
    return "general" if view is None else view.path


# ---------------------------------------------------------- C binding
class _Prog(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("code", ctypes.c_int * MAXP),
                ("arg", ctypes.c_int * MAXP)]


_LL, _I = ctypes.c_longlong, ctypes.c_int


class _Params(ctypes.Structure):
    _fields_ = [
        ("out", ctypes.c_void_p),
        ("slot", ctypes.c_void_p * MAXS),
        ("eslot", ctypes.c_void_p * MAXE),
        ("slot_base", _LL * MAXS),
        ("slot_ostride", (_LL * MAXV) * MAXS),
        ("slot_rstride", (_LL * MAXV) * MAXS),
        ("eslot_base", _LL * MAXE),
        ("eslot_ostride", (_LL * MAXV) * MAXE),
        ("out_ostride", _LL * MAXV),
        ("scale", ctypes.c_double),
        ("consts", ctypes.c_double * MAXC),
        ("slot_dt", _I * MAXS),
        ("eslot_dt", _I * MAXE),
        ("out_dt", _I),
        ("acc_int", _I),
        ("out_ext", _I * MAXV),
        ("out_dim", _I * MAXV),
        ("out_coef", _I * MAXV),
        ("out_clip", _I * MAXD),
        ("red_ext", _I * MAXV),
        ("out_rank", _I),
        ("n_out", _I),
        ("n_red", _I),
        ("n_slot", _I),
        ("n_eslot", _I),
        ("block_x", _I),
        ("block_k", _I),
        ("fast", _I),
        ("lhs", _Prog),
        ("rhs", _Prog),
        ("epi", _Prog),
        # the GEMM view (path != PATH_GENERAL)
        ("work", ctypes.c_void_p),
        ("work_part", _LL),
        ("work_pack", _LL * 2),
        ("g_base", _LL * 2),
        ("g_smn", _LL * 2),
        ("g_sk", _LL * 2),
        ("g_bstr", (_LL * 2) * MAXV),
        ("g_bout", _LL * MAXV),
        ("g_bepi", (_LL * MAXE) * MAXV),
        ("g_omn", _LL * 2),
        ("g_emn", (_LL * 2) * MAXE),
        ("g_nbatch", _LL),
        ("g_bext", _I * MAXV),
        ("g_bdim", _I * MAXV),
        ("g_bcoef", _I * MAXV),
        ("g_mdim", _I * 2),
        ("g_mcoef", _I * 2),
        ("g_M", _I),
        ("g_N", _I),
        ("g_K", _I),
        ("g_nb", _I),
        ("g_a", _I),
        ("path", _I),
        ("splits", _I),
        ("k_split", _I),
        ("vec", _I * 2),
        ("tma_direct", _I * 2),
        ("kp", _I * 2),
        ("mt", _I),
        ("kv", _I),
        ("defer", _I),
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
                         _Params.lhs.offset, _Params.epi.offset, _Params.work.offset,
                         _Params.g_bepi.offset, _Params.g_nbatch.offset,
                         _Params.g_M.offset, _Params.kv.offset, _Params.defer.offset))


def load_library() -> ctypes.CDLL:
    """Build (at first use, with the other kernels) and bind the library;
    raises KernelBuildError."""
    return _build.load("contraction", _bind)


def _fill_prog(dst: _Prog, prog: Program) -> None:
    dst.n = len(prog)
    for i, (c, a) in enumerate(prog):
        dst.code[i] = c
        dst.arg[i] = a


def _general_shape(plan: KernelPlan) -> Tuple[int, int]:
    e0 = plan.out_ext[0] if plan.out_ext else 1
    inner = plan.red_ext[0] if plan.red_ext else 1
    bx = 32
    while bx < min(e0, 256):
        bx *= 2
    tk = 1
    while tk < 32 and plan.output_points() * tk < 2**18 and inner >= 64 * tk:
        tk *= 2
    return min(bx, 1024 // tk), tk


def launch_shape(plan: KernelPlan, path: Optional[str] = None) -> Tuple[Tuple[int, int], int]:
    """((threads x, threads y) per block, blocks) of one launch on ``path``
    (None: the view's choice).

    general: a warp covers 32 neighbouring outputs, and each output's
    reduction is split over threadIdx.y until about 2**18 threads are in
    flight (at most 32 ways, at least 32 steps of reduction variable 0 per
    thread, 1024 threads per block).  skinny and tiled float32: 256
    threads per CTA; tiled wgmma: two consumer warpgroups and one producer
    warp (288).  The view's blocks count the K splits (a split or
    deferred plan adds a second, grid-stride pass)."""
    view = gemm_view(plan) if path != "general" else None
    if view is None:
        bx, tk = _general_shape(plan)
        blocks = -(-(plan.out_ext[0] if plan.out_ext else 1) // bx)
        for e in plan.out_ext[1:]:
            blocks *= e
        return (bx, tk), blocks
    return (288 if view.mma == "wgmma" else 256, 1), view.blocks()


def _fill_view(p: _Params, plan: KernelPlan, view: GemmView) -> None:
    p.path = {"fma": PATH_SKINNY, "ffma": PATH_FFMA, "wgmma": PATH_WGMMA}[view.mma]
    p.g_a = view.a.slot
    for j, (op, r) in enumerate(((view.a, view.m), (view.b, view.n))):
        p.g_base[j] = op.base
        p.g_smn[j] = op.s_mn
        p.g_sk[j] = op.s_k
        p.vec[j] = int(op.load == "cp.async16")
        p.tma_direct[j] = {"tma": 1, "tma-mn": 2}.get(op.load, 0)
        p.kp[j] = view.k_packed(op) if op.load == "pack+tma" else 0
        p.g_mdim[j] = plan.out_dim[r] if r is not None else -1
        p.g_mcoef[j] = plan.out_coef[r] if r is not None else 0
        p.g_omn[j] = p.out_ostride[r] if r is not None else 0
        for s, es in enumerate(plan.eslots):
            p.g_emn[s][j] = es.ostride[r] if r is not None else 0
    p.g_nb = len(view.batch)
    p.g_nbatch = view.nbatch
    for i, v in enumerate(view.batch):
        p.g_bext[i] = plan.out_ext[v]
        p.g_bdim[i] = plan.out_dim[v]
        p.g_bcoef[i] = plan.out_coef[v]
        p.g_bstr[i][0] = view.a.batch[i]
        p.g_bstr[i][1] = view.b.batch[i]
        p.g_bout[i] = p.out_ostride[v]
        for s, es in enumerate(plan.eslots):
            p.g_bepi[i][s] = es.ostride[v]
    p.g_M, p.g_N, p.g_K = view.M, view.N, view.K
    p.splits, p.k_split = view.splits, view.k_split
    p.mt = view.tile[0] if view.path == "skinny" else 0
    p.kv = int(view.kv)
    p.defer = int(view.deferred)
    _total, part, pa, pb = view.work()
    p.work_part = part
    p.work_pack[0], p.work_pack[1] = pa, pb


def _params(plan: KernelPlan, clip: Tuple[int, ...], path: Optional[str] = None,
            aligned: Tuple[bool, bool] = (True, True)):
    """The launch parameters of ``plan`` for one clip and path, pointers
    left 0: (params, blocks, view or None)."""
    key = (clip, path, aligned)
    hit = plan._cparams.get(key)
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
    p.block_x, p.block_k = _general_shape(plan)
    p.fast = int(plan.fast)
    p.out_dt = _build.dtype_code(plan.out_dtype)
    p.acc_int = int(plan.acc == "int32")
    p.scale = plan.scale
    for i, c in enumerate(plan.consts):
        p.consts[i] = c
    _fill_prog(p.lhs, plan.lhs)
    _fill_prog(p.rhs, plan.rhs)
    _fill_prog(p.epi, plan.epi)
    view = None if path == "general" else gemm_view(plan, aligned)
    if view is None:
        p.path = PATH_GENERAL
        n_blocks = launch_shape(plan, "general")[1]
    else:
        _fill_view(p, plan, view)
        n_blocks = view.blocks()
    plan._cparams[key] = (p, n_blocks, view)
    return p, n_blocks, view


def contraction(plan: KernelPlan, slots: Sequence[torch.Tensor],
                eslots: Sequence[torch.Tensor],
                clip: Optional[Tuple[int, ...]] = None,
                path: Optional[str] = None) -> torch.Tensor:
    """Run one fusion group: the kernel for CUDA tensors, the plain version
    for CPU tensors.  Returns the output region cut to ``clip``.

    ``path``: None takes the GEMM view's choice (skinny, tiled, or the
    general loop where the view refuses the plan); ``"general"`` forces the
    general loop, to time it against the view's path on the same unit."""
    global launches
    if path not in (None, "general"):
        raise ValueError(f"path is None (the view's choice) or 'general', not {path!r}")
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
    aligned = tuple(bool(len(slots) > j and slots[j].data_ptr() % 16 == 0) for j in (0, 1))
    p, n_blocks, view = _params(plan, clip, path, aligned)
    out = torch.empty(clip, dtype=torch_dtype(plan.out_dtype), device=device)
    p.out = out.data_ptr()
    for s, t in enumerate(slots):
        p.slot[s] = t.data_ptr()
    for s, t in enumerate(eslots):
        p.eslot[s] = t.data_ptr()
    work = None
    if view is not None and view.work()[0] > 0:
        work = torch.empty(view.work()[0], dtype=torch.uint8, device=device)
    p.work = work.data_ptr() if work is not None else None
    if n_blocks > 0 and out.numel() > 0:
        rc = lib.stripe_contraction_launch(ctypes.addressof(p), n_blocks,
                                           _build.stream_of(device))
        _build.launch_rc(rc, "contraction")
        launches += 1
        launches_by_path["general" if view is None else view.path] += 1
    return out
