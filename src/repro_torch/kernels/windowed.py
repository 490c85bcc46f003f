"""The windowed kernel: its plan, its binding, its launch counter, and its
plain PyTorch version.

``csrc/windowed.cu`` replaces the TPU kernel
``src/repro/core/lower_pallas.py::_emit_windowed``: a convolution over a
halo, a boundary remainder whose tail the block's constraints mask, any
constraint-carrying block.  The unit comes in as a :class:`WinPlan` (built
by :mod:`repro_torch.core.lower_cuda`): its output and reduction
variables, for every input its buffer shape and each dimension's
coordinate as an affine function of the variables, the block's constraints
as affine functions (live where >= 0), and the one or two operand sides
(or an assigning block's DAG) as postfix programs.  A read outside an
input reads 0, as the reference's zero padding does; the sum runs over
every reduction variable; the accumulator is float32, or int32 for an
integer output (the int8 convolution is bit-exact).

:func:`windowed` launches the kernel for CUDA tensors (raising on any
failure) and runs :func:`windowed_plain` only for CPU tensors.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .contraction import (MAXC, MAXD, MAXV, Program, _Prog, _TensorOps, _expand_to,
                          _fill_prog, _row_strides, acc_dtype, einsum_acc, place_region,
                          run_postfix)

MAXS = 6    # inputs
MAXQ = 16   # tracked affine quantities (offsets, checked coordinates, constraints)

# Kernel launches since import (or since the caller last reset it).
launches = 0

# An affine function of the unit's variables: (constant, coefficient per
# output variable, coefficient per reduction variable).
Affine = Tuple[int, Tuple[int, ...], Tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class WinInput:
    """One tensor the kernel reads: its buffer shape, element type, and
    the coordinate of each of its dimensions."""

    buf: str
    shape: Tuple[int, ...]
    dtype: str
    dims: Tuple[Affine, ...]


@dataclasses.dataclass
class WinPlan:
    """A windowed unit as the kernel sees it.  ``n_sides`` 2 multiplies the
    programs ``lhs`` and ``rhs``; 1 takes ``lhs`` alone (one operand side,
    or an assigning block's DAG, which then has no reduction variables).
    ``taps`` are the reduction variables the plain version enumerates:
    those in a constraint or beside an output variable in one input
    dimension (the reference's window variables)."""

    out_vars: Tuple[str, ...]
    out_ext: Tuple[int, ...]
    out_dim: Tuple[int, ...]
    out_coef: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    red_vars: Tuple[str, ...]
    red_ext: Tuple[int, ...]
    ins: Tuple[WinInput, ...]
    constraints: Tuple[Affine, ...]
    lhs: Program
    rhs: Program
    n_sides: int
    consts: Tuple[float, ...]
    scale: float
    taps: Tuple[str, ...]
    out_dtype: str = "float32"
    _cparams: Dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def acc(self) -> str:
        return acc_dtype(self.out_dtype)

    def output_points(self) -> int:
        return math.prod(self.out_ext)

    def reduction_points(self) -> int:
        return math.prod(self.red_ext)

    def dim_range(self, a: Affine) -> Tuple[int, int]:
        """The least and the largest value of ``a`` over the unit's points."""
        const, oc, rc = a
        terms = [c * (e - 1) for c, e in zip(oc + rc, self.out_ext + self.red_ext)]
        return (const + sum(min(0, t) for t in terms), const + sum(max(0, t) for t in terms))

    def checked(self) -> List[Tuple[int, int, Affine]]:
        """(input, dimension, coordinate) of every coordinate that can leave
        its dimension: those reads are guarded and read 0 outside."""
        out = []
        for s, inp in enumerate(self.ins):
            for d, (a, size) in enumerate(zip(inp.dims, inp.shape)):
                lo, hi = self.dim_range(a)
                if lo < 0 or hi >= size:
                    out.append((s, d, a))
        return out

    def n_tracked(self) -> int:
        return len(self.ins) + len(self.checked()) + len(self.constraints)

    @property
    def fast(self) -> bool:
        """Two plain loads multiplied, and reduction variable 0 moves no
        checked coordinate and no constraint (the kernel's dot-product
        loop)."""
        moved = [a for _s, _d, a in self.checked()] + list(self.constraints)
        return (self.n_sides == 2 and self.lhs == ((0, 0),) and self.rhs == ((0, 1),)
                and len(self.ins) == 2
                and not (self.red_vars and any(a[2][0] for a in moved)))


# ------------------------------------------------------------ plain version
def windowed_plain(plan: WinPlan, ins: Sequence[torch.Tensor],
                   clip: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """The plain PyTorch version, shaped like the reference's kernel: each
    input is zero-padded (``F.pad``) to cover every coordinate it is read
    at; for each combination of the taps, every input is sliced to a
    strided view with one axis per remaining variable, the sides are
    evaluated and contracted (``torch.einsum`` over the reduction
    variables), constraint-dead output points are masked to 0, and the
    terms are summed.  Returns the output region cut to ``clip``."""
    from ..core.lower_torch import torch_dtype

    clip = tuple(plan.out_shape if clip is None else clip)
    device = ins[0].device if ins else torch.device("cpu")
    names = plan.out_vars + plan.red_vars
    ext = dict(zip(names, plan.out_ext + plan.red_ext))
    acc_t = torch_dtype(plan.acc)
    ops = _TensorOps(ext, device, acc_t)
    tap_pos = [names.index(t) for t in plan.taps]

    padded, pad_lo = [], []
    for t, inp in zip(ins, plan.ins):
        lows, pads = [], []
        for a, size in zip(inp.dims, inp.shape):
            lo, hi = plan.dim_range(a)
            lows.append(max(0, -lo))
            pads.append((max(0, -lo), max(0, hi - (size - 1))))
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        t = t.to(acc_t).contiguous()
        padded.append(F.pad(t, flat) if any(flat) else t)
        pad_lo.append(lows)

    def coefs(a: Affine) -> Tuple[int, ...]:
        return a[1] + a[2]

    total = None
    for combo in itertools.product(*[range(ext[t]) for t in plan.taps]):
        views = []
        for t, inp, lows in zip(padded, plan.ins, pad_lo):
            pstr = _row_strides(t.shape)
            offset = 0
            strides = [0] * len(names)
            for (a, st, lo) in zip(inp.dims, pstr, lows):
                c = coefs(a)
                offset += (a[0] + lo + sum(c[k] * v for k, v in zip(tap_pos, combo))) * st
                for k in range(len(names)):
                    if k not in tap_pos:
                        strides[k] += c[k] * st
            keep = [k for k in range(len(names)) if strides[k] != 0]
            views.append((torch.as_strided(t, [ext[names[k]] for k in keep],
                                           [strides[k] for k in keep], offset),
                          tuple(names[k] for k in keep)))
        if plan.n_sides == 2:
            lhs = run_postfix(plan.lhs, views, None, plan.consts, ops)
            rhs = run_postfix(plan.rhs, views, None, plan.consts, ops)
            present = [v for v in plan.out_vars if v in lhs[1] or v in rhs[1]]
            letters = {v: chr(ord("a") + i) for i, v in enumerate(names)}
            eq = ("".join(letters[v] for v in lhs[1]) + "," + "".join(letters[v] for v in rhs[1])
                  + "->" + "".join(letters[v] for v in present))
            term = (einsum_acc(eq, lhs[0], rhs[0]), tuple(present))
            used = set(lhs[1]) | set(rhs[1])
        else:
            val, vs = run_postfix(plan.lhs, views, None, plan.consts, ops)
            red = [i for i, v in enumerate(vs) if v not in plan.out_vars]
            term = (val.sum(dim=red, dtype=acc_t) if red else val,
                    tuple(v for v in vs if v in plan.out_vars))
            used = set(vs)
        # a reduction variable the sides do not read adds the same term once
        # per point, as the kernel's loop does
        absent = math.prod(ext[v] for v in plan.red_vars
                           if v not in used and v not in plan.taps)
        val = _expand_to(term, plan.out_vars, ext, ops)
        if absent != 1:
            val = val * absent
        mask = _mask(plan, combo, tap_pos, device)
        if mask is not None:
            val = torch.where(mask, val, torch.zeros((), dtype=val.dtype, device=device))
        total = val if total is None else total + val
    if plan.scale != 1.0:
        total = total * ops.const(plan.scale)[0]
    return place_region(total, plan, clip)


def _mask(plan: WinPlan, combo, tap_pos, device) -> Optional[torch.Tensor]:
    """Where every constraint holds, over the output variables, at one
    combination of the taps (None: no constraint)."""
    mask = None
    n_out = len(plan.out_vars)
    for const, oc, rc in plan.constraints:
        c = oc + rc
        k = const + sum(c[p] * v for p, v in zip(tap_pos, combo))
        if any(c[j] for j in range(n_out, len(c)) if j not in tap_pos):
            raise ValueError("a constraint over a reduction variable that is not a tap")
        val = torch.full(plan.out_ext, k, dtype=torch.int64, device=device)
        for i, (coef, e) in enumerate(zip(oc, plan.out_ext)):
            if coef:
                shape = [1] * n_out
                shape[i] = e
                val = val + coef * torch.arange(e, device=device).reshape(shape)
        m = val >= 0
        mask = m if mask is None else mask & m
    return mask


# ---------------------------------------------------------- C binding
class _WinParams(ctypes.Structure):
    _fields_ = [
        ("out", ctypes.c_void_p),
        ("slot", ctypes.c_void_p * MAXS),
        ("q0", ctypes.c_longlong * MAXQ),
        ("qo", (ctypes.c_longlong * MAXV) * MAXQ),
        ("qr", (ctypes.c_longlong * MAXV) * MAXQ),
        ("out_stride", ctypes.c_longlong * MAXV),
        ("n_points", ctypes.c_longlong),
        ("scale", ctypes.c_double),
        ("consts", ctypes.c_double * MAXC),
        ("slot_dt", ctypes.c_int * MAXS),
        ("chk_slot", ctypes.c_int * MAXQ),
        ("chk_hi", ctypes.c_int * MAXQ),
        ("out_dt", ctypes.c_int),
        ("is_int", ctypes.c_int),
        ("n_sides", ctypes.c_int),
        ("out_ext", ctypes.c_int * MAXV),
        ("out_dim", ctypes.c_int * MAXV),
        ("out_coef", ctypes.c_int * MAXV),
        ("out_clip", ctypes.c_int * MAXD),
        ("red_ext", ctypes.c_int * MAXV),
        ("out_rank", ctypes.c_int),
        ("n_out", ctypes.c_int),
        ("n_red", ctypes.c_int),
        ("n_slot", ctypes.c_int),
        ("n_chk", ctypes.c_int),
        ("n_cons", ctypes.c_int),
        ("fast", ctypes.c_int),
        ("lhs", _Prog),
        ("rhs", _Prog),
    ]


def _bind(lib: ctypes.CDLL) -> None:
    lib.stripe_windowed_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    lib.stripe_windowed_launch.restype = ctypes.c_int
    lib.stripe_windowed_layout.argtypes = [ctypes.c_void_p]
    lib.stripe_windowed_layout.restype = None
    _build.check_layout(lib.stripe_windowed_layout,
                        (ctypes.sizeof(_WinParams), _WinParams.qr.offset,
                         _WinParams.scale.offset, _WinParams.chk_hi.offset,
                         _WinParams.out_rank.offset, _WinParams.rhs.offset))


def load_library() -> ctypes.CDLL:
    return _build.load("windowed", _bind)


def _params(plan: WinPlan, clip: Tuple[int, ...]) -> _WinParams:
    hit = plan._cparams.get(clip)
    if hit is not None:
        return hit
    p = _WinParams()
    n_o, n_r = len(plan.out_vars), len(plan.red_vars)
    tracked: List[Affine] = []
    for s, inp in enumerate(plan.ins):
        p.slot_dt[s] = _build.dtype_code(inp.dtype)
        rstr = _row_strides(inp.shape)
        tracked.append((sum(a[0] * st for a, st in zip(inp.dims, rstr)),
                        tuple(sum(a[1][i] * st for a, st in zip(inp.dims, rstr))
                              for i in range(n_o)),
                        tuple(sum(a[2][j] * st for a, st in zip(inp.dims, rstr))
                              for j in range(n_r))))
    checked = plan.checked()
    for c, (s, d, a) in enumerate(checked):
        p.chk_slot[c] = s
        p.chk_hi[c] = plan.ins[s].shape[d]
        tracked.append(a)
    tracked.extend(plan.constraints)
    for k, (const, oc, rc) in enumerate(tracked):
        p.q0[k] = const
        for i, v in enumerate(oc):
            p.qo[k][i] = v
        for j, v in enumerate(rc):
            p.qr[k][j] = v
    ostr = _row_strides(clip)
    for i, (e, d, c) in enumerate(zip(plan.out_ext, plan.out_dim, plan.out_coef)):
        p.out_ext[i] = e
        p.out_dim[i] = d
        p.out_coef[i] = c
        p.out_stride[i] = c * ostr[d]
    for d, c in enumerate(clip):
        p.out_clip[d] = c
    for j, e in enumerate(plan.red_ext):
        p.red_ext[j] = e
    p.out_rank = len(clip)
    p.n_out, p.n_red, p.n_slot = n_o, n_r, len(plan.ins)
    p.n_chk, p.n_cons = len(checked), len(plan.constraints)
    p.n_points = plan.output_points()
    p.out_dt = _build.dtype_code(plan.out_dtype)
    p.is_int = int(plan.acc == "int32")
    p.n_sides = plan.n_sides
    p.fast = int(plan.fast)
    p.scale = plan.scale
    for i, c in enumerate(plan.consts):
        p.consts[i] = c
    _fill_prog(p.lhs, plan.lhs)
    _fill_prog(p.rhs, plan.rhs)
    plan._cparams[clip] = p
    return p


def windowed(plan: WinPlan, ins: Sequence[torch.Tensor],
             clip: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Run one windowed unit: the kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns the output region cut to ``clip``."""
    global launches
    from ..core.lower_torch import torch_dtype

    if not ins:
        raise ValueError("windowed: a unit with no input has no device to run on")
    clip = tuple(plan.out_shape if clip is None else clip)
    if not ins[0].is_cuda:
        if any(t.is_cuda for t in ins):
            raise ValueError("windowed: inputs on the CPU and on the card")
        for t, s in zip(ins, plan.ins):
            _build.check_type(t, f"input {s.buf}", s.dtype)
        return windowed_plain(plan, ins, clip)
    device = ins[0].device
    ins = [_build.check_cuda(t, f"input {s.buf}", device, s.dtype)
           for t, s in zip(ins, plan.ins)]
    for t, s in zip(ins, plan.ins):
        if tuple(t.shape) != s.shape:
            raise ValueError(f"input {s.buf}: shape {tuple(t.shape)}, planned {s.shape}")
    lib = load_library()
    p = _params(plan, clip)
    out = torch.empty(clip, dtype=torch_dtype(plan.out_dtype), device=device)
    p.out = out.data_ptr()
    for s, t in enumerate(ins):
        p.slot[s] = t.data_ptr()
    if out.numel() > 0:
        rc = lib.stripe_windowed_launch(ctypes.addressof(p),
                                        _build.grid_stride_blocks(plan.output_points()),
                                        _build.BLOCK,
                                        _build.stream_of(device))
        _build.launch_rc(rc, "windowed")
        launches += 1
    return out
