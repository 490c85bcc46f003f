"""The elementwise kernel: its plan, its binding, its launch counter, and
its plain PyTorch version.

``csrc/elementwise.cu`` replaces the TPU kernel
``src/repro/core/lower_pallas.py::_emit_elementwise``: one Stripe unit
that maps its inputs through a DAG (an activation, a bias add, a gate) at
every point of its output region.  The unit comes in as a :class:`MapPlan`
(built by :mod:`repro_torch.core.lower_cuda`): the output variables with
their extents, an element stride per variable for every input (0 where the
input lacks the variable, which is how a lower-rank input broadcasts), the
DAG as a postfix program, and the element types.  The DAG evaluates in
float32, or in int32 for an integer output, and the result is rounded once
to the output's type.

:func:`elementwise` launches the kernel for CUDA tensors (raising on any
failure) and runs :func:`elementwise_plain` only for CPU tensors.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import _build
from .contraction import (MAXC, MAXD, MAXE, MAXV, Program, Slot, _Prog, _TensorOps,
                          _expand_to, _fill_prog, _row_strides, _slot_view, acc_dtype,
                          place_region, run_postfix)

# Kernel launches since import (or since the caller last reset it).
launches = 0


@dataclasses.dataclass
class MapPlan:
    """An elementwise unit as the kernel sees it.  Output variable 0 has
    the smallest output stride; each output variable addresses one output
    dimension (``out_dim``) with coefficient ``out_coef``."""

    out_vars: Tuple[str, ...]
    out_ext: Tuple[int, ...]
    out_dim: Tuple[int, ...]
    out_coef: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    ins: Tuple[Slot, ...]
    prog: Program
    consts: Tuple[float, ...]
    out_dtype: str = "float32"
    _cparams: Dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def acc(self) -> str:
        return acc_dtype(self.out_dtype)

    def output_points(self) -> int:
        return math.prod(self.out_ext)


def elementwise_plain(plan: MapPlan, ins: Sequence[torch.Tensor],
                      clip: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the inputs converted to the
    evaluation type, the DAG on their broadcast views, rounded to the
    output's type.  Returns the output region cut to ``clip``."""
    from ..core.lower_torch import torch_dtype

    clip = tuple(plan.out_shape if clip is None else clip)
    device = ins[0].device if ins else torch.device("cpu")
    ext = dict(zip(plan.out_vars, plan.out_ext))
    acc_t = torch_dtype(plan.acc)
    ops = _TensorOps(ext, device, acc_t)
    views = [_slot_view(t.to(acc_t), s, plan.out_vars, plan.out_ext)
             for t, s in zip(ins, plan.ins)]
    val = run_postfix(plan.prog, views, None, plan.consts, ops)
    return place_region(_expand_to(val, plan.out_vars, ext, ops), plan, clip)


# ---------------------------------------------------------- C binding
class _EwParams(ctypes.Structure):
    _fields_ = [
        ("out", ctypes.c_void_p),
        ("inp", ctypes.c_void_p * MAXE),
        ("in_base", ctypes.c_longlong * MAXE),
        ("in_stride", (ctypes.c_longlong * MAXV) * MAXE),
        ("out_stride", ctypes.c_longlong * MAXV),
        ("n_points", ctypes.c_longlong),
        ("consts", ctypes.c_double * MAXC),
        ("in_dt", ctypes.c_int * MAXE),
        ("out_dt", ctypes.c_int),
        ("is_int", ctypes.c_int),
        ("ext", ctypes.c_int * MAXV),
        ("out_dim", ctypes.c_int * MAXV),
        ("out_coef", ctypes.c_int * MAXV),
        ("out_clip", ctypes.c_int * MAXD),
        ("out_rank", ctypes.c_int),
        ("n_var", ctypes.c_int),
        ("n_in", ctypes.c_int),
        ("prog", _Prog),
    ]


def _bind(lib: ctypes.CDLL) -> None:
    lib.stripe_elementwise_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p]
    lib.stripe_elementwise_launch.restype = ctypes.c_int
    lib.stripe_elementwise_layout.argtypes = [ctypes.c_void_p]
    lib.stripe_elementwise_layout.restype = None
    _build.check_layout(lib.stripe_elementwise_layout,
                        (ctypes.sizeof(_EwParams), _EwParams.in_stride.offset,
                         _EwParams.consts.offset, _EwParams.ext.offset,
                         _EwParams.out_rank.offset, _EwParams.prog.offset))


def load_library() -> ctypes.CDLL:
    return _build.load("elementwise", _bind)


def _params(plan: MapPlan, clip: Tuple[int, ...]) -> _EwParams:
    hit = plan._cparams.get(clip)
    if hit is not None:
        return hit
    p = _EwParams()
    for s, slot in enumerate(plan.ins):
        p.in_dt[s] = _build.dtype_code(slot.dtype)
        p.in_base[s] = slot.base
        for i, v in enumerate(slot.ostride):
            p.in_stride[s][i] = v
    rstr = _row_strides(clip)
    for i, (e, d, c) in enumerate(zip(plan.out_ext, plan.out_dim, plan.out_coef)):
        p.ext[i] = e
        p.out_dim[i] = d
        p.out_coef[i] = c
        p.out_stride[i] = c * rstr[d]
    for d, c in enumerate(clip):
        p.out_clip[d] = c
    p.out_rank = len(clip)
    p.n_var = len(plan.out_ext)
    p.n_in = len(plan.ins)
    p.n_points = plan.output_points()
    p.out_dt = _build.dtype_code(plan.out_dtype)
    p.is_int = int(plan.acc == "int32")
    for i, c in enumerate(plan.consts):
        p.consts[i] = c
    _fill_prog(p.prog, plan.prog)
    plan._cparams[clip] = p
    return p


def elementwise(plan: MapPlan, ins: Sequence[torch.Tensor],
                clip: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Run one elementwise unit: the kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns the output region cut to ``clip``."""
    global launches
    from ..core.lower_torch import torch_dtype

    clip = tuple(plan.out_shape if clip is None else clip)
    if not ins or not ins[0].is_cuda:
        if any(t.is_cuda for t in ins):
            raise ValueError("elementwise: inputs on the CPU and on the card")
        if not ins:
            raise ValueError("elementwise: a unit with no input has no device to run on")
        for t, s in zip(ins, plan.ins):
            _build.check_type(t, f"input {s.buf}", s.dtype)
        return elementwise_plain(plan, ins, clip)
    device = ins[0].device
    ins = [_build.check_cuda(t, f"input {s.buf}", device, s.dtype)
           for t, s in zip(ins, plan.ins)]
    lib = load_library()
    p = _params(plan, clip)
    out = torch.empty(clip, dtype=torch_dtype(plan.out_dtype), device=device)
    p.out = out.data_ptr()
    for s, t in enumerate(ins):
        p.inp[s] = t.data_ptr()
    if out.numel() > 0:
        rc = lib.stripe_elementwise_launch(ctypes.addressof(p),
                                           _build.grid_stride_blocks(plan.output_points()),
                                           _build.BLOCK,
                                           _build.stream_of(device))
        _build.launch_rc(rc, "elementwise")
        launches += 1
    return out
