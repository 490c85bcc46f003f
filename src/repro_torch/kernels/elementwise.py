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

:func:`vec_view` reads a plan whose variable 0 is unit-stride in the
output and unit-stride or broadcast in every input as rows of whole
8-point vectors; such a plan takes the kernel's ``vec`` path (16-byte
loads and stores, the program's stack in registers, one slot per
instruction from :func:`prog_slots`).  Any other plan (or one the caller
sends down ``path="general"``) runs the general loop, one thread a point,
and :func:`refusal` says why.

:func:`elementwise` launches the kernel for CUDA tensors (raising on any
failure) and runs :func:`elementwise_plain` only for CPU tensors.
``launches`` counts kernel launches, ``launches_by_path`` the same
launches by path.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import re
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import _build
from .contraction import (MAXC, MAXD, MAXE, MAXP, MAXV, OP_ACC, OP_BINARY, OP_CONST, OP_LOAD,
                          Program, Slot, _Prog, _TensorOps, _expand_to, _fill_prog,
                          _row_strides, _slot_view, acc_dtype, place_region, run_postfix,
                          stack_depth)

# Kernel launches since import (or since the caller last reset it), and
# the same launches by path.
launches = 0
PATHS = ("vec", "general")
launches_by_path = {p: 0 for p in PATHS}

# The vec path's geometry (csrc/elementwise.cu): 8 points a vector, 4
# stack slots in registers, 256 threads a block.
VW, VSLOT, VEC_BLOCK = 8, 4, 256


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


# ------------------------------------------------------------ the vec view
def magic(d: int) -> Tuple[int, int]:
    """(mul, shr) with n // d == (n * mul) >> shr for 0 <= n < 2**31 and
    mul below 2**32 (Granlund and Montgomery: shr = 31 + ceil(log2 d))."""
    if d < 1:
        raise ValueError(f"divisor {d}")
    shr = 31 + (d - 1).bit_length()
    mul = -(-(1 << shr) // d)
    assert mul < 1 << 32
    return mul, shr


def prog_slots(prog: Program) -> Tuple[Tuple[int, int, int], ...]:
    """Each postfix instruction's stack slots (dst, a, b), which do not
    depend on the data: a load or constant writes the next slot, a unary
    op rewrites the top, a binary op reads the two top slots and writes the
    lower (-1: no operand)."""
    out, sp = [], 0
    for code, _arg in prog:
        if code in (OP_LOAD, OP_CONST, OP_ACC):
            out.append((sp, -1, -1))
            sp += 1
        elif code < OP_BINARY:
            out.append((sp - 1, sp - 1, -1))
        else:
            out.append((sp - 2, sp - 2, sp - 1))
            sp -= 1
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class VecView:
    """A plan as rows of whole vectors: ``n_vec`` vectors of ``VW``
    points, one a thread-step; ``clipped`` when some vector lies outside
    the clip (the kernel then tests each vector)."""

    n_vec: int
    clipped: bool

    def blocks(self) -> int:
        return max(1, min(_build.MAX_BLOCKS, -(-self.n_vec // VEC_BLOCK)))


def input_alignment(ins: Optional[Sequence[torch.Tensor]]) -> Tuple[bool, ...]:
    """Whether each input starts on a 16-byte boundary (None: unknown,
    taken as aligned).  A non-contiguous input counts as aligned: the
    launch copies it to a new allocation first."""
    if ins is None:
        return ()
    return tuple(not t.is_contiguous() or t.data_ptr() % 16 == 0 for t in ins)


def _vec_classify(plan: MapPlan, aligned: Tuple[bool, ...], clip: Tuple[int, ...]):
    """(VecView, None) or (None, the reason the general loop runs)."""
    key = ("vec", aligned, clip)
    hit = plan._cparams.get(key)
    if hit is None:
        hit = plan._cparams[key] = _vec_classify_uncached(plan, aligned, clip)
    return hit


def _vec_classify_uncached(plan: MapPlan, aligned: Tuple[bool, ...], clip: Tuple[int, ...]):
    if not plan.out_ext:
        return None, "the unit has no output variable"
    names = plan.out_vars
    rstr = _row_strides(clip)
    ostr = [c * rstr[d] for d, c in zip(plan.out_dim, plan.out_coef)]
    if ostr[0] != 1:
        return None, f"variable 0 ({names[0]}) has output stride {ostr[0]}, not 1"
    if plan.out_ext[0] % VW:
        return None, (f"variable 0 ({names[0]}) has extent {plan.out_ext[0]}, not a multiple "
                      f"of {VW}")
    for s in plan.ins:
        if s.ostride[0] not in (0, 1):
            return None, (f"input {s.buf} has stride {s.ostride[0]} along variable 0 "
                          f"({names[0]}), not 1 or 0")
    for i in range(1, len(names)):
        if ostr[i] % VW:
            return None, (f"the output's stride along {names[i]} is {ostr[i]}, not a multiple "
                          f"of {VW}")
    # a broadcast input (stride 0 along variable 0) is read one scalar a
    # vector, which needs no alignment: only the others are read as vectors
    vectors = [(s, ok) for s, ok in zip(plan.ins, aligned or (True,) * len(plan.ins))
               if s.ostride[0]]
    for s, _ok in vectors:
        if s.base % VW:
            return None, f"input {s.buf} starts at element {s.base}, not a multiple of {VW}"
        for i in range(1, len(names)):
            if s.ostride[i] % VW:
                return None, (f"input {s.buf} has stride {s.ostride[i]} along {names[i]}, not "
                              f"a multiple of {VW}")
    for s, ok in vectors:
        if not ok:
            return None, f"input {s.buf} does not start on a 16-byte boundary"
    # the largest coordinate along each output dimension.  A vector starts
    # at a multiple of 8 along variable 0's dimension when every other
    # variable's coefficient there is a multiple of 8: a clip at a multiple
    # of 8 then cuts no vector
    top = [0] * len(clip)
    for d, c, e in zip(plan.out_dim, plan.out_coef, plan.out_ext):
        top[d] += c * (e - 1)
    d0 = plan.out_dim[0]
    others = [c for i, (d, c) in enumerate(zip(plan.out_dim, plan.out_coef)) if i and d == d0]
    if top[d0] >= clip[d0] and (clip[d0] % VW or any(c % VW for c in others)):
        return None, f"the clip {clip} cuts a vector along output dimension {d0}"
    if any(abs(x) >= 1 << 31 for x in ostr + [st for sl in plan.ins for st in sl.ostride]):
        return None, "a stride exceeds the kernel's 32-bit strides"
    depth = stack_depth(plan.prog)
    if depth > VSLOT:
        return None, f"the program is {depth} deep, past the {VSLOT} slots in registers"
    n_vec = plan.output_points() // VW
    if n_vec >= 1 << 31:
        return None, f"{n_vec} vectors exceed the kernel's 32-bit vector index"
    clipped = any(t >= c for t, c in zip(top, clip))
    return VecView(n_vec=n_vec, clipped=clipped), None


def vec_view(plan: MapPlan, ins: Optional[Sequence[torch.Tensor]] = None,
             clip: Optional[Tuple[int, ...]] = None) -> Optional[VecView]:
    """The plan as rows of whole vectors, or None: then :func:`refusal`
    gives the reason and the kernel runs its general loop.  ``ins``: the
    tensors of the launch (their alignment counts; None: taken as
    aligned); ``clip``: the output region (default the plan's shape)."""
    clip = tuple(plan.out_shape if clip is None else clip)
    return _vec_classify(plan, input_alignment(ins), clip)[0]


def refusal(plan: MapPlan, ins: Optional[Sequence[torch.Tensor]] = None,
            clip: Optional[Tuple[int, ...]] = None) -> Optional[str]:
    """Why :func:`vec_view` refuses ``plan`` (None when it accepts it)."""
    clip = tuple(plan.out_shape if clip is None else clip)
    return _vec_classify(plan, input_alignment(ins), clip)[1]


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


_LL, _I = ctypes.c_longlong, ctypes.c_int


class _VecParams(ctypes.Structure):
    """The vec path's launch record (csrc/elementwise.cu: VecParams)."""

    _fields_ = [
        ("out", ctypes.c_void_p),
        ("inp", ctypes.c_void_p * MAXE),
        ("in_base", _LL * MAXE),
        ("n_vec", _LL),
        ("consts", ctypes.c_double * MAXC),
        ("in_stride", (_I * MAXV) * MAXE),
        ("out_stride", _I * MAXV),
        ("div_mul", ctypes.c_uint * MAXV),
        ("div_shr", _I * MAXV),
        ("div", _I * MAXV),
        ("clip_coef", (_I * MAXV) * MAXD),
        ("out_clip", _I * MAXD),
        ("in_dt", _I * MAXE),
        ("in_bcast", _I * MAXE),
        ("out_dt", _I),
        ("n_in", _I),
        ("n_var", _I),
        ("out_rank", _I),
        ("clipped", _I),
        ("n", _I),
        ("ins", _I * MAXP),
    ]


def ins_word(code: int, arg: int, dst: int, a: int, b: int) -> int:
    """One postfix instruction as the vec kernel reads it (``INS_*``):
    op-code, argument, and its slots; 7 where it reads no slot."""
    return code | arg << 8 | dst << 16 | (a & 7) << 20 | (b & 7) << 24


def _bind(lib: ctypes.CDLL) -> None:
    lib.stripe_elementwise_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p]
    lib.stripe_elementwise_launch.restype = ctypes.c_int
    lib.stripe_elementwise_vec_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_void_p]
    lib.stripe_elementwise_vec_launch.restype = ctypes.c_int
    lib.stripe_elementwise_empty.argtypes = [ctypes.c_void_p]
    lib.stripe_elementwise_empty.restype = ctypes.c_int
    for fn in (lib.stripe_elementwise_layout, lib.stripe_elementwise_vec_layout):
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = None
    _build.check_layout(lib.stripe_elementwise_layout,
                        (ctypes.sizeof(_EwParams), _EwParams.in_stride.offset,
                         _EwParams.consts.offset, _EwParams.ext.offset,
                         _EwParams.out_rank.offset, _EwParams.prog.offset))
    _build.check_layout(lib.stripe_elementwise_vec_layout,
                        (ctypes.sizeof(_VecParams), _VecParams.consts.offset,
                         _VecParams.in_stride.offset, _VecParams.div_mul.offset,
                         _VecParams.clip_coef.offset, _VecParams.out_dt.offset,
                         _VecParams.ins.offset))


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


def _vec_params(plan: MapPlan, view: VecView, clip: Tuple[int, ...]) -> _VecParams:
    """The vec launch record of ``plan`` for one clip, pointers left 0."""
    key = ("vec-params", clip)
    hit = plan._cparams.get(key)
    if hit is not None:
        return hit
    p = _VecParams()
    rstr = _row_strides(clip)
    for s, slot in enumerate(plan.ins):
        p.in_dt[s] = _build.dtype_code(slot.dtype)
        p.in_bcast[s] = int(slot.ostride[0] == 0)
        p.in_base[s] = slot.base
        for i, v in enumerate(slot.ostride):
            p.in_stride[s][i] = v
    for i, (e, d, c) in enumerate(zip(plan.out_ext, plan.out_dim, plan.out_coef)):
        p.out_stride[i] = c * rstr[d]
        p.div[i] = e // VW if i == 0 else e
        p.div_mul[i], p.div_shr[i] = magic(p.div[i])
        p.clip_coef[d][i] = c
    for d, c in enumerate(clip):
        p.out_clip[d] = c
    p.n_vec = view.n_vec
    p.out_dt = _build.dtype_code(plan.out_dtype)
    p.n_in, p.n_var, p.out_rank = len(plan.ins), len(plan.out_ext), len(clip)
    p.clipped = int(view.clipped)
    for i, c in enumerate(plan.consts):
        p.consts[i] = c
    p.n = len(plan.prog)
    for i, ((code, arg), slots) in enumerate(zip(plan.prog, prog_slots(plan.prog))):
        p.ins[i] = ins_word(code, arg, *slots)
    plan._cparams[key] = p
    return p


_MANGLED = {"f": "float", "i": "int", "j": "unsigned", "x": "long long"}


def resource_usage() -> Dict[str, Dict[str, int]]:
    """``ptxas -v``'s registers, stack frame and spill bytes of every
    instantiation of both paths' kernels, by demangled name
    (``elementwise_vec_kernel<float, 2>``, ``elementwise_kernel<float,
    unsigned>``).  Needs nvcc."""
    out = {}
    for mangled, use in _build.parse_ptxas(_build.ptxas_text("elementwise")).items():
        m = re.search(r"elementwise_vec_kernelI([fi])Li(\d+)E", mangled)
        if m:
            out[f"elementwise_vec_kernel<{_MANGLED[m.group(1)]}, {m.group(2)}>"] = use
            continue
        m = re.search(r"elementwise_kernelI([fi])([jx])E", mangled)
        if m:
            out[f"elementwise_kernel<{_MANGLED[m.group(1)]}, {_MANGLED[m.group(2)]}>"] = use
    return out


def empty_launch(device) -> None:
    """One launch of an empty kernel on ``device``'s current stream: the
    floor of a launch's event time, for timing beside the units (counted
    nowhere)."""
    _build.launch_rc(load_library().stripe_elementwise_empty(_build.stream_of(device)),
                     "empty kernel")


def elementwise(plan: MapPlan, ins: Sequence[torch.Tensor],
                clip: Optional[Tuple[int, ...]] = None,
                path: Optional[str] = None) -> torch.Tensor:
    """Run one elementwise unit: the kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns the output region cut to ``clip``.

    ``path``: None takes the vec view's choice (``vec``, or the general
    loop where the view refuses the plan); ``"general"`` forces the
    general loop, to time it against the vec path on the same unit."""
    global launches
    from ..core.lower_torch import torch_dtype

    if path not in (None, "general"):
        raise ValueError(f"path is None (the view's choice) or 'general', not {path!r}")
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
    view = None if path == "general" else vec_view(plan, ins, clip)
    out = torch.empty(clip, dtype=torch_dtype(plan.out_dtype), device=device)
    if out.numel() == 0:
        return out
    stream = _build.stream_of(device)
    p = _params(plan, clip) if view is None else _vec_params(plan, view, clip)
    p.out = out.data_ptr()
    for s, t in enumerate(ins):
        p.inp[s] = t.data_ptr()
    if view is None:
        rc = lib.stripe_elementwise_launch(ctypes.addressof(p),
                                           _build.grid_stride_blocks(plan.output_points()),
                                           _build.BLOCK, stream)
    else:
        rc = lib.stripe_elementwise_vec_launch(ctypes.addressof(p), int(plan.acc == "int32"),
                                               view.blocks(), stream)
    _build.launch_rc(rc, "elementwise")
    launches += 1
    launches_by_path["general" if view is None else "vec"] += 1
    return out
