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

:func:`conv_view` reads a plan that multiplies two plain loads as an
implicit GEMM, C[m, n] = sum_k A[m, k] B[k, n]: M the output variables
only the input side reads, N the one the filter side reads, K the inner
reduction variable (unit-stride in the input) times the taps.  Such a
plan takes the kernel's ``igemm`` path (wgmma for bf16 / f16 / int8,
register tiles on the CUDA cores for float32); any other plan (or one the
caller sends down ``path="general"``) runs the general odometer loop, and
:func:`refusal` says why.

:func:`windowed` launches the kernel for CUDA tensors (raising on any
failure) and runs :func:`windowed_plain` only for CPU tensors.
``launches`` counts kernel launches, ``launches_by_path`` the same
launches by path.
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
from .contraction import (_SIZE, MAXC, MAXD, MAXV, SM_COUNT, Program, _Prog, _TensorOps,
                          _expand_to, _fill_prog, _row_strides, acc_dtype, einsum_acc,
                          place_region, run_postfix)

MAXS = 6    # inputs
MAXQ = 16   # tracked affine quantities (offsets, checked coordinates, constraints)

# Kernel launches since import (or since the caller last reset it), and
# the same launches by path.
launches = 0
PATHS = ("igemm", "general")
launches_by_path = {p: 0 for p in PATHS}

# The igemm path's geometry (csrc/windowed.cu): 128 x 64 output tiles, 128
# bytes of K a row per stage, 256 threads, and at most IG_MAXT taps (the
# bits of a row's mask in the gather tables).
IG_BM, IG_BN, IG_ROW, IG_MAXT = 128, 64, 128, 64

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


def _tracked(plan: WinPlan) -> List[Affine]:
    """The kernel's tracked quantities (``WinParams.q0 / qo / qr``): each
    input's element offset, then each checked coordinate, then each
    constraint."""
    n_o, n_r = len(plan.out_vars), len(plan.red_vars)
    out: List[Affine] = []
    for inp in plan.ins:
        rstr = _row_strides(inp.shape)
        out.append((sum(a[0] * st for a, st in zip(inp.dims, rstr)),
                    tuple(sum(a[1][i] * st for a, st in zip(inp.dims, rstr)) for i in range(n_o)),
                    tuple(sum(a[2][j] * st for a, st in zip(inp.dims, rstr)) for j in range(n_r))))
    out += [a for _s, _d, a in plan.checked()]
    return out + list(plan.constraints)


# ------------------------------------------------------- the implicit GEMM
@dataclasses.dataclass(frozen=True)
class ConvView:
    """A windowed plan as one implicit GEMM C[m, n] = sum_k A[m, k] B[k, n].

    ``a`` is the input side's slot (its rows are gathered), B the filter's
    (slot ``1 - a``).  ``m_vars`` index ``plan.out_vars``, fastest first;
    ``n`` is the output variable of N; K runs over the inner reduction
    variable 0 (``kc`` values, unit-stride in the input) and then the
    ``taps`` (indices into ``plan.red_vars``, fastest first), so
    k = c + kc * tap.  The filter may have checked coordinates, and the
    unit constraints, over N alone (a remainder's last columns): B reads
    its first ``nb`` columns and zeros past them.  ``b_load`` says how B's tiles reach shared memory:
    "tma-mn" (a 16-bit B, N-major, read in place and transposed by
    wgmma), "tma" (K-major, in place), "pack+tma" (copied K-major first:
    int8, which wgmma reads K-major only, or a B whose K is not one
    stride), "cp.async16" (float32, N-major, in place) or
    "pack+cp.async16".  ``b_sk`` / ``b_sn``: B's strides along K and N in
    elements, in its tensor from ``b_base`` (in place) or in the packed
    copy."""

    mma: str                    # "wgmma" (bf16 / f16 / int8), "ffma" (float32)
    a: int
    m_vars: Tuple[int, ...]
    n: int
    taps: Tuple[int, ...]
    M: int
    N: int
    nb: int                     # columns of B it reads (past them, zeros)
    K: int
    kc: int
    b_load: str
    b_base: int
    b_sk: int
    b_sn: int
    tile: Tuple[int, int, int]  # (BM, BN, BK): BK elements of K a stage
    stages: int
    splits: int                 # K split over CTAs; partials meet in a second pass
    k_split: int                # K a split, whole stages

    def tiles(self) -> int:
        return -(-self.M // self.tile[0]) * -(-self.N // self.tile[1])

    def blocks(self) -> int:
        return self.tiles() * self.splits

    @property
    def packed(self) -> bool:
        return self.b_load.startswith("pack")

    def k_padded(self) -> int:
        """K rounded up to whole stages (the packed K-major row length)."""
        return -(-self.K // self.tile[2]) * self.tile[2]

    def work(self, dtype: str) -> Tuple[int, int]:
        """(bytes, offset of the partials) of the scratch a launch needs:
        the packed filter, then a split K's float32 / int32 partials."""
        packed = 0
        if self.packed:
            rows = self.N if self.b_sk == 1 else self.K
            packed = -(-rows * (self.b_sn if self.b_sk == 1 else self.b_sk) * _SIZE[dtype] // 256) * 256
        parts = self.splits * self.M * self.N * 4 if self.splits > 1 else 0
        return packed + parts, packed


def _classify(plan: WinPlan, aligned: Tuple[bool, bool] = (True, True)):
    """(ConvView, None) or (None, the reason the general loop runs)."""
    key = ("view", aligned)
    hit = plan._cparams.get(key)
    if hit is None:
        hit = plan._cparams[key] = _classify_uncached(plan, aligned)
    return hit


def _classify_uncached(plan: WinPlan, aligned: Tuple[bool, bool]):
    if not plan.fast or not plan.red_vars:
        return None, ("not two plain loads multiplied over an inner reduction variable that "
                      "moves no guarded coordinate")
    ta, tb = plan.ins[0].dtype, plan.ins[1].dtype
    int_acc = plan.acc == "int32"
    if ta != tb or (ta == "int8") != int_acc or ta not in _SIZE:
        return None, f"igemm takes no {ta} x {tb} -> {plan.acc} product"
    q = _tracked(plan)
    reads = [[q[s][1][i] != 0 for i in range(len(plan.out_vars))] for s in (0, 1)]
    for i, (v, e) in enumerate(zip(plan.out_vars, plan.out_ext)):
        if e > 1 and reads[0][i] and reads[1][i]:
            return None, f"output variable {v} is read by both inputs (a batch variable)"
        if e > 1 and not (reads[0][i] or reads[1][i]):
            return None, f"output variable {v} is read by neither input"
    checked = plan.checked()

    def filter_side(s: int) -> bool:
        """Each checked coordinate of side s moves one output variable
        that s alone reads (a remainder's columns past the filter's end)."""
        return all(not any(aff[2]) and sum(1 for c in aff[1] if c) <= 1
                   and not any(c and reads[1 - s][i] for i, c in enumerate(aff[1]))
                   for cs, _d, aff in checked if cs == s)

    b_sides = [s for s in (1, 0) if filter_side(s)]
    if not b_sides:
        return None, ("both inputs have coordinates that can leave their dimension along a "
                      "reduction variable or a variable the other input reads")
    # the filter: the side that reads one output variable (side 1 first)
    b = next((s for s in b_sides
              if sum(1 for i, e in enumerate(plan.out_ext) if e > 1 and reads[s][i]) == 1),
             b_sides[0])
    a = 1 - b
    n_vars = [i for i, e in enumerate(plan.out_ext) if e > 1 and reads[b][i]]
    if len(n_vars) != 1:
        return None, f"the filter side reads {len(n_vars)} output variables, not one (N)"
    n = n_vars[0]
    # the filter's columns: past a checked coordinate's end B reads 0
    nb = plan.out_ext[n]
    for cs, d, (c0, oc, _rc) in checked:
        if cs == b:
            if c0 < 0 or oc[n] <= 0:
                return None, "the filter's checked coordinate starts below 0 or runs backwards"
            nb = min(nb, max(0, -(-(plan.ins[b].shape[d] - c0) // oc[n])))
    # a constraint over N alone ends the columns too (a remainder's mask)
    for c0, oc, rc in plan.constraints:
        if not oc[n]:
            continue
        if any(rc) or any(x for i, x in enumerate(oc) if i != n):
            return None, f"a constraint moves the N variable {plan.out_vars[n]} and another"
        if oc[n] > 0 and c0 < 0:
            return None, f"a constraint starts the N variable {plan.out_vars[n]} above 0"
        if oc[n] < 0:
            nb = min(nb, max(0, c0 // -oc[n] + 1))
    if nb == 0:
        return None, "the filter has no column inside its dimension or constraints"
    m_vars = [i for i, e in enumerate(plan.out_ext) if e > 1 and reads[a][i]]
    if any(plan.out_dim[i] == plan.out_dim[n] for i in m_vars):
        return None, "an M variable and the N variable address the same output dim"
    size = _SIZE[ta]
    kc, c_var = plan.red_ext[0], plan.red_vars[0]
    if q[a][2][0] != 1:
        return None, f"the inner reduction variable {c_var} has stride {q[a][2][0]} in the input, not 1"
    if (kc * size) % 16:
        return None, (f"the inner reduction variable {c_var} spans {kc * size} bytes of an input "
                      "row, not whole 16-byte copies")
    if not aligned[a] or any((x * size) % 16 for x in (q[a][0],) + q[a][1] + q[a][2][1:]):
        return None, "the input's gathered rows do not start on 16-byte boundaries"
    n_taps = math.prod(plan.red_ext[1:])
    if n_taps > IG_MAXT:
        return None, f"{n_taps} taps exceed the {IG_MAXT} bits of a row's mask"
    m_vars.sort(key=lambda i: plan.out_coef[i] * _row_strides(plan.out_shape)[plan.out_dim[i]])
    taps = sorted(range(1, len(plan.red_vars)), key=lambda j: abs(q[b][2][j]))
    # B in place: K one stride (c, then each tap at the stride the last one ends)
    s_n, s_k = q[b][1][n], q[b][2][0]
    step, uniform = s_k * kc, True
    for j in taps:
        uniform &= q[b][2][j] == step or plan.red_ext[j] == 1
        step *= plan.red_ext[j]
    M = math.prod(plan.out_ext[i] for i in m_vars)
    N = plan.out_ext[n]
    K = kc * math.prod(plan.red_ext[1:])
    in_place = uniform and aligned[b] and (q[b][0] * size) % 16 == 0
    if ta == "float32":
        mma, bk, stages = "ffma", IG_ROW // 4, 3
        if in_place and s_n == 1 and (s_k * 4) % 16 == 0:
            load, base, sk, sn = "cp.async16", q[b][0], s_k, 1
        else:
            load, base, sk, sn = "pack+cp.async16", 0, -(-N // 4) * 4, 1
    else:
        mma, bk, stages = "wgmma", IG_ROW // size, 4
        if in_place and s_n == 1 and size == 2 and (s_k * 2) % 16 == 0:
            load, base, sk, sn = "tma-mn", q[b][0], s_k, 1
        elif in_place and s_k == 1 and (s_n * size) % 16 == 0:
            load, base, sk, sn = "tma", q[b][0], 1, s_n
        else:
            load, base, sk, sn = "pack+tma", 0, 1, -(-K // bk) * bk
    # K split over CTAs where the tiles alone would leave most SMs idle (a
    # CTA is latency-bound: its time grows with its stages), each split at
    # least 2 stages
    tiles = -(-M // IG_BM) * -(-N // IG_BN)
    nk = -(-K // bk)
    splits = 1 if tiles >= SM_COUNT else max(1, min(2 * SM_COUNT // tiles, nk // 2))
    per = -(-nk // splits)
    return ConvView(mma=mma, a=a, m_vars=tuple(m_vars), n=n, taps=tuple(taps), M=M, N=N, nb=nb,
                    K=K, kc=kc, b_load=load, b_base=base, b_sk=sk, b_sn=sn,
                    tile=(IG_BM, IG_BN, bk), stages=stages, splits=-(-nk // per),
                    k_split=per * bk), None


def igemm_tables(plan: WinPlan, view: ConvView,
                 clip: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the igemm kernel gathers by, computed once per plan and clip
    (int64, on the CPU): ``rows`` [3, M] holds for each row m of the
    implicit GEMM its input offset at (tap 0, c 0), its output offset at
    column 0 (-1 where the row lies outside the clip), and the bitmask of
    the taps where every checked coordinate of the input lies inside its
    dimension and every constraint is live; ``taps`` [K / kc] holds each
    tap's offset in the input; ``b_rows`` [K] the filter's offset at
    (k, n = 0).  Element (m, k = c + kc * t) of A is then
    ``input[rows[0, m] + taps[t] + c]`` where bit t of ``rows[2, m]`` is
    set, else 0, and B[k, n] is ``filter[b_rows[k] + n * stride]`` for n
    below ``view.nb``, else 0."""
    q = _tracked(plan)
    a, n_slot = view.a, len(plan.ins)
    checked = plan.checked()
    m = torch.arange(view.M, dtype=torch.int64)
    vals = {}
    for i in view.m_vars:
        vals[i] = m % plan.out_ext[i]
        m = m // plan.out_ext[i]
    n_taps = view.K // view.kc
    t = torch.arange(n_taps, dtype=torch.int64)
    tvals = {}
    for j in view.taps:
        tvals[j] = t % plan.red_ext[j]
        t = t // plan.red_ext[j]

    def over_rows(const, oc):
        return const + sum(oc[i] * v for i, v in vals.items())

    def over_taps(rc):
        return sum((rc[j] * v for j, v in tvals.items()), torch.zeros(n_taps, dtype=torch.int64))

    rows_off = over_rows(q[a][0], q[a][1]) + torch.zeros(view.M, dtype=torch.int64)
    live = torch.ones(view.M, n_taps, dtype=torch.bool)
    for k, (const, oc, rc) in enumerate(q[n_slot:]):
        g = over_rows(const, oc)[:, None] + over_taps(rc)[None, :]
        live &= g >= 0
        if k < len(checked):
            s, d, _a = checked[k]
            live &= g < plan.ins[s].shape[d]
    mask = torch.zeros(view.M, dtype=torch.int64)
    for j in range(n_taps):
        mask |= live[:, j].to(torch.int64) << j
    rstr = _row_strides(clip)
    out_off = torch.zeros(view.M, dtype=torch.int64)
    inside = torch.ones(view.M, dtype=torch.bool)
    for d in range(len(clip)):
        coord = torch.zeros(view.M, dtype=torch.int64)
        for i, v in vals.items():
            if plan.out_dim[i] == d:
                coord = coord + plan.out_coef[i] * v
                out_off = out_off + plan.out_coef[i] * rstr[d] * v
        if d != plan.out_dim[view.n]:
            inside &= coord < clip[d]
    out_off = torch.where(inside, out_off, torch.full_like(out_off, -1))
    b = 1 - a
    c = torch.arange(view.K, dtype=torch.int64) % view.kc
    b_rows = q[b][0] + q[b][2][0] * c + over_taps(q[b][2]).repeat_interleave(view.kc)
    return torch.stack([rows_off, out_off, mask]), over_taps(q[a][2]), b_rows


def conv_view(plan: WinPlan, aligned: Tuple[bool, bool] = (True, True)) -> Optional[ConvView]:
    """The plan as one implicit GEMM, or None: then :func:`refusal` gives
    the reason and the kernel runs its general loop.  ``aligned``: whether
    the two input tensors start at 16-byte boundaries (the launch knows)."""
    return _classify(plan, aligned)[0]


def refusal(plan: WinPlan, aligned: Tuple[bool, bool] = (True, True)) -> Optional[str]:
    """Why :func:`conv_view` refuses ``plan`` (None when it accepts it)."""
    return _classify(plan, aligned)[1]


def plan_path(plan: WinPlan, aligned: Tuple[bool, bool] = (True, True)) -> str:
    """The path a launch of ``plan`` takes: "igemm" or "general"."""
    return "general" if conv_view(plan, aligned) is None else "igemm"


def input_alignment(ins: Sequence[torch.Tensor]) -> Tuple[bool, bool]:
    """The ``aligned`` argument of :func:`conv_view` for a launch on
    ``ins``: whether its first two inputs start at 16-byte boundaries.  A
    non-contiguous input counts as aligned: the launch copies it to a new
    allocation first."""
    return tuple(len(ins) > j and (not ins[j].is_contiguous() or ins[j].data_ptr() % 16 == 0)
                 for j in (0, 1))


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
            offset = t.storage_offset()  # an input may be a view into a larger tensor
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


class _IgParams(ctypes.Structure):
    """The igemm path's launch record (csrc/windowed.cu: IgParams)."""

    _fields_ = [
        ("out", ctypes.c_void_p),
        ("a", ctypes.c_void_p),
        ("b", ctypes.c_void_p),
        ("b_src", ctypes.c_void_p),
        ("work", ctypes.c_void_p),
        ("rows", ctypes.c_void_p),
        ("taps", ctypes.c_void_p),
        ("b_rows", ctypes.c_void_p),
        ("parts", ctypes.c_longlong),
        ("bsk", ctypes.c_longlong),
        ("bsn", ctypes.c_longlong),
        ("b_src_sn", ctypes.c_longlong),
        ("out_sn", ctypes.c_longlong),
        ("scale", ctypes.c_double),
        ("M", ctypes.c_int),
        ("N", ctypes.c_int),
        ("nb", ctypes.c_int),
        ("K", ctypes.c_int),
        ("kc", ctypes.c_int),
        ("kp", ctypes.c_int),
        ("nlim", ctypes.c_int),
        ("splits", ctypes.c_int),
        ("ksplit", ctypes.c_int),
        ("out_dt", ctypes.c_int),
        ("dt", ctypes.c_int),
        ("is_int", ctypes.c_int),
        ("bkmaj", ctypes.c_int),
        ("bpack", ctypes.c_int),
        ("mma", ctypes.c_int),
    ]


def _bind(lib: ctypes.CDLL) -> None:
    lib.stripe_windowed_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    lib.stripe_windowed_launch.restype = ctypes.c_int
    lib.stripe_windowed_igemm.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.stripe_windowed_igemm.restype = ctypes.c_int
    for fn in (lib.stripe_windowed_layout, lib.stripe_windowed_ig_layout):
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = None
    _build.check_layout(lib.stripe_windowed_layout,
                        (ctypes.sizeof(_WinParams), _WinParams.qr.offset,
                         _WinParams.scale.offset, _WinParams.chk_hi.offset,
                         _WinParams.out_rank.offset, _WinParams.rhs.offset))
    _build.check_layout(lib.stripe_windowed_ig_layout,
                        (ctypes.sizeof(_IgParams), _IgParams.parts.offset,
                         _IgParams.scale.offset, _IgParams.M.offset,
                         _IgParams.out_dt.offset, _IgParams.mma.offset))


def load_library() -> ctypes.CDLL:
    return _build.load("windowed", _bind)


def _ig_params(plan: WinPlan, view: ConvView, clip: Tuple[int, ...]) -> _IgParams:
    """The igemm launch record of ``plan`` for one clip, pointers left 0."""
    key = ("igemm", clip, view)
    hit = plan._cparams.get(key)
    if hit is not None:
        return hit
    q = _tracked(plan)
    d, coef = plan.out_dim[view.n], plan.out_coef[view.n]
    p = _IgParams()
    p.parts = view.work(plan.ins[0].dtype)[1]
    p.bsk, p.bsn = view.b_sk, view.b_sn
    p.b_src_sn = q[1 - view.a][1][view.n]
    p.out_sn = coef * _row_strides(clip)[d]
    p.scale = plan.scale
    p.M, p.N, p.nb, p.K, p.kc = view.M, view.N, view.nb, view.K, view.kc
    p.kp = view.k_padded()
    p.nlim = min(view.N, -(-clip[d] // coef))  # N alone addresses its output dim
    p.splits, p.ksplit = view.splits, view.k_split
    p.out_dt = _build.dtype_code(plan.out_dtype)
    p.dt = _build.dtype_code(plan.ins[0].dtype)
    p.is_int = int(plan.acc == "int32")
    p.bkmaj, p.bpack = int(view.b_sk == 1), int(view.packed)
    p.mma = int(view.mma == "wgmma")
    plan._cparams[key] = p
    return p


def _params(plan: WinPlan, clip: Tuple[int, ...]) -> _WinParams:
    """The general loop's launch parameters of ``plan`` for one clip,
    pointers left 0."""
    hit = plan._cparams.get(clip)
    if hit is not None:
        return hit
    p = _WinParams()
    n_o, n_r = len(plan.out_vars), len(plan.red_vars)
    for s, inp in enumerate(plan.ins):
        p.slot_dt[s] = _build.dtype_code(inp.dtype)
    checked = plan.checked()
    for c, (s, d, _a) in enumerate(checked):
        p.chk_slot[c] = s
        p.chk_hi[c] = plan.ins[s].shape[d]
    for k, (const, oc, rc) in enumerate(_tracked(plan)):
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


def _device_tables(plan: WinPlan, view: ConvView, clip: Tuple[int, ...], device):
    """:func:`igemm_tables` on the card, built once per plan, clip and
    device."""
    key = ("tables", clip, view, str(device))
    hit = plan._cparams.get(key)
    if hit is None:
        hit = plan._cparams[key] = tuple(
            t.to(device).contiguous() for t in igemm_tables(plan, view, clip))
    return hit


def windowed(plan: WinPlan, ins: Sequence[torch.Tensor],
             clip: Optional[Tuple[int, ...]] = None,
             path: Optional[str] = None) -> torch.Tensor:
    """Run one windowed unit: the kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns the output region cut to ``clip``.

    ``path``: None takes the conv view's choice (``igemm``, or the general
    loop where the view refuses the plan); ``"general"`` forces the
    general loop, to time it against the igemm path on the same unit."""
    global launches
    from ..core.lower_torch import torch_dtype

    if path not in (None, "general"):
        raise ValueError(f"path is None (the view's choice) or 'general', not {path!r}")
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
    view = None if path == "general" else conv_view(plan, input_alignment(ins))
    out = torch.empty(clip, dtype=torch_dtype(plan.out_dtype), device=device)
    if out.numel() == 0:
        return out
    stream = _build.stream_of(device)
    if view is None:
        p = _params(plan, clip)
        p.out = out.data_ptr()
        for s, t in enumerate(ins):
            p.slot[s] = t.data_ptr()
        rc = lib.stripe_windowed_launch(ctypes.addressof(p),
                                        _build.grid_stride_blocks(plan.output_points()),
                                        _build.BLOCK, stream)
    else:
        p = _ig_params(plan, view, clip)
        rows, taps, b_rows = _device_tables(plan, view, clip, device)
        nbytes = view.work(plan.ins[0].dtype)[0]
        work = torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes else None
        a, b = ins[view.a], ins[1 - view.a]
        p.out, p.a, p.b_src = out.data_ptr(), a.data_ptr(), b.data_ptr()
        p.work = work.data_ptr() if work is not None else None
        p.b = p.work if view.packed else b.data_ptr() + view.b_base * b.element_size()
        p.rows, p.taps, p.b_rows = rows.data_ptr(), taps.data_ptr(), b_rows.data_ptr()
        rc = lib.stripe_windowed_igemm(ctypes.addressof(p), view.blocks(), stream)
    _build.launch_rc(rc, "windowed")
    launches += 1
    launches_by_path["general" if view is None else "igemm"] += 1
    return out
