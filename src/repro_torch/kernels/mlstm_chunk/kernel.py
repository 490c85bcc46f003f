"""Chunkwise gated linear attention: the CUDA kernel's binding, its launch
counter, its plain PyTorch version, and the chunk length the autotiler
chooses.

``csrc/gla.cu`` replaces the TPU kernel
``src/repro/kernels/mlstm_chunk/kernel.py::chunked_gla``: the linear
recurrence

    C_t = decay_t * C_{t-1} + gain_t * k_t v_t^T          (Dk x Dv state)
    n_t = decay_t * n_{t-1} + gain_t * k_t                (normalizer, optional)
    h_t = q_t @ C_t [/ max(|q_t . n_t|, 1)]

evaluated chunk by chunk, decays in log space.  Three paths, picked by
:func:`path_of` before the launch: ``wgmma`` (bf16 on the tensor cores: a
state kernel that writes the state before every chunk, then a
chunk-parallel output kernel), ``tf32x3`` (float32 in the same two
kernels, every product as three tf32 products, which keeps float32's
accuracy) and ``cuda_cores`` (one CTA per (b*h, 64 columns of Dv) looping
over the chunks, float32 arithmetic throughout); the source says how the
work is laid out.

:func:`chunked_gla` launches the kernel for CUDA tensors (raising on any
failure) and runs its plain version, ``nn.scan_ops.chunked_gla_torch``,
only for CPU tensors.
``launches`` counts entry calls that launched, ``launches_by_path`` the
same calls by path.  ``mlstm_chunk`` (and ``ssd_chunk.ssd_chunk``) only
transform their gates and call it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build
from ...core.hwconfig import get_config
from ...nn.scan_ops import chunked_gla_torch

# Kernel launches since import (or since the caller last reset it), and
# the same launches by path.
launches = 0
PATHS = ("wgmma", "tf32x3", "cuda_cores")
launches_by_path = {p: 0 for p in PATHS}

# The CUDA-core kernel's geometry (csrc/gla.cu): Dv columns per CTA, the
# score tile, the depth of a staged slab and the staging row stride.
TV, TILE, KD, LD = 64, 64, 32, 68
# The wgmma path's: rows of a tile (one warpgroup's m64; the chunk is a
# multiple), the ring's depth and the bytes of one 64 x 64 bf16 box.
WGMMA_ROWS, WGMMA_STAGES, WGMMA_BOX = 64, 3, 8192
# The tf32x3 path's: the output kernel's ring depth and the bytes of one
# box of 64 rows of 32 float32 (a q or k box; C_prev^T and v^T come in
# boxes of NV rows of 32).
TF32_STAGES, TF32_BOX = 3, 8192
_TYPES = (torch.float32, torch.bfloat16)
_SMEM_LIMIT = get_config("h100").mem("SMEM").size_bytes  # what one H100 block may use
# CUDA's limit on grid x, where every kernel of both paths puts b*h
GRID_X = 2**31 - 1


def smem_bytes(dk: int, chunk: int) -> int:
    """Shared memory of one CTA (``gla_smem_floats`` in the source): the
    Dk x 64 state slice, n, four chunk-long vectors, q . n of a row tile,
    and two staging tiles."""
    return 4 * (dk * TV + ((dk + 3) & ~3) + 4 * chunk + TILE + 2 * TILE * LD)


def wgmma_smem_bytes(dk: int, dv: int, chunk: int) -> tuple:
    """Shared memory of the wgmma path's state and output kernels
    (``gw_state_smem``, ``gw_out_smem`` in the source), 1024 bytes of each
    for the swizzle's alignment.  State: a ring of (a 64-step k box and
    NV / 64 v boxes), NV = 64 where Dv <= 64 else 128, then w and g of
    the chunk, the normalizer's partials and the barriers.  Output: the q
    tile (Dk in 64-wide boxes), a ring of NV / 64 boxes, cum and g of the
    chunk, q . n_prev of the rows, n_prev, the barriers."""
    vb = 1 if dv <= 64 else 2
    state = (1024 + WGMMA_STAGES * (1 + vb) * WGMMA_BOX + 4 * (2 * chunk + 4 * 64 + 4)
             + 8 * WGMMA_STAGES)
    out = (1024 + -(-dk // 64) * WGMMA_BOX + WGMMA_STAGES * vb * WGMMA_BOX
           + 4 * (2 * chunk + 64 + dk) + 8 * (WGMMA_STAGES + 1))
    return state, out


def tf32x3_smem_bytes(dk: int, dv: int, chunk: int) -> tuple:
    """Shared memory of the tf32x3 path's state and output kernels
    (``gt_state_smem``, ``gt_out_smem`` in the source), 1024 bytes of each
    for the swizzle's alignment; NV = 64 where Dv <= 64 else 128.  State: a
    ring (3 stages at NV 64, else 2) of (two 32 x 32 k boxes, 4096 bytes
    each, and v^T hi and lo, NV rows of 128 bytes each), then the chunk's
    cum (float64), w and g, the total (float64), the barriers.  Output:
    the q tile (Dk in boxes of 32), a ring of (a box of NV rows of 128
    bytes and its lo), cum (float64) and g of the chunk, q . n_prev of the
    rows, n_prev, the barriers."""
    nv = 64 if dv <= 64 else 128
    stages = 3 if nv == 64 else 2
    state = 1024 + stages * (TF32_BOX + 256 * nv) + 16 * chunk + 8 + 8 * stages
    out = (1024 + -(-dk // 32) * TF32_BOX + TF32_STAGES * 256 * nv + 12 * chunk
           + 4 * (64 + dk) + 8 * (TF32_STAGES + 1))
    return state, out


def path_of(dtype: torch.dtype, dk: int, dv: int, chunk: int, aligned: bool = True) -> str:
    """The path a call takes, decided before the launch, where q, k and v
    lie at 16-byte boundaries (TMA reads them) and the chunk is a multiple
    of 64 (the output kernels' row tiles): ``wgmma`` for bf16 where Dk and
    Dv are multiples of 16 (wgmma's k16), ``tf32x3`` for float32 where they
    are multiples of 8 (k8); ``cuda_cores`` for anything else (float16,
    float32 at a chunk of 16 or 32 or at Dk 4)."""
    if aligned and chunk % WGMMA_ROWS == 0:
        if dtype == torch.bfloat16 and dk % 16 == 0 and dv % 16 == 0:
            return "wgmma"
        if dtype == torch.float32 and dk % 8 == 0 and dv % 8 == 0:
            return "tf32x3"
    return "cuda_cores"


# The wgmma path against the plain version (float32 throughout), element
# by element.  bf16 keeps 8 significant bits, so one rounding moves a value
# by at most 2**-8 of itself.  The path rounds four things: P before P V
# (each intra-chunk term P_ts v_s moves by 2**-8 of |P_ts| |v_s|); k w
# before (k w)^T v, whose errors the carried state sums (C_prev moves by
# 2**-8 of the same state built from |k|, |w|, |v|); C_prev itself once
# more (2**-8 of |C_prev|); and the output once, as the plain version
# does (one bf16 step, 2**-7 of |out|).  The first three reach the output
# through the normalizer's denominator max(|norm|, 1), which both compute
# in float32.
BF16_STEP = 2.0 ** -7


def gla_wgmma_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_decay: torch.Tensor, gain: torch.Tensor, want: torch.Tensor,
                    chunk: int, normalize: bool = True, scale: float = 1.0) -> torch.Tensor:
    """The largest difference, element by element, that the wgmma path may
    show against ``want`` = the plain version on the same inputs:

        2**-7 |want| + 2**-8 (intra + (2 + 2**-8) inter) / den

    in float32, where intra + inter is the plain version (unnormalized) on
    |q|, |k|, |v|, |gain| and |scale|, intra its part from within each
    chunk (the same call with every chunk a head of its own, so no state
    crosses a chunk) and inter the rest, the state's; den is 1, or under
    ``normalize`` max(|norm|, 1), norm being the plain version's
    unnormalized output for v = 1 (the state then is n)."""
    b, h, s = q.shape[:3]
    qf, kf, vf = q.float(), k.float(), v.float()
    ld, g = log_decay.float(), gain.float()

    def per_chunk(x):
        return x.reshape(b, h * (s // chunk), chunk, *x.shape[3:])

    absd = (qf.abs(), kf.abs(), vf.abs(), ld, g.abs())
    full = chunked_gla_torch(*absd, chunk=chunk, normalize=False, scale=abs(scale))
    intra = chunked_gla_torch(*map(per_chunk, absd), chunk=chunk, normalize=False,
                              scale=abs(scale)).reshape(full.shape)
    inter = (full - intra).clamp(min=0.0)
    moved = BF16_STEP / 2 * (intra + (2 + BF16_STEP / 2) * inter)
    if normalize:
        norm = chunked_gla_torch(qf, kf, torch.ones_like(vf[..., :1]), ld, g, chunk=chunk,
                                 normalize=False, scale=scale)
        moved = moved / norm.abs().clamp(min=1.0)
    return BF16_STEP * want.float().abs() + moved


# The tf32x3 path against the plain version, element by element.  Every
# product a b is computed as a_hi b_hi + a_hi b_lo + a_lo b_hi, where hi
# is a with its low 13 mantissa bits cleared (exact: a tf32 value) and lo
# = a - hi, |lo| < 2**-10 |a|, whose own low bits the tensor cores drop
# (the H100 truncates them, by at most 2**-10 of |lo|: tests/
# test_torch_cuda.py shows it): the dropped a_lo b_lo and the two lo
# operands move the product by at most 3 * 2**-20 |a| |b|.  The products: (k w)^T v into the state, q
# C_prev (C_prev carries the first's error, stored exactly as hi + lo), q
# k^T into the scores (P moves by the same fraction of the same product
# on |q|, |k|) and P V.  So the unnormalized output moves by at most 2 *
# 3 * 2**-20 of the plain version on |q|, |k|, |v|, |gain| (each part,
# inter and intra, meets two products: its own and the one before it).
# Under ``normalize`` the row sums of P move by 3 * 2**-20 of the same
# sums on |q|, |k|, and the denominator max(|norm|, 1) with them.
TF32X3_EPS = 3 * 2.0 ** -20
# the float32 accumulation's own error, in multiples of the plain float32
# version's against the same computation in float64
TF32X3_ACC = 4.0


def gla_tf32x3_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_decay: torch.Tensor, gain: torch.Tensor, want: torch.Tensor,
                     chunk: int, normalize: bool = True, scale: float = 1.0) -> torch.Tensor:
    """The largest difference, element by element, that the tf32x3 path
    may show against ``want`` (the plain version's float32 output on the
    same inputs, or the reference's):

        (2 eps full + eps |exact| nsum) / den + |want - exact|
            + 4 |plain - exact|

    in float64, eps = 3 * 2**-20, where ``exact`` is the plain version in
    float64 and ``plain`` in float32; full is the plain version
    (unnormalized, float64) on |q|, |k|, |v|, |gain| and |scale|, nsum the
    same for v = 1; den is 1, or under ``normalize`` max(|norm|, 1), norm
    being the unnormalized output for v = 1 (the state then is n).  The
    first term is the split's (the module's note above); |want - exact|
    is the reference's own error, exactly; the last stands for the path's
    float32 accumulation, whose order differs from the plain version's
    and whose error is of the same kind.  Plain TF32, the lo terms
    dropped, moves a product by up to 2**-10 of |a| |b| and exceeds it."""
    d = torch.float64
    qd, kd, vd, ld, gd = (t.to(d) for t in (q, k, v, log_decay, gain))

    def gla(q_, k_, v_, ld_, g_, norm=False, sc=scale):
        return chunked_gla_torch(q_, k_, v_, ld_, g_, chunk=chunk, normalize=norm, scale=sc)

    exact = gla(qd, kd, vd, ld, gd, normalize)
    plain = gla(*(t.float() for t in (q, k, v, log_decay, gain)), normalize).to(d)
    moved = 2 * TF32X3_EPS * gla(qd.abs(), kd.abs(), vd.abs(), ld, gd.abs(), sc=abs(scale))
    if normalize:
        ones = torch.ones_like(vd[..., :1])
        nsum = gla(qd.abs(), kd.abs(), ones, ld, gd.abs(), sc=abs(scale))
        den = gla(qd, kd, ones, ld, gd).abs().clamp(min=1.0)
        moved = (moved + TF32X3_EPS * exact.abs() * nsum) / den
    return moved + (want.to(d) - exact).abs() + TF32X3_ACC * (plain - exact).abs()


# ------------------------------------------------------------ chunk length
_PARAMS = {"cost": "roofline", "search": "pow2", "mem_cap_frac": 0.1}


def search_chunk(seq: int, dk: int, dv: int, hw) -> int:
    """The reference's search (``kernel.py:32-57``) under ``hw``: the
    autotiler's ``t`` tile of the intra-chunk contraction H[t,p] +=
    S[t,s] * V[s,p], at most 256, halved until it divides ``seq``.  Not
    memoized."""
    from ...core.frontend import single_op_program
    from ...core.passes.autotile import choose_tiling

    prog = single_op_program(
        "H[t, p] += S[t, s] * V[s, p]",
        {"S": ((seq, seq), "float32"), "V": ((seq, dv), "float32"),
         "H": ((seq, dv), "float32")},
        out="H",
    )
    tiles, _ = choose_tiling(prog.entry.stmts[0], hw, _PARAMS)
    c = min(tiles.get("t", 256), 256)
    while seq % c != 0:
        c //= 2
    return max(c, 1)


def choose_chunk(seq: int, dk: int, dv: int) -> int:
    """The chunk length for the kernel: :func:`search_chunk` under the
    ``h100`` config, memoized through the compilation cache.  The kernel
    takes the L x L scores in 64 x 64 tiles, so no cap beyond the
    reference's 256 is needed."""
    from ...core import cache as stripe_cache

    hw = get_config("h100")
    memo_version = 1  # bump when the clamp logic changes
    return int(stripe_cache.memoize(
        "mlstm_chunk_len",
        [memo_version, seq, dk, dv, sorted(_PARAMS.items()), hw.fingerprint()],
        lambda: search_chunk(seq, dk, dv, hw)))


def _resolve(q, k, v, log_decay, gain, chunk) -> int:
    """Shapes, and the reference's chunk handling (``kernel.py:121-126``),
    its assert as ``ValueError``."""
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"chunked_gla: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; want (B, H, S, Dk) twice and (B, H, S, Dv)")
    if log_decay.shape != q.shape[:3] or gain.shape != q.shape[:3]:
        raise ValueError(f"chunked_gla: log_decay {tuple(log_decay.shape)}, gain "
                         f"{tuple(gain.shape)}; want {tuple(q.shape[:3])}")
    s, dk, dv = q.shape[2], q.shape[3], v.shape[3]
    if chunk is None:
        chunk = choose_chunk(s, dk, dv)
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunked_gla: chunk {chunk} does not divide S = {s}")
    return chunk


# ---------------------------------------------------------- C binding
class _GlaParams(ctypes.Structure):
    _fields_ = [
        ("q", ctypes.c_void_p),
        ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("ld", ctypes.c_void_p),
        ("g", ctypes.c_void_p),
        ("o", ctypes.c_void_p),
        ("s", ctypes.c_int),
        ("dk", ctypes.c_int),
        ("dv", ctypes.c_int),
        ("chunk", ctypes.c_int),
        ("qkv_dt", ctypes.c_int),
        ("ld_dt", ctypes.c_int),
        ("g_dt", ctypes.c_int),
        ("out_dt", ctypes.c_int),
        ("normalize", ctypes.c_int),
        ("scale", ctypes.c_float),
    ]


class _GlaState3(ctypes.Structure):
    """The tf32x3 path's scratch (``GlaState3`` in the source)."""
    _fields_ = [(name, ctypes.c_void_p) for name in ("c_hi", "c_lo", "n", "vt_hi", "vt_lo")]


def _bind(lib: ctypes.CDLL) -> None:
    lib.stripe_gla_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.stripe_gla_launch.restype = ctypes.c_int
    lib.stripe_gla_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.stripe_gla_smem.restype = ctypes.c_int
    lib.stripe_gla_layout.argtypes = [ctypes.c_void_p]
    lib.stripe_gla_layout.restype = None
    lib.stripe_gla_wgmma.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.stripe_gla_wgmma.restype = ctypes.c_int
    lib.stripe_gla_wgmma_smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p]
    lib.stripe_gla_wgmma_smem.restype = None
    lib.stripe_gla_tf32x3.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.stripe_gla_tf32x3.restype = ctypes.c_int
    lib.stripe_gla_tf32x3_smem.argtypes = lib.stripe_gla_wgmma_smem.argtypes
    lib.stripe_gla_tf32x3_smem.restype = None
    _build.check_layout(lib.stripe_gla_layout,
                        (ctypes.sizeof(_GlaParams), _GlaParams.s.offset,
                         _GlaParams.qkv_dt.offset, _GlaParams.normalize.offset,
                         _GlaParams.scale.offset))
    for dk, chunk in ((8, 16), (64, 256), (384, 256)):
        if lib.stripe_gla_smem(dk, chunk) != smem_bytes(dk, chunk):
            raise _build.KernelBuildError(
                f"gla shared memory: C {lib.stripe_gla_smem(dk, chunk)} B, Python "
                f"{smem_bytes(dk, chunk)} B (Dk {dk}, chunk {chunk})")
    for dk, dv, chunk in ((16, 16, 64), (64, 64, 256), (384, 384, 256), (128, 80, 128),
                          (40, 96, 128)):
        for fn, py in ((lib.stripe_gla_wgmma_smem, wgmma_smem_bytes),
                       (lib.stripe_gla_tf32x3_smem, tf32x3_smem_bytes)):
            got = (ctypes.c_longlong * 2)()
            fn(dk, dv, chunk, ctypes.addressof(got))
            if tuple(got) != py(dk, dv, chunk):
                raise _build.KernelBuildError(
                    f"gla {fn.__name__}: C {tuple(got)} B, Python {py(dk, dv, chunk)} B "
                    f"(Dk {dk}, Dv {dv}, chunk {chunk})")


def load_library() -> ctypes.CDLL:
    return _build.load("gla", _bind)


def _launch(q, k, v, log_decay, gain, chunk: int, normalize: bool, scale: float,
            path: Optional[str]) -> torch.Tensor:
    global launches
    device = q.device
    for name, t in (("k", k), ("v", v), ("log_decay", log_decay), ("gain", gain)):
        if not t.is_cuda or t.device != device:
            raise ValueError(f"chunked_gla: {name} is on {t.device}, q on {device}")
        if t.dtype not in _TYPES:
            raise TypeError(f"chunked_gla: {name} is {t.dtype}; the kernel takes {_TYPES}")
    if q.dtype not in _TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"chunked_gla: q, k, v are {q.dtype}, {k.dtype}, {v.dtype}; the "
                        f"kernel takes one of {_TYPES} for all three")
    b, h, s, dk = q.shape
    dv = v.shape[3]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    log_decay, gain = log_decay.contiguous(), gain.contiguous()
    if path is None:
        path = path_of(q.dtype, dk, dv, chunk, all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    if path == "wgmma":
        need = max(wgmma_smem_bytes(dk, dv, chunk))
        # the CTAs of the state kernel (b*h, 64 rows of Dk, 128 columns of
        # Dv) and of the output kernel (b*h, chunk, 64-row tile, the same)
        ctas = b * h * max(s // WGMMA_ROWS, -(-dk // 64)) * -(-dv // 128)
    elif path == "tf32x3":
        need = max(tf32x3_smem_bytes(dk, dv, chunk))
        # the same two kernels, and v's transposed copy (b*h, 32 steps)
        ctas = b * h * max(max(s // WGMMA_ROWS, -(-dk // 64)) * -(-dv // 128), s // 32)
    else:
        need = smem_bytes(dk, chunk)
        ctas = b * h * -(-dv // TV)
    if need > _SMEM_LIMIT:
        raise ValueError(f"chunked_gla ({path}): Dk {dk}, Dv {dv} at chunk {chunk} needs {need} B "
                         f"of shared memory, over one block's {_SMEM_LIMIT}")
    if ctas > GRID_X:
        raise ValueError(f"chunked_gla ({path}): {ctas} CTAs exceed the grid's x limit {GRID_X}")
    out = torch.empty((b, h, s, dv), dtype=q.dtype, device=device)
    if out.numel() == 0:
        return out
    lib = load_library()
    p = _GlaParams(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), ld=log_decay.data_ptr(),
                   g=gain.data_ptr(), o=out.data_ptr(), s=s, dk=dk, dv=dv, chunk=chunk,
                   qkv_dt=_build.dtype_code(q.dtype), ld_dt=_build.dtype_code(log_decay.dtype),
                   g_dt=_build.dtype_code(gain.dtype), out_dt=_build.dtype_code(q.dtype),
                   normalize=int(bool(normalize)), scale=scale)
    stream = _build.stream_of(device)
    if path == "wgmma":
        # the state before every chunk, which the state kernel writes and
        # the output kernel reads: C_prev in bf16, n_prev in float32
        n_rows = b * h * (s // chunk)
        c_prev = torch.empty((n_rows, dk, dv), dtype=torch.bfloat16, device=device)
        n_prev = torch.empty((n_rows, dk), dtype=torch.float32, device=device)
        rc = lib.stripe_gla_wgmma(ctypes.addressof(p), c_prev.data_ptr(), n_prev.data_ptr(),
                                  b * h, stream)
    elif path == "tf32x3":
        # C_prev^T (transposed, split into hi and lo, float32 both) and
        # n_prev, which the state kernel writes and the output kernel
        # reads, and v^T split, which both read
        n_rows = b * h * (s // chunk)
        c_prev = torch.empty((2, n_rows, dv, dk), dtype=torch.float32, device=device)
        n_prev = torch.empty((n_rows, dk), dtype=torch.float32, device=device)
        vt = torch.empty((2, b * h, dv, s), dtype=torch.float32, device=device)
        st = _GlaState3(c_hi=c_prev[0].data_ptr(), c_lo=c_prev[1].data_ptr(),
                        n=n_prev.data_ptr(), vt_hi=vt[0].data_ptr(), vt_lo=vt[1].data_ptr())
        rc = lib.stripe_gla_tf32x3(ctypes.addressof(p), ctypes.addressof(st), b * h, stream)
    else:
        rc = lib.stripe_gla_launch(ctypes.addressof(p), b * h, stream)
    _build.launch_rc(rc, f"gla ({path})")
    launches += 1
    launches_by_path[path] += 1
    return out


def chunked_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor, gain: torch.Tensor,
                chunk: Optional[int] = None, normalize: bool = True,
                scale: float = 1.0, path: Optional[str] = None) -> torch.Tensor:
    """q/k: (B, H, S, Dk); v: (B, H, S, Dv); log_decay/gain: (B, H, S).
    Returns (B, H, S, Dv) in ``q.dtype``.  The kernel for CUDA tensors, the
    plain version for CPU tensors.

    ``path``: None takes :func:`path_of`'s choice; ``"cuda_cores"`` forces
    the CUDA-core kernel, to time it against the wgmma or tf32x3 path on
    the same inputs."""
    _build.refuse_autograd("chunked_gla", q, k, v, log_decay, gain)
    if path not in (None, "cuda_cores"):
        raise ValueError(f"path is None (the rule's choice) or 'cuda_cores', not {path!r}")
    chunk = _resolve(q, k, v, log_decay, gain, chunk)
    if q.is_cuda:
        return _launch(q, k, v, log_decay, gain, chunk, normalize, float(scale), path)
    if any(t.is_cuda for t in (k, v, log_decay, gain)):
        raise ValueError("chunked_gla: q on the CPU, another input on the card")
    return chunked_gla_torch(q, k, v, log_decay, gain, chunk=chunk, normalize=normalize,
                             scale=scale)


def mlstm_chunk(q, k, v, i_gate, f_gate, chunk: Optional[int] = None) -> torch.Tensor:
    """xLSTM mLSTM: decay = sigmoid(f), gain = exp(i) (i pre-clamped at 8),
    normalized output, q scaled by Dk^-1/2."""
    _build.refuse_autograd("mlstm_chunk", q, k, v, i_gate, f_gate)
    dk = q.shape[-1]
    log_decay = F.logsigmoid(f_gate)
    gain = torch.exp(torch.clamp(i_gate, max=8.0))
    return chunked_gla(q, k, v, log_decay, gain, chunk=chunk, normalize=True,
                       scale=float(dk) ** -0.5)
