"""Flash attention forward: the CUDA kernel's binding, its launch counter,
its plain PyTorch version, and the block sizes the autotiler chooses.

``csrc/flash_attention.cu`` replaces the TPU kernel
``src/repro/kernels/flash_attention/kernel.py::flash_attention``: GQA
attention, causal or full, with the online softmax (m, l, acc) in float32.
One CTA owns one (b*Hq head, q tile), the two flattened on grid x, and
loops over the kv tiles itself, up to the diagonal under ``causal``; the
source says how the work is laid out.  Three paths: ``wgmma`` (bf16 on
the tensor cores, P rounded to bf16 for P V), ``tf32x3`` (float32 on the
tensor cores, every product as three tf32 products, which keeps
float32's accuracy: a prep kernel splits k and transposes v first) and
``cuda_cores`` (float32 arithmetic throughout); :func:`path_of` is the
rule that picks one before the launch.

:func:`flash_attention` launches the kernel for CUDA tensors (raising on
any failure) and runs :func:`flash_attention_plain` only for CPU tensors.
``launches`` counts kernel launches, ``launches_by_path`` the same
launches by path.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import _build

NEG_INF = -1e30

# Kernel launches since import (or since the caller last reset it), and
# the same launches by path.
launches = 0
PATHS = ("wgmma", "tf32x3", "cuda_cores")
launches_by_path = {p: 0 for p in PATHS}

# The tensor-core kernels' head dims (boxes of 128 bytes) and the q rows of
# each of their CTA's two warpgroups.
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_ROWS = 64
# The tf32x3 kernel's keys a stage and the bytes of one 128-byte-wide row
# of a box; the registers a thread holds at launch (384 threads on the
# SM's 64K, in steps of 8), which its warpgroups trade with setmaxnreg:
# with fewer, the consumers' request would wait forever.
TF32_KEYS, BOX_ROW = 32, 128
TF32_LAUNCH_REGS = 65536 // 384 // 8 * 8

# The kernel's geometry (csrc/flash_attention.cu): 8 warps; each warp owns
# R rows of the q tile, R a power of two up to 16 (8 where the head dim
# needs more than 4 columns a lane); the head dim up to 256.
WARPS = 8
MAX_HEAD_DIM = 256
# CUDA's limit on grid x, where both kernels put b*Hq and the q tile
GRID_X = 2**31 - 1
_TYPES = (torch.float32, torch.bfloat16)


def _dpl(head_dim: int) -> int:
    """Head-dim columns per lane: ``head_dim`` rounded up to 32, 64, 128 or
    256, over 32."""
    return 1 << max(0, math.ceil(math.log2(-(-head_dim // 32))))


def _max_rows(head_dim: int) -> int:
    return 16 if _dpl(head_dim) <= 4 else 8


def max_block_q(head_dim: int) -> int:
    """The most query rows one CTA of the kernel holds at ``head_dim``."""
    return WARPS * _max_rows(head_dim)


def rows_per_warp(block_q: int) -> int:
    """R: the rows each of the 8 warps owns, a power of two."""
    return 1 << max(0, math.ceil(math.log2(-(-block_q // WARPS))))


def smem_bytes(block_q: int, head_dim: int) -> int:
    """Shared memory of one CTA (``fa_smem_floats`` in the source): the Q
    tile, a 32-key slab of K and of V, and each warp's probabilities."""
    dp = 32 * _dpl(head_dim)
    rows = WARPS * rows_per_warp(block_q)
    return 4 * (rows * (dp + 4) + 32 * (dp + 4) + 32 * dp + rows * 32)


def tf32x3_stages(head_dim: int) -> int:
    """The tf32x3 kernel's ring depth: 2 at head dim 128, 4 at 64."""
    return 4 if head_dim == 64 else 2


def tf32x3_smem_bytes(head_dim: int) -> int:
    """Shared memory of one CTA of the tf32x3 kernel (``ft_smem_bytes`` in
    the source): 1024 bytes of slack for the swizzle's alignment, the Q
    tile (128 rows of the head dim in 32-float boxes), a ring of stages of
    32 keys (K hi and lo, V^T hi and lo) and the barriers."""
    nb, stages = head_dim // 32, tf32x3_stages(head_dim)
    stage = 2 * nb * TF32_KEYS * BOX_ROW + 2 * head_dim * BOX_ROW
    return 1024 + nb * 2 * WGMMA_ROWS * BOX_ROW + stages * stage + 8 * (2 * stages + 1)


# ------------------------------------------------------------ block sizes
_PARAMS = {"cost": "roofline", "search": "pow2", "mem_cap_frac": 0.2, "count_untiled": True}


def _block_unit(hw):
    """The memory one kernel block works in: the unit the config's
    ``localize`` pass names (``SMEM`` under ``h100``, ``VMEM`` under
    ``tpu_v5e``)."""
    for name, params in hw.passes:
        if name == "localize" and "inner" in params:
            return hw.mem(params["inner"])
    return hw.inner_mem()


def search_params(hw) -> dict:
    """The reference's search parameters, capped by the per-block unit:
    ``mem_cap_frac`` is a fraction of the inner unit (L2 under ``h100``,
    VMEM under ``tpu_v5e``); where 0.2 of it exceeds the block unit, the
    fraction shrinks to the block unit's size.  Under ``tpu_v5e`` the block
    unit is the inner unit and the parameters are the reference's."""
    params = dict(_PARAMS)
    inner, block = hw.inner_mem(), _block_unit(hw)
    if block.size_bytes < params["mem_cap_frac"] * inner.size_bytes:
        params["mem_cap_frac"] = block.size_bytes / inner.size_bytes
    return params


def search_block_sizes(seq_q: int, seq_k: int, head_dim: int, hw) -> Tuple[int, int]:
    """The Stripe autotiler's (block_q, block_k) for the score contraction
    S[q,k] += Q[q,d] * K[k,d] under ``hw``, with :func:`search_params` and
    the reference's clamp (``kernel.py:52-53``).  Not memoized."""
    from ...core.frontend import single_op_program
    from ...core.passes.autotile import choose_tiling

    prog = single_op_program(
        "S[q, k] += Q[q, d] * K[k, d]",
        {"Q": ((seq_q, head_dim), "bfloat16"), "K": ((seq_k, head_dim), "bfloat16"),
         "S": ((seq_q, seq_k), "float32")},
        out="S",
    )
    tiles, _cost = choose_tiling(prog.entry.stmts[0], hw, search_params(hw))
    bq = max(min(tiles.get("q", 512), seq_q), min(128, seq_q))
    bk = max(min(tiles.get("k", 512), seq_k), min(128, seq_k))
    return bq, bk


def choose_block_sizes(seq_q: int, seq_k: int, head_dim: int) -> Tuple[int, int]:
    """(block_q, block_k) for the kernel, memoized through the compilation
    cache.

    The search runs under the ``h100`` config, capped twice so that the
    tile fits one CTA: the search's tile by the config's per-block ``SMEM``
    unit (227 KB; the reference's 0.2 of the inner unit would be 0.2 of the
    50 MB L2, which gives block_q = 4096 at (4096, 4096, 128)), and then
    ``block_q`` by the rows one CTA of the kernel holds
    (:func:`max_block_q`): where the search's block_q is larger, it becomes
    the largest divisor of ``seq_q`` within that limit."""
    from ...core import cache as stripe_cache
    from ...core.hwconfig import get_config

    hw = get_config("h100")
    memo_version = 1  # bump when the caps below change

    def search():
        bq, bk = search_block_sizes(seq_q, seq_k, head_dim, hw)
        cap = max_block_q(head_dim)
        if bq > cap:
            bq = max(d for d in range(1, cap + 1) if seq_q % d == 0)
        return [bq, bk]

    bq, bk = stripe_cache.memoize(
        "flash_attn_blocks",
        [memo_version, seq_q, seq_k, head_dim, sorted(search_params(hw).items()),
         hw.fingerprint()],
        search)
    return int(bq), int(bk)


def path_of(dtype: torch.dtype, head_dim: int, aligned: bool = True) -> str:
    """The kernel a call takes, decided before the launch, at head dim 64
    or 128 with q, k, v at 16-byte boundaries (TMA reads them): ``wgmma``
    for bf16, ``tf32x3`` for float32 (three tf32 products for each, which
    keeps float32's accuracy: :func:`flash_tf32x3_bound`); ``cuda_cores``
    for anything else (other head dims, misaligned operands).  The
    tensor-core kernels run their own tiles (128 q rows by 64 keys, or 32
    in float32) whatever the blocks; their result does not depend on them
    (a kv block past a row's diagonal adds exactly 0)."""
    if head_dim in WGMMA_HEAD_DIMS and aligned:
        if dtype == torch.bfloat16:
            return "wgmma"
        if dtype == torch.float32:
            return "tf32x3"
    return "cuda_cores"


# The wgmma kernel against the plain version (P in float32), element by
# element.  bf16 keeps 8 significant bits, so one rounding moves a value
# by at most 2**-8 of itself.  Rounding each P to bf16 for P V moves an
# output o by at most 2**-8 * sum_j p_j |v_j| / l: 2**-8 of the attention
# of |v|.  The kernel and the plain version each round o once to bf16,
# which leaves them at most one bf16 step apart, 2**-7 of |o|.  At
# llama3-8b's S 4096 with unit-normal inputs this bound is about 3e-3,
# a tenth of the median |o|.
BF16_STEP = 2.0 ** -7


def wgmma_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, want: torch.Tensor,
                causal: bool = True, sm_scale: Optional[float] = None) -> torch.Tensor:
    """The largest difference, element by element, that the wgmma kernel
    may show against ``want`` = :func:`flash_attention_plain` on the same
    inputs: ``2**-7 |want| + 2**-8 attention(q, k, |v|)`` in float32."""
    abs_v = flash_attention_plain(q.float(), k.float(), v.float().abs(), causal, sm_scale,
                                  block_q=q.shape[2], block_k=math.gcd(k.shape[2], 512))
    return BF16_STEP * want.float().abs() + BF16_STEP / 2 * abs_v


# The tf32x3 kernel against the plain version, element by element.  Every
# product a b is a_hi b_hi + a_hi b_lo + a_lo b_hi, hi being a with its
# low 13 mantissa bits cleared (exact) and lo = a - hi, |lo| < 2**-10 |a|,
# whose own low bits the tensor cores drop: the dropped a_lo b_lo and the
# two lo operands move the product by at most eps |a| |b|, eps = 3 *
# 2**-20.  Scores: a score of row i moves by at most
# D_i = eps sm_scale max_j sum_d |q_id| |k_jd| over the keys j the row
# sees, so each probability p_ij / l_i moves by at most a factor
# e^(+-2 D_i) and the output by (e^(2 D_i) - 1) attention(q, k, |v|)_i.
# P V: its terms move by eps p |v|, the output by eps e^(2 D_i) of the
# same attention of |v|.  The float32 accumulation, whose order differs
# from the plain version's, is TF32X3_ACC times the plain version's own
# error against float64.
TF32X3_EPS = 3 * 2.0 ** -20
TF32X3_ACC = 4.0


def _attention64(q, k, v, causal: bool, sm_scale: float):
    """In float64, by blocks of 256 q rows (the scores of a block at
    llama3-8b's S 2048 are 134 MB): the attention output, the attention of
    |v|, and each row's largest sm_scale sum_d |q_d| |k_d| over the keys
    it sees (B, Hq, Sq, 1)."""
    rows = 256
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    f64 = torch.float64
    qd = q.to(f64).reshape(b, hkv, hq // hkv, sq, d)
    kt = k.to(f64).unsqueeze(2).transpose(-1, -2)
    vd = v.to(f64).unsqueeze(2)
    out, abs_v = torch.empty_like(qd), torch.empty_like(qd)
    span = torch.empty(qd.shape[:-1] + (1,), dtype=f64, device=q.device)
    for r0 in range(0, sq, rows):
        qs = qd[..., r0:r0 + rows, :]
        s = torch.matmul(qs, kt) * sm_scale
        mag = torch.matmul(qs.abs(), kt.abs()) * abs(sm_scale)
        if causal:
            hidden = (torch.arange(r0, r0 + qs.shape[-2], device=q.device)[:, None]
                      < torch.arange(sk, device=q.device)[None, :])
            s = s.masked_fill(hidden, -math.inf)
            mag = mag.masked_fill(hidden, 0.0)
        p = torch.softmax(s, dim=-1)
        out[..., r0:r0 + rows, :] = torch.matmul(p, vd)
        abs_v[..., r0:r0 + rows, :] = torch.matmul(p, vd.abs())
        span[..., r0:r0 + rows, :] = mag.amax(dim=-1, keepdim=True)
    return tuple(x.reshape(b, hq, sq, -1) for x in (out, abs_v, span))


def flash_tf32x3_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, want: torch.Tensor,
                       causal: bool = True, sm_scale: Optional[float] = None) -> torch.Tensor:
    """The largest difference, element by element, that the tf32x3 kernel
    may show against ``want`` (the plain version's float32 output on the
    same inputs, or the reference's):

        (e^(2 D) - 1 + eps e^(2 D)) attention(q, k, |v|) + |want - exact|
            + 4 |plain - exact|

    in float64, eps = 3 * 2**-20 and D = eps sm_scale max_j sum_d |q_d|
    |k_jd| per row over the keys it sees, where ``exact`` is the attention
    in float64 and ``plain`` :func:`flash_attention_plain` in float32 (the
    module's note above).  Plain TF32, the lo terms dropped, moves a
    product by up to 2**-10 of |a| |b| and exceeds it."""
    d = q.shape[-1]
    sm_scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    exact, abs_v, span = _attention64(q, k, v, causal, sm_scale)
    plain = flash_attention_plain(q.float(), k.float(), v.float(), causal, sm_scale,
                                  block_q=q.shape[2], block_k=math.gcd(k.shape[2], 512))
    grow = torch.expm1(2 * TF32X3_EPS * span)
    moved = (grow + TF32X3_EPS * (1 + grow)) * abs_v
    return (moved + (want.double() - exact).abs()
            + TF32X3_ACC * (plain.double() - exact).abs())


def _resolve(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale, block_q,
             block_k) -> Tuple[float, int, int]:
    """The reference's argument handling (``kernel.py:114-126``), its
    asserts as ``ValueError``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; want (B, Hq, Sq, D) and (B, Hkv, Sk, D) twice")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against k {tuple(k.shape)}")
    sk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if block_q is None or block_k is None:
        cq, ck = choose_block_sizes(sq, sk, d)
        block_q = block_q or min(cq, sq)
        block_k = block_k or min(ck, sk)
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"flash_attention: blocks ({block_q}, {block_k}) do not divide "
                         f"(Sq, Sk) = ({sq}, {sk})")
    return float(sm_scale), block_q, block_k


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, sm_scale: Optional[float] = None,
                          block_q: Optional[int] = None,
                          block_k: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the reference's online
    softmax over kv blocks of ``block_k`` keys, in float32, every q row at
    once.  A kv block the reference skips for a q block (all of it above
    the diagonal) adds exactly nothing here: its scores are -1e30, so its
    probabilities are 0 and the running max does not move.  The causal mask
    is ``qpos >= kpos`` from 0 (top-left aligned when Sq != Sk); a row
    whose sum ``l`` is 0 writes 0."""
    sm_scale, _block_q, block_k = _resolve(q, k, v, sm_scale, block_q, block_k)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    kf = k.float().unsqueeze(2)
    vf = v.float().unsqueeze(2)
    m = torch.full((b, hkv, hq // hkv, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    qpos = torch.arange(sq, device=q.device)[:, None]
    # the last kv block any q block reaches: the reference's block skip
    kv_end = min(sk, ((sq - 1) // block_k + 1) * block_k) if causal else sk
    for k0 in range(0, kv_end, block_k):
        s = torch.matmul(qf, kf[..., k0:k0 + block_k, :].transpose(-1, -2)) * sm_scale
        if causal:
            kpos = torch.arange(k0, k0 + block_k, device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
        m_cur = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vf[..., k0:k0 + block_k, :])
        m = m_cur
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l).reshape(b, hq, sq, d).to(q.dtype)


# ---------------------------------------------------------- C binding
class _FaParams(ctypes.Structure):
    _fields_ = [
        ("q", ctypes.c_void_p),
        ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("o", ctypes.c_void_p),
        ("sq", ctypes.c_int),
        ("sk", ctypes.c_int),
        ("d", ctypes.c_int),
        ("hq", ctypes.c_int),
        ("hkv", ctypes.c_int),
        ("group", ctypes.c_int),
        ("block_q", ctypes.c_int),
        ("block_k", ctypes.c_int),
        ("n_q", ctypes.c_int),
        ("causal", ctypes.c_int),
        ("dt", ctypes.c_int),
        ("sm_scale", ctypes.c_float),
    ]


def _bind(lib: ctypes.CDLL) -> None:
    lib.stripe_flash_attention_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_void_p]
    lib.stripe_flash_attention_launch.restype = ctypes.c_int
    lib.stripe_flash_attention_wgmma.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_void_p]
    lib.stripe_flash_attention_wgmma.restype = ctypes.c_int
    lib.stripe_flash_attention_tf32x3.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int,
                                                                          ctypes.c_void_p]
    lib.stripe_flash_attention_tf32x3.restype = ctypes.c_int
    lib.stripe_flash_attention_tf32x3_smem.argtypes = [ctypes.c_int]
    lib.stripe_flash_attention_tf32x3_smem.restype = ctypes.c_int
    lib.stripe_flash_attention_tf32x3_regs.argtypes = [ctypes.c_int]
    lib.stripe_flash_attention_tf32x3_regs.restype = ctypes.c_int
    lib.stripe_flash_attention_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.stripe_flash_attention_smem.restype = ctypes.c_int
    lib.stripe_flash_attention_layout.argtypes = [ctypes.c_void_p]
    lib.stripe_flash_attention_layout.restype = None
    _build.check_layout(lib.stripe_flash_attention_layout,
                        (ctypes.sizeof(_FaParams), _FaParams.sq.offset, _FaParams.causal.offset,
                         _FaParams.dt.offset, _FaParams.sm_scale.offset))
    for d in (32, 64, 128, 256):
        for r in (1, 2, 4, 8, 16):
            if r > _max_rows(d):
                continue
            got = lib.stripe_flash_attention_smem(_dpl(d), r)
            if got != smem_bytes(WARPS * r, d):
                raise _build.KernelBuildError(
                    f"flash_attention shared memory: C {got} B, Python {smem_bytes(WARPS * r, d)} B "
                    f"(head dim {d}, {r} rows a warp)")
    for d in WGMMA_HEAD_DIMS:
        got = lib.stripe_flash_attention_tf32x3_smem(d)
        if got != tf32x3_smem_bytes(d):
            raise _build.KernelBuildError(
                f"flash_attention tf32x3 shared memory: C {got} B, Python "
                f"{tf32x3_smem_bytes(d)} B (head dim {d})")
        regs = lib.stripe_flash_attention_tf32x3_regs(d)
        if regs != TF32_LAUNCH_REGS:
            raise _build.KernelBuildError(
                f"flash_attention tf32x3 kernel (head dim {d}) holds {regs} registers a "
                f"thread at launch, not {TF32_LAUNCH_REGS}: its setmaxnreg split needs them")


def load_library() -> ctypes.CDLL:
    return _build.load("flash_attention", _bind)


def _launch(q, k, v, causal: bool, sm_scale: float, block_q: int, block_k: int,
            path: Optional[str]) -> torch.Tensor:
    global launches
    device = q.device
    for name, t in (("k", k), ("v", v)):
        if not t.is_cuda or t.device != device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _TYPES:
        raise TypeError(f"flash_attention: the kernel takes {_TYPES}, not {q.dtype}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if path is None:
        path = path_of(q.dtype, d, all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    if path == "cuda_cores":
        if d > MAX_HEAD_DIM:
            raise ValueError(f"flash_attention: head dim {d} > {MAX_HEAD_DIM}, the kernel's limit")
        if block_q > max_block_q(d):
            raise ValueError(f"flash_attention: block_q {block_q} > {max_block_q(d)}, the rows "
                             f"one CTA of the kernel holds at head dim {d}")
    # b*Hq and the q tile share grid x; the tf32x3 prep kernel runs one CTA
    # per (b*Hkv, 32 keys)
    skp = -(-sk // 8) * 8
    ctas = b * hq * (sq // block_q if path == "cuda_cores" else -(-sq // (2 * WGMMA_ROWS)))
    if path == "tf32x3":
        ctas = max(ctas, b * hkv * -(-skp // TF32_KEYS))
    if ctas > GRID_X:
        raise ValueError(f"flash_attention: {ctas} CTAs exceed the grid's x limit {GRID_X}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = load_library()
    p = _FaParams(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=out.data_ptr(),
                  sq=sq, sk=sk, d=d, hq=hq, hkv=hkv, group=hq // hkv,
                  block_q=block_q, block_k=block_k, n_q=sq // block_q,
                  causal=int(bool(causal)), dt=_build.dtype_code(q.dtype), sm_scale=sm_scale)
    if path == "wgmma":
        rc = lib.stripe_flash_attention_wgmma(ctypes.addressof(p), d, b * hq,
                                              _build.stream_of(device))
    elif path == "tf32x3":
        # k split into hi and lo, and v transposed and split, which the
        # prep kernel writes and the main kernel reads
        ks = torch.empty((2, b * hkv, sk, d), dtype=torch.float32, device=device)
        vt = torch.empty((2, b * hkv, d, skp), dtype=torch.float32, device=device)
        rc = lib.stripe_flash_attention_tf32x3(ctypes.addressof(p), ks[0].data_ptr(),
                                               ks[1].data_ptr(), vt[0].data_ptr(),
                                               vt[1].data_ptr(), b * hq,
                                               _build.stream_of(device))
    else:
        rc = lib.stripe_flash_attention_launch(ctypes.addressof(p), _dpl(d),
                                               rows_per_warp(block_q), b * hq,
                                               _build.stream_of(device))
    _build.launch_rc(rc, f"flash_attention ({path})")
    launches += 1
    launches_by_path[path] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    path: Optional[str] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D), Hq a multiple of Hkv (GQA:
    q head h reads kv head h // (Hq / Hkv)).  Returns (B, Hq, Sq, D) in
    ``q.dtype``.  The kernel for CUDA tensors, the plain version for CPU
    tensors.

    ``path``: None takes :func:`path_of`'s choice; ``"cuda_cores"`` forces
    the CUDA-core kernel, to time it against the wgmma or tf32x3 one on
    the same inputs."""
    _build.refuse_autograd("flash_attention", q, k, v)
    if path not in (None, "cuda_cores"):
        raise ValueError(f"path is None (the rule's choice) or 'cuda_cores', not {path!r}")
    sm_scale, block_q, block_k = _resolve(q, k, v, sm_scale, block_q, block_k)
    if q.is_cuda:
        return _launch(q, k, v, causal, sm_scale, block_q, block_k, path)
    if k.is_cuda or v.is_cuda:
        raise ValueError("flash_attention: q on the CPU, k or v on the card")
    return flash_attention_plain(q, k, v, causal, sm_scale, block_q, block_k)
