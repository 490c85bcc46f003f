"""Chunkwise gated linear attention: the CUDA kernel's binding, its launch
counter, its plain PyTorch version, and the chunk length the autotiler
chooses.

``csrc/gla.cu`` replaces the TPU kernel
``src/repro/kernels/mlstm_chunk/kernel.py::chunked_gla``: the linear
recurrence

    C_t = decay_t * C_{t-1} + gain_t * k_t v_t^T          (Dk x Dv state)
    n_t = decay_t * n_{t-1} + gain_t * k_t                (normalizer, optional)
    h_t = q_t @ C_t [/ max(|q_t . n_t|, 1)]

evaluated chunk by chunk, decays in log space.  One CTA owns one (b*h,
tile of 64 columns of Dv) and loops over the chunks, its slice of the
state in shared memory; the source says how the work is laid out.

:func:`chunked_gla` launches the kernel for CUDA tensors (raising on any
failure) and runs its plain version, ``nn.scan_ops.chunked_gla_torch``,
only for CPU tensors.
``launches`` counts kernel launches.  ``mlstm_chunk`` (and
``ssd_chunk.ssd_chunk``) only transform their gates and call it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build
from ...core.hwconfig import get_config
from ...nn.scan_ops import chunked_gla_torch

# Kernel launches since import (or since the caller last reset it).
launches = 0

# The kernel's geometry (csrc/gla.cu): Dv columns per CTA, the score tile,
# the depth of a staged slab and the staging row stride.
TV, TILE, KD, LD = 64, 64, 32, 68
_TYPES = (torch.float32, torch.bfloat16)
_SMEM_LIMIT = get_config("h100").mem("SMEM").size_bytes  # what one H100 block may use


def smem_bytes(dk: int, chunk: int) -> int:
    """Shared memory of one CTA (``gla_smem_floats`` in the source): the
    Dk x 64 state slice, n, four chunk-long vectors, q . n of a row tile,
    and two staging tiles."""
    return 4 * (dk * TV + ((dk + 3) & ~3) + 4 * chunk + TILE + 2 * TILE * LD)


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


def _bind(lib: ctypes.CDLL) -> None:
    lib.stripe_gla_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.stripe_gla_launch.restype = ctypes.c_int
    lib.stripe_gla_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.stripe_gla_smem.restype = ctypes.c_int
    lib.stripe_gla_layout.argtypes = [ctypes.c_void_p]
    lib.stripe_gla_layout.restype = None
    _build.check_layout(lib.stripe_gla_layout,
                        (ctypes.sizeof(_GlaParams), _GlaParams.s.offset,
                         _GlaParams.qkv_dt.offset, _GlaParams.normalize.offset,
                         _GlaParams.scale.offset))
    for dk, chunk in ((8, 16), (64, 256), (384, 256)):
        if lib.stripe_gla_smem(dk, chunk) != smem_bytes(dk, chunk):
            raise _build.KernelBuildError(
                f"gla shared memory: C {lib.stripe_gla_smem(dk, chunk)} B, Python "
                f"{smem_bytes(dk, chunk)} B (Dk {dk}, chunk {chunk})")


def load_library() -> ctypes.CDLL:
    return _build.load("gla", _bind)


def _launch(q, k, v, log_decay, gain, chunk: int, normalize: bool, scale: float) -> torch.Tensor:
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
    if smem_bytes(dk, chunk) > _SMEM_LIMIT:
        raise ValueError(f"chunked_gla: Dk {dk} at chunk {chunk} needs "
                         f"{smem_bytes(dk, chunk)} B of shared memory, over one block's "
                         f"{_SMEM_LIMIT}")
    if b * h > 65535:
        raise ValueError(f"chunked_gla: B*H = {b * h} exceeds the grid's y limit")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    log_decay, gain = log_decay.contiguous(), gain.contiguous()
    out = torch.empty((b, h, s, dv), dtype=q.dtype, device=device)
    if out.numel() == 0:
        return out
    lib = load_library()
    p = _GlaParams(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), ld=log_decay.data_ptr(),
                   g=gain.data_ptr(), o=out.data_ptr(), s=s, dk=dk, dv=dv, chunk=chunk,
                   qkv_dt=_build.dtype_code(q.dtype), ld_dt=_build.dtype_code(log_decay.dtype),
                   g_dt=_build.dtype_code(gain.dtype), out_dt=_build.dtype_code(q.dtype),
                   normalize=int(bool(normalize)), scale=scale)
    rc = lib.stripe_gla_launch(ctypes.addressof(p), b * h, _build.stream_of(device))
    _build.launch_rc(rc, "gla")
    launches += 1
    return out


def chunked_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor, gain: torch.Tensor,
                chunk: Optional[int] = None, normalize: bool = True,
                scale: float = 1.0) -> torch.Tensor:
    """q/k: (B, H, S, Dk); v: (B, H, S, Dv); log_decay/gain: (B, H, S).
    Returns (B, H, S, Dv) in ``q.dtype``.  The kernel for CUDA tensors, the
    plain version for CPU tensors."""
    chunk = _resolve(q, k, v, log_decay, gain, chunk)
    if q.is_cuda:
        return _launch(q, k, v, log_decay, gain, chunk, normalize, float(scale))
    if any(t.is_cuda for t in (k, v, log_decay, gain)):
        raise ValueError("chunked_gla: q on the CPU, another input on the card")
    return chunked_gla_torch(q, k, v, log_decay, gain, chunk=chunk, normalize=normalize,
                             scale=scale)


def mlstm_chunk(q, k, v, i_gate, f_gate, chunk: Optional[int] = None) -> torch.Tensor:
    """xLSTM mLSTM: decay = sigmoid(f), gain = exp(i) (i pre-clamped at 8),
    normalized output, q scaled by Dk^-1/2."""
    dk = q.shape[-1]
    log_decay = F.logsigmoid(f_gate)
    gain = torch.exp(torch.clamp(i_gate, max=8.0))
    return chunked_gla(q, k, v, log_decay, gain, chunk=chunk, normalize=True,
                       scale=float(dk) ** -0.5)
