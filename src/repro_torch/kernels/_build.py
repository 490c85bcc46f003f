"""Build and load the port's CUDA libraries.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C
interface (``contraction.cu``, ``elementwise.cu``, ``windowed.cu``,
``flash_attention.cu``, ``gla.cu``, ``moe_dispatch.cu``); the first five
include ``csrc/dag.cuh``, the shared device code (element types, typed
loads and stores, the postfix DAG evaluator), and the tensor-core kernels (contraction,
windowed, flash_attention) ``csrc/hopper.cuh``, the Hopper building
blocks (cp.async, mbarriers, TMA and its tensor maps, wgmma).  Each source
compiles with ``nvcc`` for ``sm_90a`` into its own shared object under
``build/kernels/<hash>/`` at the repository root, the hash covering the
source, the headers and the flags (ptxas's report of its kernels'
registers, stack frame and spills beside it, as
``libstripe_<name>.ptxas.txt``), and is bound with ``ctypes``.  The first
load starts one ``nvcc`` per missing library, all at once, and waits for
them together, so the six builds cost the time of the slowest.

Nothing is built on import: only a kernel launch (or an explicit
:func:`build_all`) compiles, which happens only where ``nvcc`` exists.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"contraction": "contraction.cu", "elementwise": "elementwise.cu",
           "windowed": "windowed.cu", "flash_attention": "flash_attention.cu",
           "gla": "gla.cu", "moe_dispatch": "moe_dispatch.cu"}
HEADERS = ("dag.cuh", "hopper.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Element types a kernel reads and writes; must match csrc/dag.cuh (DT_*).
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2, "int8": 3, "int32": 4}

# what each build did: {name: {"path", "seconds", "cached", "ptxas"}}
BUILD_INFO: Dict[str, Dict[str, object]] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """A CUDA library could not be built or loaded."""


class KernelLaunchError(RuntimeError):
    """A kernel launch was refused (cudaGetLastError() != 0)."""


class KernelAutogradError(ValueError):
    """A hand-written kernel was called where autograd would differentiate
    it (ROADMAP C11).  The kernels have no backward, as the JAX package's
    Pallas kernels have none: a kernel's output on the card would carry no
    gradient, and its plain version on the CPU would differentiate where
    the reference raises."""


def refuse_autograd(where: str, *tensors) -> None:
    """Raise :class:`KernelAutogradError` if autograd is on and any of
    ``tensors`` (non-tensors are ignored) requires grad."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise KernelAutogradError(
            f"{where}: the hand-written kernels have no backward (ROADMAP C11), and an "
            f"input requires grad with autograd on; train on oplib's 'torch' backend, or "
            f"call under torch.no_grad()")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for cand in ("/usr/local/cuda/bin/nvcc",):
        if os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / SOURCES[name]).read_bytes())
    for hdr in HEADERS:
        h.update((CSRC / hdr).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"libstripe_{name}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every library of ``names`` (default: all) whose source hash
    has not been built yet: one ``nvcc`` per source, started together."""
    names = list(SOURCES if names is None else names)
    out: Dict[str, Path] = {}
    running = []
    t0 = time.perf_counter()
    for name in names:
        so = library_path(name)
        out[name] = so
        if so.exists():
            if BUILD_INFO.get(name, {}).get("path") != str(so):  # not built by this process
                report = ptxas_path(so)
                BUILD_INFO[name] = {"path": str(so), "seconds": 0.0, "cached": True,
                                    "ptxas": report.read_text() if report.exists() else ""}
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
        except OSError as e:
            os.unlink(tmp)
            raise KernelBuildError(f"cannot run nvcc: {e}") from e
        running.append((name, so, tmp, proc))
    failures = []
    for name, so, tmp, proc in running:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{SOURCES[name]}: nvcc failed ({proc.returncode}):\n{err[-4000:]}")
            continue
        # the report first, so that a library on disk always has its own
        ptxas_path(so).write_text(err.strip())
        os.replace(tmp, so)
        BUILD_INFO[name] = {"path": str(so), "seconds": time.perf_counter() - t0,
                            "cached": False, "ptxas": err.strip()}
    if failures:
        raise KernelBuildError("\n".join(failures))
    return out


def load(name: str, bind) -> ctypes.CDLL:
    """The bound library of kernel ``name``, building every missing
    library first.  ``bind(lib)`` sets the argument types and checks the
    parameter layout; it raises :class:`KernelBuildError` on a mismatch."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    so = build_all()[name]
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        raise KernelBuildError(f"cannot load {so}: {e}") from e
    bind(lib)
    _LIBS[name] = lib
    return lib


def ptxas_path(so: Path) -> Path:
    """Where the build of library ``so`` keeps what ``ptxas -v`` said."""
    return so.with_suffix(".ptxas.txt")


def ptxas_text(name: str) -> str:
    """What ``ptxas -v`` said of library ``name``'s kernels when it was
    built (building it first if it is missing)."""
    if name not in BUILD_INFO:
        build_all([name])
    text = str(BUILD_INFO[name].get("ptxas", ""))
    if not text:
        raise KernelBuildError(f"{BUILD_INFO[name]['path']} has no ptxas report beside it")
    return text


_PTXAS_FN = re.compile(r"Function properties for (\S+)")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def parse_ptxas(text: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (its mangled name) of a ``ptxas -v`` report: registers,
    stack frame and spill bytes."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in text.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = _PTXAS_FRAME.search(line)
        if m:
            out[fn].update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = _PTXAS_REGS.search(line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def check_layout(lib_fn, want) -> None:
    """Compare a C struct's layout, as ``lib_fn`` reports it, with the
    ctypes binding's (``want``: sizeof, then field offsets)."""
    got = (ctypes.c_longlong * len(want))()
    lib_fn(ctypes.addressof(got))
    if tuple(got) != tuple(want):
        raise KernelBuildError(f"parameter layout differs between C {tuple(got)} "
                               f"and the ctypes binding {tuple(want)}")


# The grid-stride kernels (elementwise, windowed): threads per block, and
# at most 16 blocks per SM of the H100's 132 (each thread then walks
# several points when the region is larger).
BLOCK = 256
MAX_BLOCKS = 132 * 16


def grid_stride_blocks(n_points: int) -> int:
    return max(1, min(MAX_BLOCKS, -(-n_points // BLOCK)))


def dtype_code(dtype) -> int:
    """The kernels' type code of a dtype name or a ``torch.dtype``."""
    return DTYPE_CODES[str(dtype).replace("torch.", "")]


def launch_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise KernelLaunchError(f"{what} launch failed: CUDA error {rc}")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_type(t: torch.Tensor, what: str, dtype: str) -> torch.Tensor:
    """An operand of the planned type (on either device): a tensor of
    another type is refused, never converted."""
    from ..core.lower_torch import torch_dtype

    if t.dtype != torch_dtype(dtype):
        raise TypeError(f"{what} is {t.dtype}; the kernel was planned for {dtype}")
    return t


def check_cuda(t: torch.Tensor, what: str, device, dtype: str) -> torch.Tensor:
    """A kernel operand: on ``device``, of the planned type, contiguous."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{what} is on {t.device}, the launch is on {device}")
    return check_type(t, what, dtype).contiguous()
