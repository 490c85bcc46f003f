"""The MoE dispatch's positions: its binding, its launch counter, and its
plain PyTorch version.

A top-k router gives each token k experts; the capacity-bounded dispatch
(``nn/moe.py::moe_apply``) gives each (token, choice) pair, in
token-major, choice-minor order, the next free row of its expert, while
the expert has fewer than ``cap`` pairs.  For the flat expert ids ``eid``
(n = t*k pairs) :func:`dispatch` returns

* ``pair_of_slot`` (el * cap,): the pair in each slot, ``n`` in an empty
  one.  A pair at position ``pos`` among its expert's pairs fills slot
  ``(eid - e0) * cap + pos`` if ``pos < cap`` and its expert lies in the
  range ``[e0, e0 + el)``, and no slot otherwise;
* ``dropped``: a 0-d device count of the pairs whose position is at or
  past ``cap``, taken before the expert range is applied.

Where the pairs come in ``blocks`` equal blocks of the global token order
(the sharded step's rank that routes its pod group's tokens), ``offsets``
is called with the pairs of each block per expert, (blocks, e), and
returns what to add to the positions of each block's pairs, (blocks, e):
the pairs of every token before the block, globally.

``csrc/moe_dispatch.cu`` computes them for CUDA tensors in two launches
(a per-tile count, then a rank pass) and replaces no TPU kernel: the JAX
package's dispatch takes the positions as a ``cumsum`` over a
(pairs x experts) one-hot, which :func:`dispatch_plain` keeps and runs
only for CPU tensors.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from . import _build

# Kernel launches since import (or since the caller last reset it): two a
# call.
launches = 0
# Pairs a block of the kernel takes (csrc/moe_dispatch.cu's TILE).
TILE = 1024

Offsets = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.stripe_moe_dispatch_tile.argtypes = []
    lib.stripe_moe_dispatch_tile.restype = i
    lib.stripe_moe_dispatch_count.argtypes = [p, p, p, p, ll, ll, i, i, i, ll, p]
    lib.stripe_moe_dispatch_count.restype = i
    lib.stripe_moe_dispatch_rank.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, p]
    lib.stripe_moe_dispatch_rank.restype = i
    tile = lib.stripe_moe_dispatch_tile()
    if tile != TILE:
        raise _build.KernelBuildError(f"csrc/moe_dispatch.cu tiles {tile} pairs, the binding "
                                      f"{TILE}")


def load_library() -> ctypes.CDLL:
    return _build.load("moe_dispatch", _bind)


def _check(eid: torch.Tensor, e: int, cap: int, e0: int, el: int, blocks: int) -> None:
    if eid.dim() != 1 or eid.dtype != torch.int64:
        raise TypeError(f"eid is a 1-d int64 tensor of expert ids, not {eid.dtype} "
                        f"{tuple(eid.shape)}")
    if cap < 1 or not 0 <= e0 < e0 + el <= e:
        raise ValueError(f"capacity {cap} and experts [{e0}, {e0 + el}) of {e}")
    if blocks < 1 or eid.numel() % blocks:
        raise ValueError(f"{eid.numel()} pairs do not split into {blocks} blocks")


def dispatch(eid: torch.Tensor, e: int, cap: int, experts: Optional[Tuple[int, int]] = None,
             blocks: int = 1, offsets: Offsets = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pair_of_slot, dropped)`` of the pairs' expert ids ``eid``
    (module docstring): the kernel for a CUDA tensor, the plain version
    for a CPU one.  ``experts`` is the range ``(e0, el)`` (all ``e`` by
    default)."""
    global launches
    e0, el = (0, e) if experts is None else experts
    _check(eid, e, cap, e0, el, blocks)
    if not eid.is_cuda:
        return dispatch_plain(eid, e, cap, (e0, el), blocks, offsets)
    device = eid.device
    eid = eid.contiguous()
    lib = load_library()
    n = eid.numel()
    block_len = n // blocks
    tiles_per_block = max(1, -(-block_len // TILE))
    n_tiles = blocks * tiles_per_block
    table = torch.empty((n_tiles, e), dtype=torch.int32, device=device)
    pair_of_slot = torch.empty((el * cap,), dtype=torch.int64, device=device)
    dropped = torch.empty((), dtype=torch.int64, device=device)
    stream = _build.stream_of(device)
    _build.launch_rc(lib.stripe_moe_dispatch_count(
        eid.data_ptr(), table.data_ptr(), pair_of_slot.data_ptr(), dropped.data_ptr(), n,
        block_len, n_tiles, tiles_per_block, e, el * cap, stream), "moe_dispatch count")
    launches += 1
    off = None
    if offsets is not None:
        counts = table.reshape(blocks, tiles_per_block, e).sum(dim=1)
        off = offsets(counts).to(torch.int64).contiguous()
        if off.shape != (blocks, e) or off.device != device:
            raise ValueError(f"offsets gave {tuple(off.shape)} on {off.device}, not "
                             f"{(blocks, e)} on {device}")
    _build.launch_rc(lib.stripe_moe_dispatch_rank(
        eid.data_ptr(), None if off is None else off.data_ptr(), table.data_ptr(),
        pair_of_slot.data_ptr(), dropped.data_ptr(), block_len, n_tiles, tiles_per_block, e, cap,
        e0, el, stream), "moe_dispatch rank")
    launches += 1
    return pair_of_slot, dropped


def dispatch_plain(eid: torch.Tensor, e: int, cap: int, experts: Tuple[int, int],
                   blocks: int = 1, offsets: Offsets = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same map and count as :func:`dispatch`, from a running count (``cumsum``)
    of the pairs' one-hot over the experts within each block, as the JAX
    package computes them."""
    e0, el = experts
    n = eid.numel()
    onehot = (eid[:, None] == torch.arange(e, device=eid.device)).to(torch.int32)
    per = onehot.reshape(blocks, n // blocks, e)
    pos = torch.cumsum(per, dim=1) - 1                            # running count
    if offsets is not None:
        pos = pos + offsets(per.sum(dim=1))[:, None]              # the tokens before
    pos_in_e = pos.reshape(n, e).gather(1, eid[:, None])[:, 0]
    dropped = (pos_in_e >= cap).sum()
    keep = (pos_in_e < cap) & (eid >= e0) & (eid < e0 + el)
    slot = torch.where(keep, (eid - e0) * cap + pos_in_e, el * cap)
    pairs = torch.where(keep, torch.arange(n, device=eid.device), n)
    pair_of_slot = torch.full((el * cap + 1,), n, dtype=torch.int64,
                              device=eid.device).scatter_(0, slot, pairs)[:el * cap]
    return pair_of_slot, dropped
