"""ZeRO-1: optimizer-state sharding over the data-parallel axis, the twin
of the JAX package's ``optim/zero1.py``, built on :mod:`.adamw`.

Inside ``parallel.spmd.shard_map`` over the 'data' axis:
  1. grads are reduce-scattered (each rank owns 1/N of every gradient),
  2. the AdamW update runs on the owned shard only (m/v sharded),
  3. updated param shards are all-gathered.

Memory: optimizer state drops from 8 bytes/param to 8/N bytes/param per
replica; collective volume is identical to a plain all-reduce
(reduce-scatter + all-gather).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .. import tree as T
from ..parallel import spmd
from ..parallel.compat import axis_size
from . import adamw


def _flat_size(x: torch.Tensor) -> int:
    n = 1
    for s in x.shape:
        n *= s
    return n


def _padded(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` flat in float32, zero-padded to a multiple of ``n``, as ``(n, -1)``."""
    flat = x.reshape(-1).to(torch.float32)
    return F.pad(flat, (0, (-flat.numel()) % n)).reshape(n, -1)


def zero1_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: adamw.AdamWConfig, axis: str = "data") -> Tuple[Any, Dict[str, Any], Dict]:
    """Per-shard update — call inside shard_map with params/grads replicated
    on ``axis`` and opt state sharded (leading dim = shard).  Returns
    ``(new_params, new_state, {"grad_norm", "lr"})``."""
    n = axis_size(axis)
    idx = spmd.axis_index(axis)

    g_shards = T.tree_map(
        lambda g: spmd.psum_scatter(_padded(g, n), axis, scatter_dimension=0, tiled=False),
        grads)

    step = state["step"] + 1
    gnorm_sq_local = sum(torch.sum(torch.square(g)) for g in T.leaves(g_shards))
    gnorm = torch.sqrt(spmd.psum(gnorm_sq_local, axis))
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = adamw.lr_at(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=sf.device), sf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=sf.device), sf)

    def upd(p, g, m, v):
        p_shard = _padded(p, n)[idx]
        g = g * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps) + cfg.weight_decay * p_shard
        new_shard = p_shard - lr * delta
        full = spmd.all_gather(new_shard, axis, tiled=True)
        return full[: _flat_size(p)].reshape(p.shape).to(p.dtype), m2, v2

    flat_p, treedef = T.flatten(params)
    flat_g = T.leaves(g_shards)
    flat_m = T.leaves(state["m"])
    flat_v = T.leaves(state["v"])
    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = T.unflatten(treedef, [o[0] for o in out])
    new_m = T.unflatten(treedef, [o[1] for o in out])
    new_v = T.unflatten(treedef, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}, {"grad_norm": gnorm, "lr": lr}


def zero1_init_state(params: Any, n_shards: int) -> Dict[str, Any]:
    """Sharded m/v as *global* flat tensors of size n*ceil(|p|/n) — shard
    them with ``P('data')`` so each rank holds its ceil(|p|/n) slice."""
    def shard_zeros(p):
        per = -(-_flat_size(p) // n_shards)
        return torch.zeros((n_shards * per,), dtype=torch.float32, device=p.device)

    first = T.leaves(params)
    device = first[0].device if first else None
    return {
        "m": T.tree_map(shard_zeros, params),
        "v": T.tree_map(shard_zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
