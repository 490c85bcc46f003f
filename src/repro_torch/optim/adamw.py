"""AdamW with global-norm clipping and a warmup-cosine schedule, the twin of
the JAX package's ``optim/adamw.py``: functions on trees of tensors (dicts,
lists; ``repro_torch.tree``'s leaf order, which is ``jax.tree``'s).

The state is ``{"m": tree, "v": tree, "step": int32 scalar}``, ``m`` and
``v`` float32 on the parameters' device.  The update runs in float32 and
is cast back to each parameter's type, in the reference's order of
operations.  The reference donates the parameters and the state to its
jitted step; the port's twin of that is :func:`apply_updates_`, which
writes the new parameters, ``m`` and ``v`` into the tensors they came in,
a leaf at a time under ``torch.no_grad()``, with at most two float32
temporaries of one leaf's size.  :func:`apply_updates` (functional) is the
same code on copies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from .. import tree as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def init_state(params: Any) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = T.leaves(params)
    device = first[0].device if first else None
    return {"m": T.tree_map(zeros, params), "v": T.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    total = 0
    for leaf in T.leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def apply_updates_(params: Any, grads: Any, state: Dict[str, Any], cfg: AdamWConfig,
                   gnorm: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One AdamW step in place: each parameter, ``state["m"]`` and
    ``state["v"]`` leaf is overwritten and ``state["step"]`` replaced.
    ``gnorm`` is the gradients' global norm where the caller holds only
    shards of them (``parallel/sharded.py``); by default the norm of
    ``grads``.  Returns ``{"grad_norm", "lr"}`` (0-d tensors)."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=sf.device), sf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=sf.device), sf)

    flat_p, treedef = T.flatten(params)
    flat_g, flat_m, flat_v = (T.leaves(t) for t in (grads, state["m"], state["v"]))
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("apply_updates: params, grads, m and v have different leaf counts")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        # g = g * scale;  m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        g = g.to(torch.float32, copy=True).mul_(scale)
        tmp = g * (1 - cfg.b1)
        m.mul_(cfg.b1).add_(tmp)
        torch.mul(g, g, out=tmp).mul_(1 - cfg.b2)
        v.mul_(cfg.b2).add_(tmp)
        # delta = (m / b1c) / (sqrt(v / b2c) + eps) + wd * p
        torch.div(m, b1c, out=g)
        torch.div(v, b2c, out=tmp).sqrt_().add_(cfg.eps)
        g.div_(tmp)
        tmp.copy_(p).mul_(cfg.weight_decay)
        g.add_(tmp)
        # p = p - lr * delta, rounded to p's type
        g.mul_(lr)
        p.copy_(tmp.copy_(p).sub_(g))
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}


def apply_updates(params: Any, grads: Any, state: Dict[str, Any], cfg: AdamWConfig
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Functional form of :func:`apply_updates_` (the reference's
    signature): ``(new_params, new_state, {"grad_norm", "lr"})``, the inputs
    left as they were."""
    def copy(t):
        return t.detach().clone()

    new_p = T.tree_map(copy, params)
    new_state = {"m": T.tree_map(copy, state["m"]), "v": T.tree_map(copy, state["v"]),
                 "step": state["step"]}
    info = apply_updates_(new_p, grads, new_state, cfg)
    return new_p, new_state, info
