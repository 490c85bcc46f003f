"""Mixture-of-Experts layer: top-k routing with capacity-bounded
scatter/gather dispatch (Switch-style).  Expert weights are stacked on a
leading expert axis, as in the JAX package.

The dispatch runs every expert on its ``cap`` rows, empty or not, so a
call reads every expert's weights whatever the routing picked (the JAX
package's design, ported as it is).  The capacity comes from shapes on
the host; everything that depends on the routing stays on the device, so
the layer never waits for the host."""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..parallel.constrain import constrain
from .core import Params, _normal, dense_init


def moe_init(gen: torch.Generator, cfg, dtype, device=None) -> Params:
    d = cfg.d_model
    e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
    scale = 1.0 / float(d) ** 0.5
    fscale = 1.0 / float(f) ** 0.5
    return {
        # the router stays float32 whatever the model's type
        "router": dense_init(gen, d, e, torch.float32, device),
        "w_gate": _normal(gen, (e, d, f), scale, dtype, device),
        "w_up": _normal(gen, (e, d, f), scale, dtype, device),
        "w_down": _normal(gen, (e, f, d), fscale, dtype, device),
    }


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    # a comparison, not ``F.one_hot``: no check of the indices on the host
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router: float32 probabilities over the experts (t, e) and each
    token's top-k experts (t, k), largest first, for x: (..., D)."""
    logits = torch.einsum("td,de->te", x.reshape(-1, x.shape[-1]).float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    # ``jax.lax.top_k`` and ``torch.topk`` may order tied values
    # differently; the router and its softmax run in float32, so seeded
    # inputs give no ties
    return probs, torch.topk(probs, cfg.moe.top_k, dim=-1, sorted=True)[1]


def moe_apply(p: Params, x: torch.Tensor, cfg, dist=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D).  Returns (out, aux_loss).

    ``dist`` is a rank of the sharded step (``parallel/sharded.py``), None
    on one device.  A rank routes its own tokens, keeps the layer's
    semantics global (the capacity from the global token count, each
    token's position in its expert counted in the global token order, the
    auxiliary loss from the global means), and runs its own experts on
    their capacity rows; the step's collectives sit at the hooks.  The
    expert-major tensors' sharding is pinned here (``constrain``), as the
    JAX package pins it."""
    if dist is not None:
        x = dist.enter_moe(x)
    b, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    t = b * s
    t_all = t if dist is None else dist.moe_tokens(t)
    cap = max(int(math.ceil(cfg.moe.capacity_factor * t_all * k / e)), 4)

    xt = x.reshape(t, d)
    probs, gate_idx = route(p, xt, cfg)
    gate_vals = probs.gather(1, gate_idx)                     # (t, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # load-balancing auxiliary loss (Switch): E * sum(frac_tokens * frac_prob)
    top1 = _one_hot(gate_idx[:, 0], e, torch.float32)
    if dist is None:
        me = probs.mean(dim=0)
        ce = top1.mean(dim=0)
        aux = e * torch.sum(me * ce)
    else:
        aux = dist.moe_aux(probs, top1, t_all)

    # position of each (token, choice) within its expert's capacity, in
    # token-major, choice-minor order
    eid = gate_idx.reshape(-1)                                   # (t*k,)
    onehot = _one_hot(eid, e, torch.int32)
    pos = torch.cumsum(onehot, dim=0) - 1                        # running count
    if dist is not None:
        pos = pos + dist.moe_offsets(onehot)                     # the blocks before
    pos_in_e = pos.gather(1, eid[:, None])[:, 0]
    keep = pos_in_e < cap
    e0, el = (0, e) if dist is None else dist.moe_experts(e)
    if dist is not None:
        keep = keep & (eid >= e0) & (eid < e0 + el)              # this rank's experts
    slot = torch.where(keep, (eid - e0) * cap + pos_in_e, el * cap)  # overflow slot

    # scatter tokens into (el*cap+1, d), compute experts, gather back
    src = xt.repeat_interleave(k, dim=0)                          # (t*k, d)
    buf = torch.zeros((el * cap + 1, d), dtype=x.dtype, device=x.device).index_add_(
        0, slot, src * keep[:, None].to(x.dtype))
    h = buf[: el * cap].reshape(el, cap, d)
    w = p
    if dist is not None:
        h = dist.moe_dispatch(h)
        w = dist.moe_weights(p)
    # EP: the expert-major tensors sharded on 'model'
    h = constrain(h, "model", "data", None, shape=(e, cap, d))
    if cfg.act.endswith("_glu"):
        a = cfg.act.split("_")[0]
        act_fn = F.silu if a == "silu" else (lambda z: F.gelu(z, approximate="tanh"))
        g = act_fn(torch.einsum("ecd,edf->ecf", h, w["w_gate"]))
        u = torch.einsum("ecd,edf->ecf", h, w["w_up"])
        o = torch.einsum("ecf,efd->ecd", g * u, w["w_down"])
    else:
        u = torch.square(torch.relu(torch.einsum("ecd,edf->ecf", h, w["w_up"])))
        o = torch.einsum("ecf,efd->ecd", u, w["w_down"])
    o = constrain(o, "model", "data", None, shape=(e, cap, d))
    if dist is not None:
        o = dist.moe_collect(o)
    flat = torch.cat([o.reshape(el * cap, d), torch.zeros((1, d), dtype=o.dtype, device=o.device)])
    # combine: weight in expert-major layout, then one scatter-add back to
    # token-major (t, d); empty slots go to the sink row t.  On the card
    # the adds are atomic, k of them a token in no fixed order, so a bf16
    # output may differ by a rounding step from run to run.
    w_buf = torch.zeros((el * cap + 1,), dtype=torch.float32, device=x.device).index_add_(
        0, slot, gate_vals.reshape(-1) * keep)
    ow = flat * w_buf[:, None].to(flat.dtype)                     # (el*cap+1, d)
    tok_ids = torch.arange(t, device=x.device).repeat_interleave(k)  # (t*k,)
    tok_of_slot = torch.full((el * cap + 1,), -1, dtype=torch.int64, device=x.device).scatter_reduce_(
        0, slot, torch.where(keep, tok_ids, -1), "amax", include_self=True)
    dest = torch.where(tok_of_slot >= 0, tok_of_slot, t)
    out = torch.zeros((t + 1, d), dtype=flat.dtype, device=x.device).index_add_(0, dest, ow)[:t]
    if dist is not None:
        out = dist.reduce(out)
    out = constrain(out, ("data",), None, shape=(t_all, d))
    out = out.reshape(b, s, d)
    if dist is not None:
        out = dist.leave_moe(out)
    return out, aux
