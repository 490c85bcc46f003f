"""The plain reference of a decoder-only MoE LM (qwen3-moe-30b-a3b's
layout as the configuration states it): pre-norm RMSNorm blocks,
grouped-query attention with qk-norm and rotary embeddings, and a
mixture of experts with top-k routing and bounded capacity.

Routing: a float32 router, softmax over the experts, the top k by
probability (largest first), their probabilities renormalised to sum to
one.  Capacity: within one call of the layer (a group of tokens), each
expert takes at most max(ceil(capacity_factor * tokens * k / experts), 4)
(token, choice) pairs, counted in token order and, within a token, in
choice order; a pair past that is dropped and adds nothing.  Each expert
is a SiLU-gated MLP.  Float32 from the benchmark's weights, a layer at a
time, each expert's kept pairs in one product."""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from bench.reference import common


def _route(xt: torch.Tensor, router: torch.Tensor, moe) -> Tuple[torch.Tensor, ...]:
    """(token, expert, gate) of every kept pair of one call's tokens xt."""
    e, k = moe["n_experts"], moe["top_k"]
    t = xt.shape[0]
    probs = torch.softmax(xt @ router.float(), dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1, sorted=True)
    gate = top_p / top_p.sum(-1, keepdim=True)
    cap = max(int(math.ceil(moe.get("capacity_factor", 1.25) * t * k / e)), 4)
    eid = top_e.reshape(-1)
    # each pair's place in its expert's queue, pairs in token-major order
    onehot = torch.nn.functional.one_hot(eid, e)
    place = (torch.cumsum(onehot, 0) - 1).gather(1, eid[:, None])[:, 0]
    keep = place < cap
    tok = torch.arange(t, device=xt.device).repeat_interleave(k)
    return tok[keep], eid[keep], gate.reshape(-1)[keep]


def moe_layer(x: torch.Tensor, p, cfg, groups: Sequence[Tuple[int, int]],
              mm: common.Products) -> torch.Tensor:
    """x (B, T, d), normed; each group (s0, s1) of columns is one call of
    the layer over every row."""
    b, t, d = x.shape
    moe = cfg["moe"]
    flat = x.reshape(b * t, d)
    toks: List[torch.Tensor] = []
    eids: List[torch.Tensor] = []
    gates: List[torch.Tensor] = []
    for s0, s1 in groups:
        # the group's tokens, row-major, as flat indices into x
        idx = (torch.arange(b, device=x.device)[:, None] * t
               + torch.arange(s0, s1, device=x.device)[None, :]).reshape(-1)
        tok, eid, gate = _route(flat[idx], p["router"], moe)
        toks.append(idx[tok])
        eids.append(eid)
        gates.append(gate)
    tok, eid, gate = torch.cat(toks), torch.cat(eids), torch.cat(gates)
    out = torch.zeros_like(flat)
    for e in range(moe["n_experts"]):
        sel = eid == e
        if not bool(sel.any()):
            continue
        rows = flat[tok[sel]]
        y = common.glu(rows, p["w_gate"][e], p["w_up"][e], p["w_down"][e], mm)
        out.index_add_(0, tok[sel], y * gate[sel, None])
    return out.reshape(b, t, d)


def logits_at(w, cfg, tokens: torch.Tensor, at: torch.Tensor, *, groups=None,
              fp8: bool = False) -> torch.Tensor:
    """Logits (N, vocab) at the positions ``at`` (N, 2: row, column) of a
    causal forward over ``tokens`` (B, T); ``groups`` lists the column
    ranges that were one call of the model (the prefill, then each decode
    step), all columns one call when None."""
    mm = common.Products(fp8)
    hd = int(cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"])
    groups = groups or [(0, tokens.shape[1])]
    x = w["embed"][tokens.long()].float()
    pos = common.positions_of(tokens.shape[1], x.device)
    for i in range(cfg["n_layers"]):
        p = common.layer_of(w["blocks"], i)
        x = x + common.attention_block(common.rmsnorm(x, p["ln1"]["scale"]), p["attn"],
                                       cfg, pos, mm, hd)
        x = x + moe_layer(common.rmsnorm(x, p["ln2"]["scale"]), p["moe"], cfg, groups, mm)
    return common.lm_head(w, cfg, x[at[:, 0], at[:, 1]], mm)
