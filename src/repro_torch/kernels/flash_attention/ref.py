"""Plain PyTorch oracle: softmax(q k^T * scale + mask) v with GQA support."""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, S, D); k/v: (B, Hkv, S, D) with Hq % Hkv == 0.  The causal
    mask is ``tril(S, S)``, as the reference's, so it takes Sq == Sk."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if hkv != hq:
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        logits = torch.where(mask, logits, torch.full_like(logits, -math.inf))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
