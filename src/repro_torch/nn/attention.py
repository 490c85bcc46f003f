"""GQA attention pieces the serving engine uses: parameter init, the
causal mask and the reference attention ``mha`` (float32 scores)."""
from __future__ import annotations

from typing import Optional

import torch

from .core import Params, dense_init

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg, dtype, device=None) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, d, h * hd, dtype, device),
        "wk": dense_init(gen, d, kv * hd, dtype, device),
        "wv": dense_init(gen, d, kv * hd, dtype, device),
        "wo": dense_init(gen, h * hd, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,S,H,hd), k: (B,T,KV,hd) -> (B,H,S,T) without materializing the
    repeated KV heads (grouped einsum)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    out = torch.einsum("bskgd,btkd->bkgst", qg, k)
    return out.reshape(b, h, s, k.shape[1])


def _gqa_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B,H,S,T), v: (B,T,KV,hd) -> (B,S,H,hd)."""
    b, h, s, t = p.shape
    kvh = v.shape[2]
    pg = p.reshape(b, kvh, h // kvh, s, t)
    out = torch.einsum("bkgst,btkd->bskgd", pg, v)
    return out.reshape(b, s, h, out.shape[-1])


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor], sm_scale: float) -> torch.Tensor:
    """Reference attention.  q: (B,S,H,hd); k/v: (B,T,KV,hd); mask
    broadcastable to (B,1,S,T) (True = attend)."""
    scores = _gqa_scores(q.float(), k.float()) * sm_scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=scores.device))
    p = torch.softmax(scores, dim=-1)
    out = _gqa_values(p, v.float())
    return out.to(q.dtype)


def causal_mask(s: int, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))[None, None]
