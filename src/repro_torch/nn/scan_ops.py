"""Chunked gated linear attention in plain PyTorch: the twin of the JAX
package's ``nn/scan_ops.py`` — ``chunked_gla_torch`` (a loop over chunks,
the same math as ``chunked_gla_jnp``; also the plain version of the GLA
kernel, ``kernels/mlstm_chunk``) and ``gla_decode_step`` (one token)."""
from __future__ import annotations

from typing import Tuple

import torch


def chunked_gla_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_decay: torch.Tensor, gain: torch.Tensor, chunk: int = 256,
                      normalize: bool = True, scale: float = 1.0) -> torch.Tensor:
    """q/k: (B,H,S,Dk); v: (B,H,S,Dv); log_decay/gain: (B,H,S).  Returns
    (B,H,S,Dv) in ``q.dtype``.  A chunk that does not divide S is halved
    until it does, as the reference's.  Computes in float32, or in float64
    where q is float64 (the yardstick of the tf32x3 path's error bound)."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    n = s // chunk
    bh = b * h

    def seg(x, dlast):
        return x.reshape(bh, n, chunk, dlast).transpose(0, 1)  # (n, bh, L, d)

    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qs = seg(q.to(acc) * scale, dk)
    ks = seg(k.to(acc), dk)
    vs = seg(v.to(acc), dv)
    lds = log_decay.reshape(bh, n, chunk).transpose(0, 1).to(acc)
    gs = gain.reshape(bh, n, chunk).transpose(0, 1).to(acc)
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))

    C = torch.zeros((bh, dk, dv), dtype=acc, device=q.device)
    nvec = torch.zeros((bh, dk), dtype=acc, device=q.device)
    outs = []
    for qc, kc, vc, ldc, gc in zip(qs, ks, vs, lds, gs):
        cum = torch.cumsum(ldc, dim=-1)                      # (bh, L)
        # mask inside the exp (upper triangle would overflow: inf*0=NaN)
        dmat = torch.where(tril, cum[:, :, None] - cum[:, None, :],
                           torch.full((), -torch.inf, device=q.device))
        scores = torch.einsum("btd,bsd->bts", qc, kc) * torch.exp(dmat) * gc[:, None, :]
        h_intra = torch.einsum("bts,bsp->btp", scores, vc)
        ecum = torch.exp(cum)
        h_inter = ecum[:, :, None] * torch.einsum("btd,bdp->btp", qc, C)
        out = h_intra + h_inter
        if normalize:
            norm = scores.sum(dim=-1) + ecum * torch.einsum("btd,bd->bt", qc, nvec)
            out = out / torch.clamp(norm.abs(), min=1.0)[..., None]
        total = cum[:, -1]
        w = torch.exp(total[:, None] - cum) * gc
        kw = kc * w[..., None]
        C = torch.exp(total)[:, None, None] * C + torch.einsum("bsd,bsp->bdp", kw, vc)
        nvec = torch.exp(total)[:, None] * nvec + kw.sum(dim=1)
        outs.append(out)
    out = torch.stack(outs).transpose(0, 1).reshape(b, h, s, dv)
    return out.to(q.dtype)


def gla_decode_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_decay: torch.Tensor, gain: torch.Tensor,
                    state: Tuple[torch.Tensor, torch.Tensor], normalize: bool = True,
                    scale: float = 1.0) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One token's state update, the twin of the JAX package's
    ``gla_decode_step``: ``C = e^ld C + g k v^T``, ``n = e^ld n + g k`` in
    float32, then ``q C`` (over ``max(|q n|, 1)`` when ``normalize``).
    q/k: (B,H,Dk); v: (B,H,Dv); log_decay/gain: (B,H); state: (C
    (B,H,Dk,Dv), n (B,H,Dk)).  Returns (out (B,H,Dv) in ``q.dtype``, the
    new (C, n)); the state passed in is not written."""
    C, nvec = state
    dec = torch.exp(log_decay.float())[..., None, None]
    g = gain.float()[..., None, None]
    kf, vf = k.float(), v.float()
    C = dec * C + g * (kf[..., :, None] * vf[..., None, :])
    nvec = dec[..., 0] * nvec + g[..., 0] * kf
    qf = q.float() * scale
    out = torch.einsum("bhd,bhdp->bhp", qf, C)
    if normalize:
        denom = torch.clamp(torch.einsum("bhd,bhd->bh", qf, nvec).abs(), min=1.0)
        out = out / denom[..., None]
    return out.to(q.dtype), (C, nvec)
