"""Chunked gated linear attention in plain PyTorch: the twin of the JAX
package's ``nn/scan_ops.py::chunked_gla_jnp`` (a loop over chunks, the
same math), and the plain version of the GLA kernel
(``kernels/mlstm_chunk``)."""
from __future__ import annotations

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
