"""Sequential-recurrence oracle for the chunked gated linear attention."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gla_ref(q, k, v, log_decay, gain, normalize: bool = True, scale: float = 1.0):
    """Step-by-step recurrence (a loop over time)."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    qf = q.reshape(b * h, s, dk).float() * scale
    kf = k.reshape(b * h, s, dk).float()
    vf = v.reshape(b * h, s, dv).float()
    dec = torch.exp(log_decay.reshape(b * h, s).float())
    gn = gain.reshape(b * h, s).float()
    C = torch.zeros((b * h, dk, dv), dtype=torch.float32, device=q.device)
    n = torch.zeros((b * h, dk), dtype=torch.float32, device=q.device)
    hs = []
    for t in range(s):
        qt, kt, vt, dt, gt = qf[:, t], kf[:, t], vf[:, t], dec[:, t], gn[:, t]
        C = dt[:, None, None] * C + gt[:, None, None] * (kt[:, :, None] * vt[:, None, :])
        n = dt[:, None] * n + gt[:, None] * kt
        h_t = torch.einsum("bd,bdp->bp", qt, C)
        if normalize:
            denom = torch.clamp(torch.einsum("bd,bd->b", qt, n).abs(), min=1.0)
            h_t = h_t / denom[:, None]
        hs.append(h_t)
    return torch.stack(hs, dim=1).reshape(b, h, s, dv).to(q.dtype)


def mlstm_ref(q, k, v, i_gate, f_gate):
    dk = q.shape[-1]
    log_decay = F.logsigmoid(f_gate)
    gain = torch.exp(torch.clamp(i_gate, max=8.0))
    return gla_ref(q, k, v, log_decay, gain, normalize=True, scale=float(dk) ** -0.5)
