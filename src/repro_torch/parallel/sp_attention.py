"""Sequence-parallel decode attention (long-context serving), the twin of
the JAX package's ``parallel/sp_attention.py``.

The KV cache is sharded along the *sequence* dimension over an axis.
Each shard computes a flash-decode partial — (local max m, local sum l,
local weighted acc) — and the partials are combined exactly with one
``pmax`` and two ``psum``\\ s (log-sum-exp algebra).  Plain PyTorch, as
the reference's is plain ``jnp``.
"""
from __future__ import annotations

import torch

from . import spmd

NEG_INF = -1e30


def _mask(logits: torch.Tensor, s: int, valid_len) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.int32, device=logits.device)
    valid = torch.as_tensor(valid_len, device=logits.device).reshape(-1, 1, 1)
    return torch.where(pos[None, None, :] < valid, logits,
                       torch.tensor(NEG_INF, dtype=logits.dtype, device=logits.device))


def sp_decode_attention(q: torch.Tensor, k_shard: torch.Tensor, v_shard: torch.Tensor,
                        valid_len_local, sm_scale: float,
                        axis: str = "data") -> torch.Tensor:
    """Inside shard_map.  q: (B, H, hd) replicated over ``axis``;
    k_shard/v_shard: (B, S_local, H, hd); valid_len_local: () or (B,) —
    number of valid cached positions in this shard.  Returns (B, H, hd).
    """
    s_loc = k_shard.shape[1]
    kf = k_shard.to(torch.float32)
    vf = v_shard.to(torch.float32)
    qf = q.to(torch.float32) * sm_scale

    logits = _mask(torch.einsum("bhd,bshd->bhs", qf, kf), s_loc, valid_len_local)
    m_loc = torch.amax(logits, dim=-1)                     # (B, H)
    m_glob = spmd.pmax(m_loc, axis)
    p = torch.exp(logits - m_glob[..., None])
    l_loc = torch.sum(p, dim=-1)                           # (B, H)
    acc_loc = torch.einsum("bhs,bshd->bhd", p, vf)
    l_glob = spmd.psum(l_loc, axis)
    acc_glob = spmd.psum(acc_loc, axis)
    return (acc_glob / torch.clamp(l_glob, min=1e-30)[..., None]).to(q.dtype)


def full_decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              valid_len, sm_scale: float) -> torch.Tensor:
    """Unsharded oracle."""
    logits = torch.einsum("bhd,bshd->bhs", q.to(torch.float32) * sm_scale, k.to(torch.float32))
    w = torch.softmax(_mask(logits, k.shape[1], valid_len), dim=-1)
    return torch.einsum("bhs,bshd->bhd", w, v.to(torch.float32)).to(q.dtype)
