"""Mamba2 (SSD) block with train (chunked), prefill and single-step decode
paths: the twin of the JAX package's ``nn/ssm.py``.

The SSD runs on ``chunked_gla_torch`` and ``gla_decode_step`` (plain
PyTorch), as the reference runs it on ``chunked_gla_jnp``: the GLA kernel
(``kernels/mlstm_chunk``) is not on the model path.  A state passed to
``mamba2_apply`` is donated: its buffers are written in place with the
new state and returned, so the caller must not use it again.

In a rank of the sharded step (``dist``, ``parallel/sharded.py``) a
Mamba2 layer is one tensor-parallel region, laid out the same way in
training, prefill and decode: the stream enters it (f); ``in_proj``'s
output, whose column blocks straddle ``z | xin | B | C | dt``, is gathered
whole over 'model' (its adjoint a reduce-scatter), as is ``conv_w``; the
conv, the SSD and the gated norm then run on every head, so the norm's
mean of squares needs no collective; ``out_proj`` is row-parallel, each
rank's block of ``y`` times its rows, summed over 'model' (g).  Every
rank's gradient in the region is partial, so the replicated ``A_log``,
``D``, ``dt_bias`` and ``norm_scale`` are summed over 'model'.  The
state comes in whole (the step re-lays the cache's layout out around the
call) and leaves whole."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .core import Params, _normal, causal_conv1d, dense_init, linear
from .scan_ops import chunked_gla_torch, gla_decode_step


def mamba2_dims(cfg):
    inner = cfg.ssm.expand * cfg.d_model
    n_heads = inner // cfg.ssm.head_dim
    return inner, n_heads, cfg.ssm.d_state


def mamba2_init(gen: torch.Generator, cfg, dtype, device=None) -> Params:
    d = cfg.d_model
    inner, nh, ns = mamba2_dims(cfg)
    conv_ch = inner + 2 * ns
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, d, 2 * inner + 2 * ns + nh, dtype, device),
        "conv_w": _normal(gen, (cfg.ssm.conv_width, conv_ch), 0.2, dtype, device),
        "dt_bias": torch.zeros((nh,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "out_proj": dense_init(gen, inner, d, dtype, device),
        "norm_scale": torch.ones((inner,), dtype=dtype, device=device),
    }


def _gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    xf = x.float() * F.silu(z.float())
    nrm = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
    return (xf * nrm * scale.float()).to(z.dtype)


def _project(p: Params, x: torch.Tensor, cfg, dist=None):
    inner, nh, ns = mamba2_dims(cfg)
    zxbcdt = linear(x, p["in_proj"])
    if dist is not None:
        zxbcdt = dist.whole(zxbcdt, -1, 2 * inner + 2 * ns + nh)
    return torch.split(zxbcdt, [inner, inner, ns, ns, nh], dim=-1)  # z, xin, B, C, dt


def _donate(state: Dict[str, torch.Tensor],
            new: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Write ``new`` into ``state``'s buffers; return them."""
    for key, value in new.items():
        state[key].copy_(value)
    return state


def mamba2_apply(p: Params, x: torch.Tensor, cfg, chunk: int = 256,
                 state: Optional[Dict[str, torch.Tensor]] = None, dist=None
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B, S, D).  With ``state`` given (prefill, or one-token decode)
    the new state is written into its buffers (donated) and returned."""
    b, s, d = x.shape
    inner, nh, ns = mamba2_dims(cfg)
    hd = cfg.ssm.head_dim
    conv_w = p["conv_w"]
    if dist is not None:
        x = dist.enter(x)
        conv_w = dist.whole(conv_w, 1, inner + 2 * ns)
    z, xin, B, C, dt = _project(p, x, cfg, dist)

    conv_in = torch.cat([xin, B, C], dim=-1)
    conv_state = state["conv"] if state is not None else None
    conv_out, new_conv = causal_conv1d(conv_in, conv_w, conv_state)
    conv_out = F.silu(conv_out)
    xin, B, C = torch.split(conv_out, [inner, ns, ns], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                         # (B,S,nh)
    A = -torch.exp(p["A_log"])                                         # (nh,)

    xh = xin.reshape(b, s, nh, hd).transpose(1, 2)                     # (B,nh,S,hd)
    Bh = B[:, None].expand(b, nh, s, ns)
    Ch = C[:, None].expand(b, nh, s, ns)
    dth = dt.transpose(1, 2)                                           # (B,nh,S)
    log_decay = dth * A[None, :, None]

    if state is None or s > 1:
        y = chunked_gla_torch(Ch, Bh, xh, log_decay, dth, chunk=chunk, normalize=False)
        new_ssm = None
        if state is not None:
            # prefill: the final state from a separate float32 pass
            _, new_ssm = _final_state(Ch, Bh, xh, log_decay, dth)
    else:
        y, new_ssm = gla_decode_step(
            Ch[:, :, 0], Bh[:, :, 0], xh[:, :, 0], log_decay[:, :, 0], dth[:, :, 0],
            (state["C"], state["n"]), normalize=False)
        y = y[:, :, None, :]

    y = (y + p["D"][None, :, None, None] * xh).to(x.dtype)
    y = y.transpose(1, 2).reshape(b, s, inner)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    out = linear(y, p["out_proj"]) if dist is None else dist.rows(y, p["out_proj"], inner)
    if state is None:
        return out, None
    return out, _donate(state, {"conv": new_conv, "C": new_ssm[0], "n": new_ssm[1]})


def _final_state(q, k, v, log_decay, gain):
    """The end-of-sequence recurrent state (for prefill), in float32."""
    cum = torch.cumsum(log_decay.float(), dim=-1)
    total = cum[..., -1]
    w = torch.exp(total[..., None] - cum) * gain
    kw = k.float() * w[..., None]
    C = torch.einsum("bhsd,bhsp->bhdp", kw, v.float())
    n = kw.sum(dim=2)
    return None, (C, n)


def mamba2_init_state(cfg, batch: int, dtype, device="cuda") -> Dict[str, torch.Tensor]:
    inner, nh, ns = mamba2_dims(cfg)
    conv_ch = inner + 2 * ns
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, conv_ch), dtype=dtype, device=device),
        "C": torch.zeros((batch, nh, ns, cfg.ssm.head_dim), **f32),
        "n": torch.zeros((batch, nh, ns), **f32),
    }
