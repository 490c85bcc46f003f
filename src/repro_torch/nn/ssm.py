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
call) and leaves whole.

Spans (``obs.trace``, timed on the device): ``ssm.mixer`` around each
layer's call (``rows``, ``width``, ``tokens`` = rows x width, ``kind``
prefill or decode) and, nested in it, ``ssm.scan`` around the chunked
scan with the prefill's final state, or around the one-token update."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..obs import trace as obs_trace
from .core import Params, _normal, causal_conv1d, dense_init, linear
from .scan_ops import chunked_gla_torch, gla_decode_step


def mamba2_dims(cfg):
    inner = cfg.ssm.expand * cfg.d_model
    n_heads = cfg.ssm.n_ssm_heads or inner // cfg.ssm.head_dim
    return inner, n_heads, cfg.ssm.d_state


def mamba2_init(gen: torch.Generator, cfg, dtype, device=None) -> Params:
    d = cfg.d_model
    inner, nh, ns = mamba2_dims(cfg)
    conv_ch = inner + 2 * ns
    f32 = dict(dtype=torch.float32, device=device)
    p = {
        "in_proj": dense_init(gen, d, 2 * inner + 2 * ns + nh, dtype, device),
        "conv_w": _normal(gen, (cfg.ssm.conv_width, conv_ch), 0.2, dtype, device),
        "dt_bias": torch.zeros((nh,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "out_proj": dense_init(gen, inner, d, dtype, device),
        "norm_scale": torch.ones((inner,), dtype=dtype, device=device),
    }
    if cfg.ssm.conv_bias:
        p["conv_bias"] = torch.zeros((conv_ch,), dtype=dtype, device=device)
    return p


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


def _chunked_scan(q, k, v, log_decay, gain, chunk: int) -> torch.Tensor:
    """``chunked_gla_torch`` over a sequence padded on the right to whole
    chunks, where it is longer than one: a padded step has gain 0 and
    log-decay 0, so it leaves the state as it is, and its outputs are cut
    off.  (Unpadded, a length that no chunk divides would halve the chunk
    down to one that does, as small as one step.)"""
    s = q.shape[2]
    pad = (-s) % chunk if s > chunk else 0
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_decay, gain = (F.pad(t, (0, pad)) for t in (log_decay, gain))
    return chunked_gla_torch(q, k, v, log_decay, gain, chunk=chunk, normalize=False)[:, :, :s]


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
    step = state is not None and s == 1
    with obs_trace.span("ssm.mixer", device=True, rows=b, width=s, tokens=b * s,
                        kind="decode" if step else "prefill"):
        return _mixer(p, x, cfg, chunk, state, step, dist)


def _mixer(p: Params, x: torch.Tensor, cfg, chunk: int, state, step: bool, dist):
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
    if "conv_bias" in p:
        conv_out = conv_out + p["conv_bias"]
    conv_out = F.silu(conv_out)
    xin, B, C = torch.split(conv_out, [inner, ns, ns], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                         # (B,S,nh)
    A = -torch.exp(p["A_log"])                                         # (nh,)

    xh = xin.reshape(b, s, nh, hd).transpose(1, 2)                     # (B,nh,S,hd)
    Bh = B[:, None].expand(b, nh, s, ns)
    Ch = C[:, None].expand(b, nh, s, ns)
    dth = dt.transpose(1, 2)                                           # (B,nh,S)
    log_decay = dth * A[None, :, None]

    with obs_trace.span("ssm.scan", device=True):
        if not step:
            y = _chunked_scan(Ch, Bh, xh, log_decay, dth, chunk)
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
    y = _gated_rmsnorm(y, z, p["norm_scale"], cfg.norm_eps)
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
