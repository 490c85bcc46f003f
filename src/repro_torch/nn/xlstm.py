"""xLSTM blocks, the twin of the JAX package's ``nn/xlstm.py``: mLSTM
(matrix memory, chunkwise-parallel) and sLSTM (scalar memory, a
sequential loop with exponential gating and a max stabiliser).

The mLSTM runs on ``chunked_gla_torch`` and ``gla_decode_step``, as the
reference runs it on ``chunked_gla_jnp``: the GLA kernel is not on the
model path.  A state passed to either block is donated: its buffers are
written in place with the new state and returned.

In a rank of the sharded step (``dist``, ``parallel/sharded.py``) each
block is one tensor-parallel region (f at its input, g after its last,
row-parallel projection; every gradient inside is partial, so its
replicated parameters are summed over 'model'), laid out the same way in
training, prefill and decode:

* mLSTM: ``up_proj``'s output, whose halves ``xin | z`` fall on
  different ranks, and ``conv_w`` are gathered whole (adjoint: a
  reduce-scatter), so ``cx`` is whole where ``wq`` / ``wk`` / ``wv`` and
  the gates read it.  Where the heads divide over 'model' the column
  blocks of ``wq`` / ``wk`` / ``wv`` are whole heads and each rank runs
  the GLA on its own; else the three are gathered whole and every rank
  runs all heads.  ``down_proj`` takes the rank's channels (or its row
  block of all of them), summed over 'model'.  A state of the rank's heads
  is joined over 'model' before it is written.
* sLSTM: ``w_gates``, ``r_gates`` and ``w_up`` are gathered whole once a
  call (a rank holds one gate of every head, and the recurrence needs all
  four at every step), so the time loop holds no collective; ``w_down``
  is row-parallel (a whole one, whose rows do not divide over 'model',
  cut into near-equal row blocks).

States come in whole (the step re-lays the cache's layout out around the
call)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .core import Params, _normal, causal_conv1d, dense_init, linear
from .scan_ops import chunked_gla_torch, gla_decode_step
from .ssm import _donate, _final_state


# ---------------------------------------------------------------- mLSTM
def mlstm_dims(cfg):
    inner = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    nh = cfg.xlstm.n_heads
    return inner, nh, inner // nh


def mlstm_block_init(gen: torch.Generator, cfg, dtype, device=None) -> Params:
    d = cfg.d_model
    inner, nh, hd = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "up_proj": dense_init(gen, d, 2 * inner, dtype, device),
        "conv_w": _normal(gen, (cfg.xlstm.conv_width, inner), 0.2, dtype, device),
        "wq": dense_init(gen, inner, inner, dtype, device),
        "wk": dense_init(gen, inner, inner, dtype, device),
        "wv": dense_init(gen, inner, inner, dtype, device),
        "w_igate": dense_init(gen, inner, nh, torch.float32, device, scale=0.01),
        "w_fgate": dense_init(gen, inner, nh, torch.float32, device, scale=0.01),
        "b_igate": torch.zeros((nh,), **f32),
        "b_fgate": torch.full((nh,), 3.0, **f32),  # init: mostly remember
        "skip_scale": torch.ones((inner,), dtype=dtype, device=device),
        "down_proj": dense_init(gen, inner, d, dtype, device),
    }


def mlstm_block_apply(p: Params, x: torch.Tensor, cfg, chunk: int = 256,
                      state: Optional[Dict[str, torch.Tensor]] = None, dist=None):
    b, s, d = x.shape
    inner, nh, hd = mlstm_dims(cfg)
    conv_w, (wq, wk, wv), h0, hl = p["conv_w"], (p["wq"], p["wk"], p["wv"]), 0, nh
    if dist is not None:
        x = dist.enter(x)
    up = linear(x, p["up_proj"])
    if dist is not None:
        up = dist.whole(up, -1, 2 * inner)
        conv_w = dist.whole(conv_w, 1, inner)
        (wq, wk, wv), h0, hl = dist.head_split((wq, wk, wv), nh, inner)
    xin, z = torch.chunk(up, 2, dim=-1)

    conv_state = state["conv"] if state is not None else None
    cx, new_conv = causal_conv1d(xin, conv_w, conv_state)
    cx = F.silu(cx)

    def heads(t):
        return t.reshape(b, s, hl, hd).transpose(1, 2)

    q, k, v = heads(linear(cx, wq)), heads(linear(cx, wk)), heads(linear(xin, wv))
    # the gates (of heads h0 .. h0 + hl: all of them on one device) in
    # float32, outside oplib, as in the reference
    cxf = cx.float()
    mine = slice(h0, h0 + hl)
    ig = (torch.einsum("bsi,ih->bsh", cxf, p["w_igate"][:, mine])
          + p["b_igate"][mine]).transpose(1, 2)
    fg = (torch.einsum("bsi,ih->bsh", cxf, p["w_fgate"][:, mine])
          + p["b_fgate"][mine]).transpose(1, 2)
    log_decay = F.logsigmoid(fg)
    gain = torch.exp(torch.clamp(ig, max=8.0))
    scale = float(hd) ** -0.5

    st = None
    if state is None or s > 1:
        h = chunked_gla_torch(q, k, v, log_decay, gain, chunk=chunk, normalize=True, scale=scale)
        if state is not None:
            _, st = _final_state(q, k, v, log_decay, gain)
    else:
        h, st = gla_decode_step(q[:, :, 0], k[:, :, 0], v[:, :, 0], log_decay[:, :, 0],
                                gain[:, :, 0], (state["C"][:, mine], state["n"][:, mine]),
                                normalize=True, scale=scale)
        h = h[:, :, None, :]
    new_state = None
    if state is not None:
        if dist is not None:
            st = tuple(dist.join_heads(t, nh) for t in st)
        new_state = _donate(state, {"conv": new_conv, "C": st[0], "n": st[1]})

    # this rank's channels (every channel on one device)
    ch = slice(h0 * hd, (h0 + hl) * hd)
    h = h.transpose(1, 2).reshape(b, s, hl * hd)
    h = h + p["skip_scale"][ch] * cx[..., ch]
    h = h * F.silu(z[..., ch])
    if dist is None:
        return linear(h, p["down_proj"]), new_state
    return dist.rows(h, p["down_proj"], inner), new_state


def mlstm_init_state(cfg, batch: int, dtype, device="cuda") -> Dict[str, torch.Tensor]:
    inner, nh, hd = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.xlstm.conv_width - 1, inner), dtype=dtype, device=device),
        "C": torch.zeros((batch, nh, hd, hd), **f32),
        "n": torch.zeros((batch, nh, hd), **f32),
    }


# ---------------------------------------------------------------- sLSTM
def slstm_block_init(gen: torch.Generator, cfg, dtype, device=None) -> Params:
    d = cfg.d_model
    nh = cfg.xlstm.n_heads
    hd = d // nh
    dff = int(cfg.xlstm.proj_factor_slstm * d)
    return {
        "w_gates": dense_init(gen, d, 4 * d, dtype, device),            # i,f,z,o
        "r_gates": _normal(gen, (nh, hd, 4 * hd), hd ** -0.5, dtype, device),
        "b_gates": torch.zeros((4 * d,), dtype=torch.float32, device=device),
        "w_up": dense_init(gen, d, 2 * dff, dtype, device),
        "w_down": dense_init(gen, dff, d, dtype, device),
    }


def slstm_block_apply(p: Params, x: torch.Tensor, cfg,
                      state: Optional[Dict[str, torch.Tensor]] = None, dist=None):
    """Sequential sLSTM with exponential gating and max-stabilizer: a
    Python loop over the time steps, ``h, c, n, m`` in float32 on the
    tensors' device (no host sync inside the loop)."""
    b, s, d = x.shape
    nh = cfg.xlstm.n_heads
    hd = d // nh
    w_gates, r_gates, w_up = p["w_gates"], p["r_gates"], p["w_up"]
    dff = int(cfg.xlstm.proj_factor_slstm * d)
    if dist is not None:
        x = dist.enter(x)
        w_gates = dist.whole(w_gates, 1, 4 * d)
        r_gates = dist.whole(r_gates, 2, 4 * hd)
        w_up = dist.whole(w_up, 1, 2 * dff)
    wx = (linear(x, w_gates) + p["b_gates"]).float()  # (b,s,4d)
    wx = wx.reshape(b, s, 4, nh, hd)

    if state is None:
        zeros = torch.zeros((b, nh, hd), dtype=torch.float32, device=x.device)
        h, c, n, m = zeros, zeros, torch.ones_like(zeros), zeros
    else:
        h, c, n, m = state["h"], state["c"], state["n"], state["m"]

    r = r_gates.float()  # (nh, hd, 4hd)
    hs = []
    for t in range(s):
        rec = torch.einsum("bhd,hdk->bhk", h, r).reshape(b, nh, 4, hd).transpose(1, 2)
        g = wx[:, t] + rec                       # (b,4,nh,hd)
        gi, gf, gz, go = g.unbind(1)
        logf = F.logsigmoid(gf)
        m_new = torch.maximum(logf + m, gi)
        i_p = torch.exp(gi - m_new)
        f_p = torch.exp(logf + m - m_new)
        c = f_p * c + i_p * torch.tanh(gz)
        n = f_p * n + i_p
        h = torch.sigmoid(go) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    out_h = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)

    # GLU FFN (proj factor 4/3)
    a, g2 = torch.chunk(linear(out_h, w_up), 2, dim=-1)
    hh = F.gelu(a, approximate="tanh") * g2
    out = linear(hh, p["w_down"]) if dist is None else dist.rows(hh, p["w_down"], dff)
    new_state = None
    if state is not None:
        new_state = _donate(state, {"h": h, "c": c, "n": n, "m": m})
    return out, new_state


def slstm_init_state(cfg, batch: int, device="cuda") -> Dict[str, torch.Tensor]:
    nh = cfg.xlstm.n_heads
    hd = cfg.d_model // nh
    z = dict(size=(batch, nh, hd), dtype=torch.float32, device=device)
    return {"h": torch.zeros(**z), "c": torch.zeros(**z), "n": torch.ones(**z),
            "m": torch.zeros(**z)}
