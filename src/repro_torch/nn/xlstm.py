"""xLSTM blocks, the twin of the JAX package's ``nn/xlstm.py``: mLSTM
(matrix memory, chunkwise-parallel) and sLSTM (scalar memory, a
sequential loop with exponential gating and a max stabiliser).

The mLSTM runs on ``chunked_gla_torch`` and ``gla_decode_step``, as the
reference runs it on ``chunked_gla_jnp``: the GLA kernel is not on the
model path.  A state passed to either block is donated: its buffers are
written in place with the new state and returned."""
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
                      state: Optional[Dict[str, torch.Tensor]] = None):
    b, s, d = x.shape
    inner, nh, hd = mlstm_dims(cfg)
    up = linear(x, p["up_proj"])
    xin, z = torch.chunk(up, 2, dim=-1)

    conv_state = state["conv"] if state is not None else None
    cx, new_conv = causal_conv1d(xin, p["conv_w"], conv_state)
    cx = F.silu(cx)

    def heads(t):
        return t.reshape(b, s, nh, hd).transpose(1, 2)

    q, k, v = heads(linear(cx, p["wq"])), heads(linear(cx, p["wk"])), heads(linear(xin, p["wv"]))
    # the gates in float32, outside oplib, as in the reference
    cxf = cx.float()
    ig = (torch.einsum("bsi,ih->bsh", cxf, p["w_igate"]) + p["b_igate"]).transpose(1, 2)
    fg = (torch.einsum("bsi,ih->bsh", cxf, p["w_fgate"]) + p["b_fgate"]).transpose(1, 2)
    log_decay = F.logsigmoid(fg)
    gain = torch.exp(torch.clamp(ig, max=8.0))
    scale = float(hd) ** -0.5

    new_state = None
    if state is None or s > 1:
        h = chunked_gla_torch(q, k, v, log_decay, gain, chunk=chunk, normalize=True, scale=scale)
        if state is not None:
            _, st = _final_state(q, k, v, log_decay, gain)
            new_state = _donate(state, {"conv": new_conv, "C": st[0], "n": st[1]})
    else:
        h, st = gla_decode_step(q[:, :, 0], k[:, :, 0], v[:, :, 0], log_decay[:, :, 0],
                                gain[:, :, 0], (state["C"], state["n"]), normalize=True,
                                scale=scale)
        h = h[:, :, None, :]
        new_state = _donate(state, {"conv": new_conv, "C": st[0], "n": st[1]})

    h = h.transpose(1, 2).reshape(b, s, inner)
    h = h + p["skip_scale"] * cx
    h = h * F.silu(z)
    return linear(h, p["down_proj"]), new_state


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
                      state: Optional[Dict[str, torch.Tensor]] = None):
    """Sequential sLSTM with exponential gating and max-stabilizer: a
    Python loop over the time steps, ``h, c, n, m`` in float32 on the
    tensors' device (no host sync inside the loop)."""
    b, s, d = x.shape
    nh = cfg.xlstm.n_heads
    hd = d // nh
    wx = (linear(x, p["w_gates"]) + p["b_gates"]).float()  # (b,s,4d)
    wx = wx.reshape(b, s, 4, nh, hd)

    if state is None:
        zeros = torch.zeros((b, nh, hd), dtype=torch.float32, device=x.device)
        h, c, n, m = zeros, zeros, torch.ones_like(zeros), zeros
    else:
        h, c, n, m = state["h"], state["c"], state["n"], state["m"]

    r = p["r_gates"].float()  # (nh, hd, 4hd)
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
    a, g2 = torch.chunk(linear(out_h, p["w_up"]), 2, dim=-1)
    out = linear(F.gelu(a, approximate="tanh") * g2, p["w_down"])
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
