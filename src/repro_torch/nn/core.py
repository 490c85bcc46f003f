"""Core NN building blocks: plain functions on tensors, parameters in
dicts, initialization from an explicit ``torch.Generator``.

All dense projections route through ``repro_torch.core.oplib.linear`` —
the Stripe-compiled op layer (an einsum on the ``torch`` backend; the
Stripe-generated CUDA kernel on the ``cuda`` backend).  Ported: the dense
family's pieces (embeddings, norms, RoPE, qk-norm, the MLP, the
cross-entropy, the depthwise causal conv) and the parameter initializers."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import oplib

Params = Dict[str, Any]


def param_dtype(cfg) -> torch.dtype:
    from ..core.lower_torch import torch_dtype
    return torch_dtype(cfg.dtype)


def _normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """N(0, scale^2) samples drawn on the generator's device, then moved;
    on the ``meta`` device, the shape and type alone (nothing is drawn)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    out = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (out * scale).to(device=device, dtype=dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device=None,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / float(d_in) ** 0.5
    return _normal(gen, (d_in, d_out), scale, dtype, device)


def linear(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           act: Optional[str] = None) -> torch.Tensor:
    if oplib.get_backend() == "torch":
        out = torch.einsum("...k,kn->...n", x, w)
        if bias is not None:
            out = out + bias
        if act is not None:
            out = _ACT[act](out)
        return out
    return oplib.linear(x, w, bias, act)


# ``gelu`` is the tanh approximation here, as in the JAX package's _ACT
# (the Stripe intrinsic ``gelu`` is the exact erf form).
_ACT = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "relu2": lambda x: torch.square(torch.relu(x)),
}


# ---------------------------------------------------------------- norms
def norm_init(d: int, kind: str, dtype, device=None) -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        nrm = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
        out = xf * nrm * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float()
        out = out + p["bias"].float()
    return out.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS over the head dim."""
    xf = x.float()
    nrm = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
    return (xf * nrm * scale.float()).to(x.dtype)


# ----------------------------------------------------------------- RoPE
def rope_freqs(hd_rot: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd_rot, 2, dtype=torch.float32, device=device) / hd_rot
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, mode: str, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int.  mode: full|half|none."""
    if mode == "none":
        return x
    hd = x.shape[-1]
    rot = hd if mode == "full" else hd // 2
    freqs = rope_freqs(rot, theta, x.device)  # (rot/2,)
    ang = positions[..., None].float() * freqs  # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., : rot // 2], x_rot[..., rot // 2:]
    xf1, xf2 = x1.float(), x2.float()
    r1 = xf1 * cos - xf2 * sin
    r2 = xf2 * cos + xf1 * sin
    return torch.cat([r1.to(x.dtype), r2.to(x.dtype), x_pass], dim=-1)


# ------------------------------------------------------------------ MLP
def mlp_init(gen: torch.Generator, d: int, d_ff: int, act: str, dtype, device=None) -> Params:
    if act.endswith("_glu"):
        return {
            "w_gate": dense_init(gen, d, d_ff, dtype, device),
            "w_up": dense_init(gen, d, d_ff, dtype, device),
            "w_down": dense_init(gen, d_ff, d, dtype, device),
        }
    return {"w_up": dense_init(gen, d, d_ff, dtype, device),
            "w_down": dense_init(gen, d_ff, d, dtype, device)}


def mlp_apply(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    if act.endswith("_glu"):
        a = act.split("_")[0]
        g = linear(x, p["w_gate"], act=a)
        u = linear(x, p["w_up"])
        return linear(g * u, p["w_down"])
    h = linear(x, p["w_up"], act=act)
    return linear(h, p["w_down"])


# ----------------------------------------------------------- embeddings
def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device=None) -> torch.Tensor:
    return _normal(gen, (vocab, d), 0.02, dtype, device)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(x: torch.Tensor, table_or_w: torch.Tensor, tied: bool) -> torch.Tensor:
    # a plain large matrix product outside any kernel: left to torch
    if tied:
        return torch.einsum("...d,vd->...v", x, table_or_w)
    return torch.einsum("...d,dv->...v", x, table_or_w)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, real_vocab: int) -> torch.Tensor:
    """Mean token cross-entropy; logits over the padded vocab are masked."""
    lf = logits.float()
    pad = lf.shape[-1] - real_vocab
    if pad > 0:
        lf = torch.cat([lf[..., :real_vocab],
                        torch.full((*lf.shape[:-1], pad), -1e30, dtype=torch.float32,
                                   device=lf.device)], dim=-1)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


# ----------------------------------------------------- causal conv (ssm)
def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B, S, C); w: (W, C).  Returns (y, new
    state (B, W-1, C))."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i: i + x.shape[1], :] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):, :] if W > 1 else state
    return y, new_state
