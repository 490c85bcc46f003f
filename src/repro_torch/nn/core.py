"""Core NN building blocks: plain functions on tensors, parameters in
dicts, initialization from an explicit ``torch.Generator``.

Only what serving needs is ported: embeddings, norms, RoPE, qk-norm, the
activation table and the parameter initializers."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def param_dtype(cfg) -> torch.dtype:
    from ..core.lower_torch import torch_dtype
    return torch_dtype(cfg.dtype)


def _normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """N(0, scale^2) samples drawn on the generator's device, then moved."""
    out = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (out * scale).to(device=device, dtype=dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device=None,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / float(d_in) ** 0.5
    return _normal(gen, (d_in, d_out), scale, dtype, device)


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
