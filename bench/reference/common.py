"""Plain PyTorch pieces of the references: float32 throughout, with TF32
off for matrix products and cuDNN.  Nothing here imports the program.

``Products`` computes every product with a weight.  With ``fp8`` it is
the control: each operand rounded to float8 e4m3 first (activations
scaled per row, weights per output column, as fp8 inference does), the
product then taken in float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

E4M3_MAX = 448.0


def strict_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Products:
    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., k) @ w (k, n), in float32 (or through float8)."""
        x = x.float()
        w = w.float()
        if self.fp8:
            x = _fp8(x, -1)
            w = _fp8(w, 0)
        return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, mode: str, theta: float) -> torch.Tensor:
    """Rotary embedding on x (B, T, H, hd) at ``positions`` (T,): the
    rotated dims (all, or the first half for ``half``) taken as two halves
    that rotate together, pair i with pair i + rot/2."""
    if mode == "none":
        return x
    hd = x.shape[-1]
    rot = hd if mode == "full" else hd // 2
    inv = theta ** (-torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot)
    ang = positions.float()[:, None] * inv[None, :]          # (T, rot/2)
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    a, b, rest = x[..., : rot // 2], x[..., rot // 2: rot], x[..., rot:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin, rest], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rows: int = 256) -> torch.Tensor:
    """Softmax attention of q (B, T, H, hd) over k, v (B, T, KV, hd), each
    query attending the keys at or before it; queries in blocks of
    ``rows`` so the scores fit.  Returns (B, T, H * hd)."""
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    kk = k.permute(0, 2, 3, 1)                                  # (B, KV, hd, T)
    vv = v.permute(0, 2, 1, 3)                                  # (B, KV, T, hd)
    out = torch.empty((b, t, h, hd), dtype=torch.float32, device=q.device)
    keys = torch.arange(t, device=q.device)
    for s0 in range(0, t, rows):
        s1 = min(t, s0 + rows)
        qq = q[:, s0:s1].reshape(b, s1 - s0, kvh, g, hd).permute(0, 2, 3, 1, 4)
        scores = torch.matmul(qq, kk[:, :, None]) / math.sqrt(hd)   # (B, KV, G, S, T)
        allowed = keys[None, :] <= torch.arange(s0, s1, device=q.device)[:, None]
        scores = scores.masked_fill(~allowed, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        o = torch.matmul(p, vv[:, :, None])                       # (B, KV, G, S, hd)
        out[:, s0:s1] = o.permute(0, 3, 1, 2, 4).reshape(b, s1 - s0, h, hd)
    return out.reshape(b, t, h * hd)


def attention_block(x: torch.Tensor, p, cfg, positions: torch.Tensor, mm: Products,
                    head_dim: int) -> torch.Tensor:
    """One layer's self-attention on the normed input x (B, T, d)."""
    b, t, _ = x.shape
    h, kvh = cfg["n_heads"], cfg["n_kv_heads"]
    q = mm(x, p["wq"]).view(b, t, h, head_dim)
    k = mm(x, p["wk"]).view(b, t, kvh, head_dim)
    v = mm(x, p["wv"]).view(b, t, kvh, head_dim)
    if cfg.get("qk_norm"):
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = rope(q, positions, cfg["rope"], float(cfg["rope_theta"]))
    k = rope(k, positions, cfg["rope"], float(cfg["rope_theta"]))
    return mm(causal_attention(q, k, v), p["wo"])


def glu(x: torch.Tensor, w_gate, w_up, w_down, mm: Products) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def layer_of(blocks, i: int):
    if isinstance(blocks, dict):
        return {k: layer_of(v, i) for k, v in blocks.items()}
    return blocks[i]


def lm_head(w, cfg, x: torch.Tensor, mm: Products) -> torch.Tensor:
    """Logits over the real vocabulary for the final hidden rows x (N, d)."""
    xn = rmsnorm(x, w["final_norm"]["scale"])
    table = w["unembed"] if "unembed" in w else w["embed"].t()
    return mm(xn, table)[:, : cfg["vocab"]]


def positions_of(t: int, device: Optional[torch.device]) -> torch.Tensor:
    return torch.arange(t, device=device)
