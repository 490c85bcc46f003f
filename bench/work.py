"""The operations and bytes of the work, from a configuration's sizes.

These count the work a user asks for, not what implements it: a
projection reads each weight and activation once and writes each output
once in the configuration's type (the block programs' float32 weight
casts are time, not bytes of the work), and the model's FLOPs are those
of real tokens (no padding, no rows decoded past a request's end).
Copied and extended from ``chip_smoke.projection_bound`` /
``_model_ops``.
"""
from __future__ import annotations

from typing import Any, Dict

from bench import peaks

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def head_dim(cfg: Dict[str, Any]) -> int:
    return int(cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"])


def attn_params(cfg: Dict[str, Any]) -> int:
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    return d * h * hd + 2 * d * kv * hd + h * hd * d


def ffn_active_params(cfg: Dict[str, Any]) -> int:
    """The matrix parameters a token's FFN multiplies by: a dense GLU's
    three matrices, or the router and the top-k experts' three."""
    d = cfg["d_model"]
    moe = cfg.get("moe")
    if moe:
        return moe["top_k"] * 3 * d * moe["d_ff_expert"] + d * moe["n_experts"]
    mult = 3 if cfg["act"].endswith("_glu") else 2
    return mult * d * cfg["d_ff"]


def token_flops(cfg: Dict[str, Any], ctx: int) -> float:
    """One token through every layer, attending ``ctx`` keys (itself
    included): 2 x the active matrix parameters, plus q.k and p.v."""
    layers = cfg["n_layers"]
    per_layer = 2 * (attn_params(cfg) + ffn_active_params(cfg))
    attn = 4 * cfg["n_heads"] * head_dim(cfg) * ctx
    return float(layers * (per_layer + attn))


def head_flops(cfg: Dict[str, Any]) -> float:
    return 2.0 * cfg["d_model"] * cfg["vocab"]


def prefill_flops(cfg: Dict[str, Any], plen: int) -> float:
    """A prompt of ``plen`` tokens, causal, and the LM head at its last."""
    layers = cfg["n_layers"]
    per_layer = 2 * (attn_params(cfg) + ffn_active_params(cfg)) * plen
    attn = 4 * cfg["n_heads"] * head_dim(cfg) * plen * (plen + 1) // 2
    return float(layers * (per_layer + attn)) + head_flops(cfg)


def served_flops(cfg: Dict[str, Any], plen: int, first: int, last: int) -> float:
    """The model FLOPs behind output tokens ``first .. last - 1`` of a
    request with a ``plen``-token prompt: token 0 is the prefill's, token
    i >= 1 is a decode step that feeds position plen + i - 1."""
    total = 0.0
    for i in range(first, last):
        if i == 0:
            total += prefill_flops(cfg, plen)
        else:
            total += token_flops(cfg, plen + i) + head_flops(cfg)
    return total


def matmul_bound_s(m: int, k: int, n: int, dtype: str) -> float:
    """The least time of an (m, k) x (k, n) product in ``dtype`` on the
    card: its bytes over the memory rate or its operations over the peak
    for the type, whichever is larger."""
    size = BYTES[dtype]
    nbytes = size * (k * n + m * k + m * n)
    return max(nbytes / peaks.HBM_BYTES_PER_S, 2.0 * m * k * n / peaks.PEAK_FLOPS[dtype])
