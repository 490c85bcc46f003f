"""Decoder-only LM, dense family: parameters and the output head.

Per-layer parameters are stacked along a leading layer axis, as in the
JAX package's ``params["blocks"]``; the serving steps index one layer at a
time."""
from __future__ import annotations

import torch

from ..nn.attention import attn_init
from ..nn.core import (Params, apply_norm, embed_init, embed_lookup, mlp_init,
                       norm_init, param_dtype, unembed)

__all__ = ["init_params", "block_init", "layer", "_logits", "embed_lookup", "unembed"]


def block_init(gen: torch.Generator, cfg, dtype, device=None) -> Params:
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "attn": attn_init(gen, cfg, dtype, device),
        "ln2": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype, device),
    }


def _stack_into(dst, src, i: int):
    if isinstance(src, dict):
        for k in src:
            _stack_into(dst[k], src[k], i)
    else:
        dst[i].copy_(src)


def init_params(cfg, gen: torch.Generator, device=None) -> Params:
    """Random parameters from ``gen`` (drawn on the generator's device),
    stored on ``device`` in ``cfg.dtype``.  Layers are drawn one at a time
    into the stacked tensors, so peak memory stays one layer above the
    parameters."""
    if cfg.family != "dense" or cfg.moe:
        raise ValueError(f"no model for family {cfg.family} in this package yet")
    dtype = param_dtype(cfg)
    embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device)
    first = block_init(gen, cfg, dtype, device)

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        out = torch.empty((cfg.n_layers, *t.shape), dtype=t.dtype, device=t.device)
        out[0].copy_(t)
        return out

    blocks = alloc(first)
    for i in range(1, cfg.n_layers):
        _stack_into(blocks, block_init(gen, cfg, dtype, device), i)
    p = {"embed": embed, "blocks": blocks,
         "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(gen, cfg.d_model, cfg.padded_vocab, dtype, device)
    return p


def layer(blocks: Params, i: int) -> Params:
    """Layer ``i``'s parameters out of the stacked tensors (views)."""
    if isinstance(blocks, dict):
        return {k: layer(v, i) for k, v in blocks.items()}
    return blocks[i]


def _logits(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(p["final_norm"], x, cfg.norm)
    w = p["embed"] if cfg.tie_embeddings else p["unembed"]
    return unembed(x, w, cfg.tie_embeddings)
