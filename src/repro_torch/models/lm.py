"""Decoder-only LM covering the dense, moe and vlm families: parameters,
the layer stack, the loss, prefill and decode.

Per-layer parameters are stacked along a leading layer axis, as in the
JAX package's ``params["blocks"]``; the stack is a Python loop over the
layers (the JAX package scans them), each layer's parameters a view, so
the gradient of a layer reaches the stacked tensor.  Under ``remat`` (the
train step) each layer runs under ``torch.utils.checkpoint``, as the
reference wraps its scan body in ``jax.checkpoint``."""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict

import torch
import torch.utils.checkpoint

from ..nn.attention import attention, attn_init, init_kv_cache
from ..nn.core import (Params, apply_norm, embed_init, embed_lookup, mlp_apply, mlp_init,
                       norm_init, param_dtype, softmax_xent, unembed)
from ..nn.moe import moe_apply, moe_init
from ..parallel.constrain import constrain

__all__ = ["init_params", "block_init", "block_apply", "layer", "stacked", "rematted",
           "loss_fn", "init_cache", "prefill", "decode_step", "_logits", "embed_lookup",
           "unembed"]


def block_init(gen: torch.Generator, cfg, dtype, device=None) -> Params:
    p = {
        "ln1": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "attn": attn_init(gen, cfg, dtype, device),
        "ln2": norm_init(cfg.d_model, cfg.norm, dtype, device),
    }
    if cfg.moe:
        p["moe"] = moe_init(gen, cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype, device)
    return p


def _stack_into(dst, src, i: int):
    if isinstance(src, dict):
        for k in src:
            _stack_into(dst[k], src[k], i)
    else:
        dst[i].copy_(src)


def stacked(draw, n: int) -> Params:
    """``n`` draws of a parameter dict (``draw()``), stacked along a new
    leading axis: the first allocates the stacked tensors, each later one
    is drawn and copied into its slice, so peak memory stays one draw
    above the stack."""
    first = draw()

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
        out[0].copy_(t)
        return out

    out = alloc(first)
    for i in range(1, n):
        _stack_into(out, draw(), i)
    return out


def init_params(cfg, gen: torch.Generator, device="cuda") -> Params:
    """Random parameters from ``gen`` (drawn on the generator's device),
    stored on ``device`` in ``cfg.dtype``; a MoE router stays float32.
    Layers are drawn one at a time into the stacked tensors (``stacked``).
    The draws follow the JAX package's order of keys: embed, blocks,
    unembed, then the VLM's ``patch_proj``."""
    dtype = param_dtype(cfg)
    embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device)
    blocks = stacked(lambda: block_init(gen, cfg, dtype, device), cfg.n_layers)
    p = {"embed": embed, "blocks": blocks,
         "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(gen, cfg.d_model, cfg.padded_vocab, dtype, device)
    if cfg.frontend == "patches":
        # stub frontend: a learned projection applied to precomputed patch
        # embeddings, as in the JAX package
        p["patch_proj"] = embed_init(gen, cfg.d_model, cfg.d_model, dtype, device)
    return p


def layer(blocks: Params, *i: int) -> Params:
    """Layer ``i``'s parameters (or cache) out of the stacked tensors
    (views); ``layer(t, g, j)`` indexes two stacked axes."""
    if isinstance(blocks, dict):
        return {k: layer(v, *i) for k, v in blocks.items()}
    return blocks[i]


def rematted(fn: Callable, remat: bool) -> Callable:
    """``fn`` itself, or under ``remat`` ``fn`` run through
    ``torch.utils.checkpoint`` (its activations dropped after the forward
    pass and recomputed in the backward): the twin of ``jax.checkpoint``."""
    if not remat:
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn, use_reentrant=False)


def _logits(p: Params, cfg, x: torch.Tensor, dist=None) -> torch.Tensor:
    """Logits over the (padded) vocabulary; in a rank of the sharded step,
    over the rank's block of it."""
    x = apply_norm(p["final_norm"], x, cfg.norm)
    w = p["embed"] if cfg.tie_embeddings else p["unembed"]
    if dist is not None:
        x = dist.enter(x)
    return unembed(x, w, cfg.tie_embeddings)


def block_apply(p: Params, x: torch.Tensor, cfg, cache=None, dist=None):
    """One layer.  ``dist`` is a rank of the sharded step
    (``parallel/sharded.py``), None on one device: the attention and the
    MLP then run on the rank's shards of their weights, between the
    step's collectives."""
    xn = apply_norm(p["ln1"], x, cfg.norm)
    if dist is None:
        h, new_cache = attention(p["attn"], xn, cfg, causal=True, cache=cache)
    else:
        h, new_cache = dist.attention(p["attn"], xn, cfg, cache)
    x = x + h
    xn = apply_norm(p["ln2"], x, cfg.norm)
    if cfg.moe:
        h2, aux = moe_apply(p["moe"], xn, cfg, dist=dist)
    else:
        h2 = (mlp_apply(p["mlp"], xn, cfg.act) if dist is None
              else dist.region(mlp_apply, p["mlp"], xn, cfg.act))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h2, new_cache, aux


def _global(dist, x: torch.Tensor):
    """The global shape of the layer stack's activations (the rank's
    batch block, the whole batch's size), None on one device."""
    return None if dist is None else dist.stream_shape(x)


def _stack(p: Params, x: torch.Tensor, cfg, caches=None, remat: bool = False, dist=None):
    """Every layer in turn.  ``caches`` holds the stacked per-layer KV
    caches (``init_cache``): each layer writes its keys and values into
    its slice of the stacked buffers in place (donated, see
    ``attention``), and those buffers come back with the new positions.
    The activations' sharding is pinned here (``constrain``: the identity
    on one device, a check in a rank of the sharded step), as the JAX
    package pins it.  ``remat`` recomputes each layer in the backward pass."""
    auxs = []
    new = []
    block = rematted(block_apply, remat)
    for i in range(cfg.n_layers):
        # one constrain site a path, as the JAX package's two scan bodies
        # (with and without caches) have
        if caches is not None:
            x = constrain(x, ("pod", "data"), None, None, shape=_global(dist, x))
            cache_i = {k: v[i] for k, v in caches.items()}
        else:
            x = constrain(x, ("pod", "data"), None, None, shape=_global(dist, x))
            cache_i = None
        x, new_cache, aux = block(layer(p["blocks"], i), x, cfg, cache_i, dist)
        auxs.append(aux)
        new.append(new_cache)
    aux = torch.stack(auxs).sum()
    if caches is None:
        return x, None, aux
    return x, dict(caches, pos=torch.stack([c["pos"] for c in new])), aux


def _embed(p: Params, tokens: torch.Tensor, dist) -> torch.Tensor:
    return embed_lookup(p["embed"], tokens) if dist is None else dist.embed(p["embed"], tokens)


def _embed_inputs(p: Params, cfg, batch: Dict[str, torch.Tensor], dist=None) -> torch.Tensor:
    x = _embed(p, batch["tokens"], dist)
    if cfg.frontend == "patches" and "patches" in batch:
        pe = torch.einsum("bpd,de->bpe", batch["patches"].to(x.dtype), p["patch_proj"])
        if dist is not None:
            pe = dist.columns(pe, cfg.d_model)  # the rank's d_model columns, gathered
        x = torch.cat([pe, x], dim=1)
    # keep the activations batch-sharded through the stack
    return constrain(x, ("pod", "data"), None, None, shape=_global(dist, x))


def loss_fn(p: Params, cfg, batch: Dict[str, torch.Tensor], remat: bool = True, dist=None):
    x = _embed_inputs(p, cfg, batch, dist)
    x, _, aux = _stack(p, x, cfg, None, remat=remat, dist=dist)
    if cfg.frontend == "patches" and "patches" in batch:
        x = x[:, batch["patches"].shape[1]:]  # loss on text positions only
    logits = _logits(p, cfg, x, dist)
    xent = softmax_xent if dist is None else dist.xent
    loss = xent(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux": aux}


def init_cache(cfg, batch: int, max_len: int, dtype, device="cuda") -> Any:
    one = init_kv_cache(cfg, batch, max_len, dtype, device)
    return {k: v.expand((cfg.n_layers, *v.shape)).clone() for k, v in one.items()}


def prefill(p: Params, cfg, batch: Dict[str, torch.Tensor], cache, dist=None):
    x = _embed_inputs(p, cfg, batch, dist)
    x, new_caches, _ = _stack(p, x, cfg, cache, dist=dist)
    logits = _logits(p, cfg, x[:, -1:], dist)
    return logits, new_caches


def decode_step(p: Params, cfg, cache, tokens: torch.Tensor, dist=None):
    """tokens: (B, 1)."""
    x = _embed(p, tokens, dist)
    x, new_caches, _ = _stack(p, x, cfg, cache, dist=dist)
    return _logits(p, cfg, x, dist), new_caches
