"""Decoder-only LM covering the dense, moe and vlm families: parameters,
the layer stack, the loss, prefill and decode.

Per-layer parameters are stacked along a leading layer axis, as in the
JAX package's ``params["blocks"]``; the stack is a Python loop over the
layers (the JAX package scans them), each layer's parameters a view.
Training (where ``remat`` matters) comes with ROADMAP A8c."""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..nn.attention import attention, attn_init, init_kv_cache
from ..nn.core import (Params, apply_norm, embed_init, embed_lookup, mlp_apply, mlp_init,
                       norm_init, param_dtype, softmax_xent, unembed)
from ..nn.moe import moe_apply, moe_init

__all__ = ["init_params", "block_init", "block_apply", "layer", "loss_fn", "init_cache",
           "prefill", "decode_step", "_logits", "embed_lookup", "unembed"]


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


def init_params(cfg, gen: torch.Generator, device="cuda") -> Params:
    """Random parameters from ``gen`` (drawn on the generator's device),
    stored on ``device`` (the card unless the caller passes ``"cpu"``) in
    ``cfg.dtype``; a MoE router stays float32.  Layers are drawn one at a
    time into the stacked tensors, so peak memory stays one layer above
    the parameters.  The draws follow the JAX package's order of keys:
    embed, blocks, unembed, then the VLM's ``patch_proj``."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_params: device 'cuda' but torch.cuda.is_available() is "
                           "False; pass device='cpu' to draw the parameters onto the CPU")
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
    if cfg.frontend == "patches":
        # stub frontend: a learned projection applied to precomputed patch
        # embeddings, as in the JAX package
        p["patch_proj"] = embed_init(gen, cfg.d_model, cfg.d_model, dtype, device)
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


def block_apply(p: Params, x: torch.Tensor, cfg, cache=None):
    h, new_cache = attention(p["attn"], apply_norm(p["ln1"], x, cfg.norm), cfg,
                             causal=True, cache=cache)
    x = x + h
    if cfg.moe:
        h2, aux = moe_apply(p["moe"], apply_norm(p["ln2"], x, cfg.norm), cfg)
    else:
        h2 = mlp_apply(p["mlp"], apply_norm(p["ln2"], x, cfg.norm), cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h2, new_cache, aux


def _stack(p: Params, x: torch.Tensor, cfg, caches=None, remat: bool = False):
    """Every layer in turn.  ``caches`` holds the stacked per-layer KV
    caches (``init_cache``): each layer writes its keys and values into
    its slice of the stacked buffers in place (donated, see
    ``attention``), and those buffers come back with the new positions.
    The JAX package pins the activations' sharding here (``constrain``),
    the identity on one device: the multi-device slice (ROADMAP A9) brings
    it.  ``remat`` only matters under autograd (training, A8c)."""
    auxs = []
    new = []
    for i in range(cfg.n_layers):
        cache_i = None if caches is None else {k: v[i] for k, v in caches.items()}
        x, new_cache, aux = block_apply(layer(p["blocks"], i), x, cfg, cache_i)
        auxs.append(aux)
        new.append(new_cache)
    aux = torch.stack(auxs).sum()
    if caches is None:
        return x, None, aux
    return x, dict(caches, pos=torch.stack([c["pos"] for c in new])), aux


def _embed_inputs(p: Params, cfg, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    x = embed_lookup(p["embed"], batch["tokens"])
    if cfg.frontend == "patches" and "patches" in batch:
        pe = torch.einsum("bpd,de->bpe", batch["patches"].to(x.dtype), p["patch_proj"])
        x = torch.cat([pe, x], dim=1)
    return x


def loss_fn(p: Params, cfg, batch: Dict[str, torch.Tensor], remat: bool = True):
    x = _embed_inputs(p, cfg, batch)
    x, _, aux = _stack(p, x, cfg, None, remat=remat)
    if cfg.frontend == "patches" and "patches" in batch:
        x = x[:, batch["patches"].shape[1]:]  # loss on text positions only
    logits = _logits(p, cfg, x)
    loss = softmax_xent(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux": aux}


def init_cache(cfg, batch: int, max_len: int, dtype, device="cuda") -> Any:
    one = init_kv_cache(cfg, batch, max_len, dtype, device)
    return {k: v.expand((cfg.n_layers, *v.shape)).clone() for k, v in one.items()}


def prefill(p: Params, cfg, batch: Dict[str, torch.Tensor], cache):
    x = _embed_inputs(p, cfg, batch)
    x, new_caches, _ = _stack(p, x, cfg, cache)
    logits = _logits(p, cfg, x[:, -1:])
    return logits, new_caches


def decode_step(p: Params, cfg, cache, tokens: torch.Tensor):
    """tokens: (B, 1)."""
    x = embed_lookup(p["embed"], tokens)
    x, new_caches, _ = _stack(p, x, cfg, cache)
    return _logits(p, cfg, x), new_caches
