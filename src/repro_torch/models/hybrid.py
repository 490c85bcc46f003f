"""Zamba2-style hybrid, the twin of the JAX package's ``models/hybrid.py``:
a Mamba2 backbone with one *shared* transformer block (attention + MLP,
weights shared) applied before every group of ``shared_attn_every`` Mamba2
layers, each application with its own KV cache (9 applications for 54
layers / 6).

The Mamba2 parameters are stacked ``(groups, per_group, ...)`` as the
reference's double ``vmap`` stacks them, and the cache is ``{"attn":
(groups, ...), "mamba": (groups, per_group, ...)}``.  Both loops are
Python loops (the reference scans them).  The cache is donated: every
group's KV cache, its ``pos`` and every Mamba2 state are written into the
buffers they came in, and those buffers are returned.

``dist`` is a rank of the sharded step (``parallel/sharded.py``), None on
one device: the shared block then runs as an LM layer does
(``lm.block_apply``), each Mamba2 layer as ``nn/ssm.py`` says, and the
logits and the loss are vocabulary-parallel."""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..nn.attention import attn_init, init_kv_cache
from ..nn.core import (Params, apply_norm, embed_init, mlp_init, norm_init, param_dtype,
                       softmax_xent, unembed)
from ..nn.ssm import mamba2_apply, mamba2_init, mamba2_init_state
from . import lm
from .lm import layer, rematted, stacked


def _n_groups(cfg) -> int:
    k = cfg.hybrid.shared_attn_every
    return (cfg.n_layers + k - 1) // k


def init_params(cfg, gen: torch.Generator, device="cuda") -> Params:
    """Random parameters from ``gen``, drawn a Mamba2 layer at a time into
    the stacked tensors, in the reference's order of keys: embed, the
    Mamba2 layers, the shared block, unembed."""
    dtype = param_dtype(cfg)
    groups, per_group = _n_groups(cfg), cfg.hybrid.shared_attn_every
    embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device)
    mamba = stacked(lambda: mamba2_init(gen, cfg, dtype, device), groups * per_group)
    mamba = {k: v.reshape(groups, per_group, *v.shape[1:]) for k, v in mamba.items()}
    shared = {
        "ln1": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "attn": attn_init(gen, cfg, dtype, device),
        "ln2": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype, device),
    }
    return {
        "embed": embed,
        "mamba": mamba,
        "shared": shared,
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "unembed": embed_init(gen, cfg.d_model, cfg.padded_vocab, dtype, device),
    }


def _shared_block(p: Params, x: torch.Tensor, cfg, cache, dist=None):
    """The shared transformer block: an LM layer (attention, then the
    MLP, each around a residual), its weights shared by every group."""
    x, new_cache, _ = lm.block_apply(p, x, cfg, cache, dist)
    return x, new_cache


def _group(shared: Params, mamba: Params, x: torch.Tensor, cfg, caches, g: int, dist=None):
    """Group ``g``: the shared block, then its Mamba2 layers."""
    attn_cache = None if caches is None else layer(caches["attn"], g)
    x, new_attn = _shared_block(shared, x, cfg, attn_cache, dist=dist)
    if caches is not None:
        caches["attn"]["pos"][g].copy_(new_attn["pos"])
    for j in range(cfg.hybrid.shared_attn_every):
        state = None if caches is None else layer(caches["mamba"], g, j)
        x, _ = mamba2_apply(layer(mamba, j), x, cfg, state=state, dist=dist)
    return x


def _forward(p: Params, cfg, x: torch.Tensor, caches=None, remat: bool = False, dist=None):
    """Every group in turn.  ``remat`` recomputes each group in the
    backward pass, as the reference's ``jax.checkpoint`` of its group
    body."""
    group = rematted(_group, remat)
    for g in range(_n_groups(cfg)):
        x = group(p["shared"], layer(p["mamba"], g), x, cfg, caches, g, dist)
    return x, caches


def _logits(p: Params, cfg, x: torch.Tensor, dist=None) -> torch.Tensor:
    x = apply_norm(p["final_norm"], x, cfg.norm)
    if dist is not None:
        x = dist.enter(x)
    return unembed(x, p["unembed"], False)


def loss_fn(p: Params, cfg, batch: Dict[str, torch.Tensor], remat: bool = True, dist=None):
    x = lm._embed(p, batch["tokens"], dist)
    x, _ = _forward(p, cfg, x, None, remat=remat, dist=dist)
    logits = _logits(p, cfg, x, dist)
    xent = softmax_xent if dist is None else dist.xent
    loss = xent(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab)
    return loss, {"loss": loss}


def init_cache(cfg, batch: int, max_len: int, dtype, device="cuda") -> Any:
    groups, per_group = _n_groups(cfg), cfg.hybrid.shared_attn_every
    attn = init_kv_cache(cfg, batch, max_len, dtype, device)
    mst = mamba2_init_state(cfg, batch, dtype, device)
    return {"attn": {k: v.expand(groups, *v.shape).clone() for k, v in attn.items()},
            "mamba": {k: v.expand(groups, per_group, *v.shape).clone() for k, v in mst.items()}}


def prefill(p: Params, cfg, batch: Dict[str, torch.Tensor], cache, dist=None):
    x = lm._embed(p, batch["tokens"], dist)
    x, new_caches = _forward(p, cfg, x, cache, dist=dist)
    return _logits(p, cfg, x[:, -1:], dist), new_caches


def decode_step(p: Params, cfg, cache, tokens: torch.Tensor, dist=None):
    x = lm._embed(p, tokens, dist)
    x, new_caches = _forward(p, cfg, x, cache, dist=dist)
    return _logits(p, cfg, x, dist), new_caches
