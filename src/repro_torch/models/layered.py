"""A layered hybrid (granite-4.0-h's ``granitemoehybrid``): every layer
has a mixer of its own kind, a Mamba2 layer or GQA attention, as
``cfg.layer_types`` lists them, and every mixer is followed by the MoE
(with its shared expert, where the configuration gives one).  A layer:

    h = x + r * mixer(rmsnorm(x))
    y = h + r * moe(rmsnorm(h))

with ``r`` = ``residual_multiplier``; the embeddings are scaled by
``embedding_multiplier``, the logits divided by ``logits_scaling``, the
attention's scores scaled by ``attention_multiplier`` (``nn/attention.py``)
and the norms' eps is ``norm_eps``.  The JAX package has no such model.

The parameters are stacked by kind, so every leaf keeps a leading layer
axis: ``blocks["mamba"]`` holds the Mamba2 layers, ``blocks["attn"]`` the
attention layers (each in the order they come), ``blocks["moe"]``,
``blocks["ln1"]`` and ``blocks["ln2"]`` every layer's.  The cache holds KV
only for the attention layers and the Mamba2 state (conv window, SSD
state) only for the Mamba2 layers: ``{"attn": (n_attn, ...), "mamba":
(n_mamba, ...)}``.  It is donated: every buffer is written in place and
returned.  The MoE runs as ``lm.moe_apply``, so what wraps the LM
family's MoE layer wraps this one's too."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..nn.attention import attention, attn_init, init_kv_cache
from ..nn.core import (Params, apply_norm, embed_init, embed_lookup, norm_init, param_dtype,
                       softmax_xent, unembed)
from ..nn.moe import moe_init
from ..nn.ssm import mamba2_apply, mamba2_init, mamba2_init_state
from . import lm
from .lm import layer, rematted, stacked

KINDS = ("mamba", "attention")


def kinds(cfg) -> List[Tuple[str, int]]:
    """Each layer's mixer kind and its index among the layers of that kind."""
    if len(cfg.layer_types) != cfg.n_layers or set(cfg.layer_types) - set(KINDS):
        raise ValueError(f"{cfg.name}: layer_types must give one of {KINDS} for each of "
                         f"{cfg.n_layers} layers, not {cfg.layer_types}")
    seen = {k: 0 for k in KINDS}
    out = []
    for kind in cfg.layer_types:
        out.append((kind, seen[kind]))
        seen[kind] += 1
    return out


def _count(cfg, kind: str) -> int:
    return sum(1 for k, _ in kinds(cfg) if k == kind)


def init_params(cfg, gen: torch.Generator, device="cuda") -> Params:
    """Random parameters from ``gen``, a layer at a time into the stacked
    tensors: the embedding (tied to the LM head), the Mamba2 layers, the
    attention layers, the MoE layers, the norms."""
    dtype = param_dtype(cfg)
    d = cfg.d_model
    blocks = {}
    if _count(cfg, "mamba"):
        blocks["mamba"] = stacked(lambda: mamba2_init(gen, cfg, dtype, device),
                                  _count(cfg, "mamba"))
    if _count(cfg, "attention"):
        blocks["attn"] = stacked(lambda: attn_init(gen, cfg, dtype, device),
                                 _count(cfg, "attention"))
    blocks["moe"] = stacked(lambda: moe_init(gen, cfg, dtype, device), cfg.n_layers)
    for ln in ("ln1", "ln2"):
        blocks[ln] = stacked(lambda: norm_init(d, cfg.norm, dtype, device), cfg.n_layers)
    p = {"embed": embed_init(gen, cfg.padded_vocab, d, dtype, device), "blocks": blocks,
         "final_norm": norm_init(d, cfg.norm, dtype, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(gen, d, cfg.padded_vocab, dtype, device)
    return p


def block_apply(blocks: Params, x: torch.Tensor, cfg, i: int, kind: str, j: int, caches=None):
    """Layer ``i``, the ``j``-th of its ``kind``: the mixer and the MoE,
    each around a scaled residual.  Returns (x, aux)."""
    r = cfg.residual_multiplier
    xn = apply_norm(layer(blocks["ln1"], i), x, cfg.norm, cfg.norm_eps)
    if kind == "mamba":
        state = None if caches is None else layer(caches["mamba"], j)
        h, _ = mamba2_apply(layer(blocks["mamba"], j), xn, cfg, state=state)
    else:
        cache = None if caches is None else layer(caches["attn"], j)
        h, new = attention(layer(blocks["attn"], j), xn, cfg, causal=True, cache=cache)
        if caches is not None:
            caches["attn"]["pos"][j].copy_(new["pos"])
    x = x + r * h
    xn = apply_norm(layer(blocks["ln2"], i), x, cfg.norm, cfg.norm_eps)
    h2, aux = lm.moe_apply(layer(blocks["moe"], i), xn, cfg)
    return x + r * h2, aux


def _forward(p: Params, cfg, x: torch.Tensor, caches=None, remat: bool = False):
    block = rematted(block_apply, remat)
    auxs = []
    for i, (kind, j) in enumerate(kinds(cfg)):
        x, aux = block(p["blocks"], x, cfg, i, kind, j, caches)
        auxs.append(aux)
    return x, torch.stack(auxs).sum()


def _embed(p: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return embed_lookup(p["embed"], tokens) * cfg.embedding_multiplier


def _logits(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(p["final_norm"], x, cfg.norm, cfg.norm_eps)
    w = p["embed"] if cfg.tie_embeddings else p["unembed"]
    return unembed(x, w, cfg.tie_embeddings) / cfg.logits_scaling


def loss_fn(p: Params, cfg, batch: Dict[str, torch.Tensor], remat: bool = True):
    x, aux = _forward(p, cfg, _embed(p, cfg, batch["tokens"]), remat=remat)
    logits = _logits(p, cfg, x)
    loss = softmax_xent(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab)
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def init_cache(cfg, batch: int, max_len: int, dtype, device="cuda") -> Any:
    out = {}
    if _count(cfg, "attention"):
        kv = init_kv_cache(cfg, batch, max_len, dtype, device)
        out["attn"] = {k: v.expand(_count(cfg, "attention"), *v.shape).clone()
                       for k, v in kv.items()}
    if _count(cfg, "mamba"):
        st = mamba2_init_state(cfg, batch, dtype, device)
        out["mamba"] = {k: v.expand(_count(cfg, "mamba"), *v.shape).clone()
                        for k, v in st.items()}
    return out


def prefill(p: Params, cfg, batch: Dict[str, torch.Tensor], cache):
    x, _ = _forward(p, cfg, _embed(p, cfg, batch["tokens"]), cache)
    return _logits(p, cfg, x[:, -1:]), cache


def decode_step(p: Params, cfg, cache, tokens: torch.Tensor):
    """tokens: (B, 1)."""
    x, _ = _forward(p, cfg, _embed(p, cfg, tokens), cache)
    return _logits(p, cfg, x), cache
