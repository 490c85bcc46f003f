"""Encoder-decoder (the seamless-m4t backbone), the twin of the JAX
package's ``models/encdec.py``: an encoder over stub frame embeddings
(``frame_proj``, then non-causal self-attention layers) and a decoder over
text with self-attention, cross-attention to the encoder's ``memory`` and
an MLP.  Both stacks are stacked along a leading layer axis and run as
Python loops (the reference scans them).

The cache is ``{"kv": (n_layers, ...), "memory": None}``; ``prefill``
fills ``memory``.  The decoder's KV caches are donated (written in place,
``nn/attention.py``).  Cross-attention recomputes k and v of ``memory`` at
every call, as the reference does.

``dist`` is a rank of the sharded step (``parallel/sharded.py``), None on
one device: ``frame_proj``'s output, split over ``d_model``, is then
gathered before it joins the stream; every attention (the encoder's
non-causal one, the decoder's causal one, and cross-attention, whose K
and V come from ``memory`` through the rank's ``wk`` / ``wv`` heads) and
every MLP is a tensor-parallel region on the rank's heads and columns;
the LayerNorms (with their biases) and ``relu2`` run local; the lookup,
the logits and the loss are vocabulary-parallel."""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..nn.attention import attention, attn_init, init_kv_cache
from ..nn.core import (Params, apply_norm, embed_init, mlp_apply, mlp_init, norm_init,
                       param_dtype, softmax_xent, unembed)
from . import lm
from .lm import layer, rematted, stacked


def _enc_block_init(gen, cfg, dtype, device):
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "attn": attn_init(gen, cfg, dtype, device),
        "ln2": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype, device),
    }


def _dec_block_init(gen, cfg, dtype, device):
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "self_attn": attn_init(gen, cfg, dtype, device),
        "ln_x": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "cross_attn": attn_init(gen, cfg, dtype, device, cross=True),
        "ln2": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype, device),
    }


def init_params(cfg, gen: torch.Generator, device="cuda") -> Params:
    """Random parameters from ``gen``, a layer at a time into the stacked
    tensors, in the reference's order of keys."""
    dtype = param_dtype(cfg)
    return {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device),
        "encoder": stacked(lambda: _enc_block_init(gen, cfg, dtype, device), cfg.n_enc_layers),
        "decoder": stacked(lambda: _dec_block_init(gen, cfg, dtype, device), cfg.n_layers),
        "unembed": embed_init(gen, cfg.d_model, cfg.padded_vocab, dtype, device),
        "frame_proj": embed_init(gen, cfg.d_model, cfg.d_model, dtype, device),
        "enc_norm": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, device),
    }


def _attend(p: Params, xn: torch.Tensor, cfg, dist, causal: bool, cache=None, memory=None):
    if dist is None:
        return attention(p, xn, cfg, causal=causal, cache=cache, memory=memory)
    return dist.attention(p, xn, cfg, cache, causal=causal, memory=memory)


def _mlp(p: Params, xn: torch.Tensor, cfg, dist) -> torch.Tensor:
    if dist is None:
        return mlp_apply(p, xn, cfg.act)
    return dist.region(mlp_apply, p, xn, cfg.act)


def _enc_block(pi: Params, x: torch.Tensor, cfg, dist=None) -> torch.Tensor:
    h, _ = _attend(pi["attn"], apply_norm(pi["ln1"], x, cfg.norm), cfg, dist, causal=False)
    x = x + h
    return x + _mlp(pi["mlp"], apply_norm(pi["ln2"], x, cfg.norm), cfg, dist)


def encode(p: Params, cfg, frames: torch.Tensor, remat: bool = False, dist=None) -> torch.Tensor:
    """The encoder; ``remat`` recomputes each layer in the backward pass."""
    x = torch.einsum("bsd,de->bse", frames.to(p["frame_proj"].dtype), p["frame_proj"])
    if dist is not None:
        x = dist.columns(x, cfg.d_model)  # the rank's d_model columns, gathered
    block = rematted(_enc_block, remat)
    for i in range(cfg.n_enc_layers):
        x = block(layer(p["encoder"], i), x, cfg, dist)
    return apply_norm(p["enc_norm"], x, cfg.norm)


def _dec_block(pi: Params, x: torch.Tensor, cfg, memory: torch.Tensor, cache, dist=None):
    h, new_cache = _attend(pi["self_attn"], apply_norm(pi["ln1"], x, cfg.norm), cfg, dist,
                           causal=True, cache=cache)
    x = x + h
    h, _ = _attend(pi["cross_attn"], apply_norm(pi["ln_x"], x, cfg.norm), cfg, dist,
                   causal=False, memory=memory)
    x = x + h
    x = x + _mlp(pi["mlp"], apply_norm(pi["ln2"], x, cfg.norm), cfg, dist)
    return x, new_cache


def decode_stack(p: Params, cfg, x: torch.Tensor, memory: torch.Tensor, caches=None,
                 remat: bool = False, dist=None):
    """Every decoder layer in turn; each writes its slice of the stacked
    KV caches in place and its new ``pos``.  ``remat`` recomputes each
    layer in the backward pass."""
    block = rematted(_dec_block, remat)
    for i in range(cfg.n_layers):
        cache_i = None if caches is None else layer(caches, i)
        x, new_cache = block(layer(p["decoder"], i), x, cfg, memory, cache_i, dist)
        if caches is not None:
            caches["pos"][i].copy_(new_cache["pos"])
    return x, caches


def _logits(p: Params, cfg, x: torch.Tensor, dist=None) -> torch.Tensor:
    x = apply_norm(p["final_norm"], x, cfg.norm)
    if dist is not None:
        x = dist.enter(x)
    return unembed(x, p["unembed"], False)


def loss_fn(p: Params, cfg, batch: Dict[str, torch.Tensor], remat: bool = True, dist=None):
    memory = encode(p, cfg, batch["frames"], remat=remat, dist=dist)
    x = lm._embed(p, batch["tokens"], dist)
    x, _ = decode_stack(p, cfg, x, memory, None, remat=remat, dist=dist)
    logits = _logits(p, cfg, x, dist)
    xent = softmax_xent if dist is None else dist.xent
    loss = xent(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab)
    return loss, {"loss": loss}


def init_cache(cfg, batch: int, max_len: int, dtype, device="cuda") -> Any:
    one = init_kv_cache(cfg, batch, max_len, dtype, device)
    return {"kv": {k: v.expand(cfg.n_layers, *v.shape).clone() for k, v in one.items()},
            "memory": None}


def prefill(p: Params, cfg, batch: Dict[str, torch.Tensor], cache, dist=None):
    """Runs the encoder on frames and prefills the decoder with tokens."""
    memory = encode(p, cfg, batch["frames"], dist=dist)
    x = lm._embed(p, batch["tokens"], dist)
    x, new_kv = decode_stack(p, cfg, x, memory, cache["kv"], dist=dist)
    return _logits(p, cfg, x[:, -1:], dist), {"kv": new_kv, "memory": memory}


def decode_step(p: Params, cfg, cache, tokens: torch.Tensor, dist=None):
    x = lm._embed(p, tokens, dist)
    x, new_kv = decode_stack(p, cfg, x, cache["memory"], cache["kv"], dist=dist)
    return _logits(p, cfg, x, dist), {"kv": new_kv, "memory": cache["memory"]}
