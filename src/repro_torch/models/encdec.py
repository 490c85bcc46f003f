"""Encoder-decoder (the seamless-m4t backbone), the twin of the JAX
package's ``models/encdec.py``: an encoder over stub frame embeddings
(``frame_proj``, then non-causal self-attention layers) and a decoder over
text with self-attention, cross-attention to the encoder's ``memory`` and
an MLP.  Both stacks are stacked along a leading layer axis and run as
Python loops (the reference scans them).

The cache is ``{"kv": (n_layers, ...), "memory": None}``; ``prefill``
fills ``memory``.  The decoder's KV caches are donated (written in place,
``nn/attention.py``).  Cross-attention recomputes k and v of ``memory`` at
every call, as the reference does."""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..nn.attention import attention, attn_init, init_kv_cache
from ..nn.core import (Params, apply_norm, embed_init, embed_lookup, mlp_apply, mlp_init,
                       norm_init, param_dtype, softmax_xent, unembed)
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


def _enc_block(pi: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    h, _ = attention(pi["attn"], apply_norm(pi["ln1"], x, cfg.norm), cfg, causal=False)
    x = x + h
    return x + mlp_apply(pi["mlp"], apply_norm(pi["ln2"], x, cfg.norm), cfg.act)


def encode(p: Params, cfg, frames: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """The encoder; ``remat`` recomputes each layer in the backward pass."""
    x = torch.einsum("bsd,de->bse", frames.to(p["frame_proj"].dtype), p["frame_proj"])
    block = rematted(_enc_block, remat)
    for i in range(cfg.n_enc_layers):
        x = block(layer(p["encoder"], i), x, cfg)
    return apply_norm(p["enc_norm"], x, cfg.norm)


def _dec_block(pi: Params, x: torch.Tensor, cfg, memory: torch.Tensor, cache):
    h, new_cache = attention(pi["self_attn"], apply_norm(pi["ln1"], x, cfg.norm), cfg,
                             causal=True, cache=cache)
    x = x + h
    h, _ = attention(pi["cross_attn"], apply_norm(pi["ln_x"], x, cfg.norm), cfg,
                     memory=memory, causal=False)
    x = x + h
    x = x + mlp_apply(pi["mlp"], apply_norm(pi["ln2"], x, cfg.norm), cfg.act)
    return x, new_cache


def decode_stack(p: Params, cfg, x: torch.Tensor, memory: torch.Tensor, caches=None,
                 remat: bool = False):
    """Every decoder layer in turn; each writes its slice of the stacked
    KV caches in place and its new ``pos``.  ``remat`` recomputes each
    layer in the backward pass."""
    block = rematted(_dec_block, remat)
    for i in range(cfg.n_layers):
        cache_i = None if caches is None else layer(caches, i)
        x, new_cache = block(layer(p["decoder"], i), x, cfg, memory, cache_i)
        if caches is not None:
            caches["pos"][i].copy_(new_cache["pos"])
    return x, caches


def _logits(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(p["final_norm"], x, cfg.norm)
    return unembed(x, p["unembed"], False)


def loss_fn(p: Params, cfg, batch: Dict[str, torch.Tensor], remat: bool = True):
    memory = encode(p, cfg, batch["frames"], remat=remat)
    x = embed_lookup(p["embed"], batch["tokens"])
    x, _ = decode_stack(p, cfg, x, memory, None, remat=remat)
    logits = _logits(p, cfg, x)
    loss = softmax_xent(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab)
    return loss, {"loss": loss}


def init_cache(cfg, batch: int, max_len: int, dtype, device="cuda") -> Any:
    one = init_kv_cache(cfg, batch, max_len, dtype, device)
    return {"kv": {k: v.expand(cfg.n_layers, *v.shape).clone() for k, v in one.items()},
            "memory": None}


def prefill(p: Params, cfg, batch: Dict[str, torch.Tensor], cache):
    """Runs the encoder on frames and prefills the decoder with tokens."""
    memory = encode(p, cfg, batch["frames"])
    x = embed_lookup(p["embed"], batch["tokens"])
    x, new_kv = decode_stack(p, cfg, x, memory, cache["kv"])
    return _logits(p, cfg, x[:, -1:]), {"kv": new_kv, "memory": memory}


def decode_step(p: Params, cfg, cache, tokens: torch.Tensor):
    x = embed_lookup(p["embed"], tokens)
    x, new_kv = decode_stack(p, cfg, x, cache["memory"], cache["kv"])
    return _logits(p, cfg, x), {"kv": new_kv, "memory": cache["memory"]}
