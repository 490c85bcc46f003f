"""xLSTM LM, the twin of the JAX package's ``models/xlstm_model.py``:
mixed mLSTM / sLSTM residual blocks, unrolled (12 layers), parameters
``layer_{i}`` and a tied unembedding.  The cache is a list of per-layer
state dicts, donated: each block writes its new state into the buffers
it came in (``nn/xlstm.py``).  ``dist`` is a rank of the sharded step
(``parallel/sharded.py``), None on one device: each block's core is then a
tensor-parallel region (``nn/xlstm.py``), and the lookup, the tied
logits and the loss are vocabulary-parallel."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..nn.core import (Params, apply_norm, embed_init, norm_init, param_dtype, softmax_xent,
                       unembed)
from ..nn.xlstm import (mlstm_block_apply, mlstm_block_init, mlstm_init_state,
                        slstm_block_apply, slstm_block_init, slstm_init_state)
from . import lm
from .lm import rematted


def _kinds(cfg) -> List[str]:
    return ["slstm" if i in cfg.xlstm.slstm_at else "mlstm" for i in range(cfg.n_layers)]


def init_params(cfg, gen: torch.Generator, device="cuda") -> Params:
    dtype = param_dtype(cfg)
    p: Params = {}
    for i, kind in enumerate(_kinds(cfg)):
        init = mlstm_block_init if kind == "mlstm" else slstm_block_init
        p[f"layer_{i}"] = {"ln": norm_init(cfg.d_model, cfg.norm, dtype, device),
                           "core": init(gen, cfg, dtype, device)}
    p["embed"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device)
    p["final_norm"] = norm_init(cfg.d_model, cfg.norm, dtype, device)
    return p


def _forward(p: Params, cfg, x: torch.Tensor, states: Optional[List] = None,
             remat: bool = False, dist=None):
    """Every block in turn.  ``remat`` recomputes each block's core (not
    its norm) in the backward pass, as the reference's ``jax.checkpoint``
    around it."""
    for i, kind in enumerate(_kinds(cfg)):
        lp = p[f"layer_{i}"]
        st = states[i] if states is not None else None
        xin = apply_norm(lp["ln"], x, cfg.norm)
        fn = rematted(mlstm_block_apply if kind == "mlstm" else slstm_block_apply, remat)
        out, _ = fn(lp["core"], xin, cfg, state=st, dist=dist)
        x = x + out
    return x, states


def _logits(p: Params, cfg, x: torch.Tensor, dist=None) -> torch.Tensor:
    x = apply_norm(p["final_norm"], x, cfg.norm)
    if dist is not None:
        x = dist.enter(x)
    return unembed(x, p["embed"], True)


def loss_fn(p: Params, cfg, batch: Dict[str, torch.Tensor], remat: bool = True, dist=None):
    x = lm._embed(p, batch["tokens"], dist)
    x, _ = _forward(p, cfg, x, None, remat=remat, dist=dist)
    logits = _logits(p, cfg, x, dist)
    xent = softmax_xent if dist is None else dist.xent
    loss = xent(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab)
    return loss, {"loss": loss}


def init_cache(cfg, batch: int, max_len: int, dtype, device="cuda") -> Any:
    return [mlstm_init_state(cfg, batch, dtype, device) if kind == "mlstm"
            else slstm_init_state(cfg, batch, device) for kind in _kinds(cfg)]


def prefill(p: Params, cfg, batch: Dict[str, torch.Tensor], cache, dist=None):
    x = lm._embed(p, batch["tokens"], dist)
    x, new_states = _forward(p, cfg, x, cache, dist=dist)
    return _logits(p, cfg, x[:, -1:], dist), new_states


def decode_step(p: Params, cfg, cache, tokens: torch.Tensor, dist=None):
    x = lm._embed(p, tokens, dist)
    x, new_states = _forward(p, cfg, x, cache, dist=dist)
    return _logits(p, cfg, x, dist), new_states
