"""Uniform model API: ``build_model(cfg)`` returns a ``Model`` with
init / loss / prefill / decode_step / init_cache, dispatching on family
as the JAX package does: dense, moe and vlm (``lm``), hybrid
(``hybrid``), ssm (``xlstm_model``) and audio (``encdec``); and layered
(``layered``), which the JAX package lacks.

Also provides ``input_specs(cfg, shape)`` (meta-device tensors standing in
for every model input of a cell) and ``make_batch`` (small real batches
for smoke tests, drawn as the JAX package draws them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..core.lower_torch import torch_dtype
from . import encdec, hybrid, layered, lm, xlstm_model


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]  # init(generator, device="cuda") -> params
    loss: Callable[..., Any]  # loss(params, batch, remat=True) -> (total, metrics)
    # prefill(params, batch, cache) -> (logits, cache); decode_step(params,
    # cache, tokens) -> (logits, cache).  Both donate the cache: its KV and
    # recurrent-state buffers are written in place and returned.
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]  # init_cache(batch, max_len, dtype=None, device="cuda")


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family in ("dense", "moe", "vlm"):
        mod = lm
    elif cfg.family == "hybrid":
        mod = hybrid
    elif cfg.family == "layered":
        mod = layered
    elif cfg.family == "ssm" and cfg.xlstm is not None:
        mod = xlstm_model
    elif cfg.family == "audio" and cfg.enc_dec:
        mod = encdec
    else:
        raise ValueError(f"no model for family {cfg.family}")

    def init(gen: torch.Generator, device="cuda"):
        """Random parameters from ``gen`` on ``device``: the card unless
        the caller passes ``"cpu"``; without a card that raises."""
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("init: device 'cuda' but torch.cuda.is_available() is "
                               "False; pass device='cpu' to draw the parameters onto the CPU")
        return mod.init_params(cfg, gen, device)

    return Model(
        cfg=cfg,
        init=init,
        loss=lambda p, batch, remat=True: mod.loss_fn(p, cfg, batch, remat=remat),
        prefill=lambda p, batch, cache: mod.prefill(p, cfg, batch, cache),
        decode_step=lambda p, cache, tok: mod.decode_step(p, cfg, cache, tok),
        init_cache=lambda batch, max_len, dtype=None, device="cuda": mod.init_cache(
            cfg, batch, max_len, torch_dtype(dtype or cfg.dtype), device),
    )


# --------------------------------------------------------------------------
# Input specs and synthetic batches (smoke)
# --------------------------------------------------------------------------
def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=torch_dtype(dtype), device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Meta-device tensors (shape and dtype, no storage) standing in for
    every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind not in ("train", "prefill"):
        # decode: one new token against a cache of seq_len
        return {"tokens": _spec((b, 1), "int32")}
    specs = {"tokens": _spec((b, s), "int32")}
    if shape.kind == "train":
        specs["labels"] = _spec((b, s), "int32")
    if cfg.frontend == "patches":
        specs["patches"] = _spec((b, cfg.frontend_len, cfg.d_model), cfg.dtype)
    if cfg.frontend == "frames":
        specs["frames"] = _spec((b, s, cfg.d_model), cfg.dtype)
    return specs


def make_batch(cfg: ArchConfig, shape_kind: str, batch: int, seq: int, seed: int = 0,
               device="cuda") -> Dict[str, torch.Tensor]:
    """The JAX package's draws (``np.random.RandomState(seed)``, in the
    same order) as tensors on ``device``."""
    rng = np.random.RandomState(seed)

    def tensor(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(device=device, dtype=torch_dtype(dtype))

    tokens = tensor(rng.randint(0, cfg.vocab, size=(batch, seq)), "int32")
    out = {"tokens": tokens}
    if shape_kind == "train":
        out["labels"] = tokens
    if cfg.frontend == "patches":
        out["patches"] = tensor(rng.randn(batch, cfg.frontend_len, cfg.d_model) * 0.1, cfg.dtype)
    if cfg.frontend == "frames":
        out["frames"] = tensor(rng.randn(batch, seq, cfg.d_model) * 0.1, cfg.dtype)
    return out
