"""GQA attention with RoPE variants, qk-norm, a KV cache and
cross-attention: parameter init, the causal mask, the reference attention
``mha`` (float32 scores) and the ``attention`` layer (self-attention, or
cross-attention to an encoder's ``memory``)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .core import Params, apply_rope, dense_init, linear, rms_head_norm

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg, dtype, device=None, cross: bool = False) -> Params:
    """q, k, v, o (and qk-norm scales).  ``cross`` is unused, as in the
    JAX package: a cross-attention layer has the same parameters."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, d, h * hd, dtype, device),
        "wk": dense_init(gen, d, kv * hd, dtype, device),
        "wv": dense_init(gen, d, kv * hd, dtype, device),
        "wo": dense_init(gen, h * hd, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,S,H,hd), k: (B,T,KV,hd) -> (B,H,S,T) without materializing the
    repeated KV heads (grouped einsum)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    out = torch.einsum("bskgd,btkd->bkgst", qg, k)
    return out.reshape(b, h, s, k.shape[1])


def _gqa_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B,H,S,T), v: (B,T,KV,hd) -> (B,S,H,hd)."""
    b, h, s, t = p.shape
    kvh = v.shape[2]
    pg = p.reshape(b, kvh, h // kvh, s, t)
    out = torch.einsum("bkgst,btkd->bskgd", pg, v)
    return out.reshape(b, s, h, out.shape[-1])


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor], sm_scale: float) -> torch.Tensor:
    """Reference attention.  q: (B,S,H,hd); k/v: (B,T,KV,hd); mask
    broadcastable to (B,1,S,T) (True = attend)."""
    scores = _gqa_scores(q.float(), k.float()) * sm_scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=scores.device))
    p = torch.softmax(scores, dim=-1)
    out = _gqa_values(p, v.float())
    return out.to(q.dtype)


def softmax_scale(cfg) -> float:
    """The configured scale of the scores (``attention_multiplier``), or
    1 / sqrt(head dim)."""
    return cfg.attention_multiplier or 1.0 / float(cfg.hd) ** 0.5


def causal_mask(s: int, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))[None, None]


def attention(p: Params, x: torch.Tensor, cfg, *,
              positions: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              causal: bool = True,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              memory: Optional[torch.Tensor] = None,
              impl: str = "xla") -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self- or cross-attention.

    * training/prefill: ``cache=None`` (or fresh) — full sequence.
    * decode: ``cache`` holds (k, v, pos); x is (B, 1, D).
    * cross-attention: ``memory`` (B, T, D) is the encoder output; k and v
      come from it, with no RoPE and no cache, and ``mask`` goes to
      ``mha`` as given.

    ``cache["pos"]`` is a 0-d int32 tensor (the current length): the new
    keys and values are written into the cache's own ``k`` and ``v``
    buffers at rows ``pos .. pos + s`` with ``index_copy_``, whose indices
    stay on the device, so no layer waits for the host.  Those buffers are
    donated (the JAX package's functional update, without its copy of the
    whole cache): the returned cache holds them, written, and a new
    ``pos``; the cache passed in is not to be used again.  ``impl`` is
    unused, as in the JAX package: flash attention is not on the model
    path.
    """
    b, s, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sm_scale = softmax_scale(cfg)

    q = _split_heads(linear(x, p["wq"]), h)
    kv_src = memory if memory is not None else x
    k = _split_heads(linear(kv_src, p["wk"]), kvh)
    v = _split_heads(linear(kv_src, p["wv"]), kvh)

    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])

    if memory is not None:
        out = mha(q, k, v, mask, sm_scale)
        return linear(out.reshape(b, s, h * hd), p["wo"]), None

    steps = torch.arange(s, dtype=torch.int32, device=x.device)
    if positions is None:
        if cache is not None and "pos" in cache:
            positions = cache["pos"] + steps[None]
        else:
            positions = steps[None]
    q = apply_rope(q, positions, cfg.rope, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope, cfg.rope_theta)

    if cache is not None:
        pos = cache["pos"]  # 0-d int32: current length
        rows = (pos + steps).long()
        ck = cache["k"].index_copy_(1, rows, k.to(cache["k"].dtype))
        cv = cache["v"].index_copy_(1, rows, v.to(cache["v"].dtype))
        t = ck.shape[1]
        kpos = torch.arange(t, dtype=torch.int32, device=x.device)
        valid = kpos[None, None, None, :] < (pos + s)
        if causal and s > 1:
            qpos = pos + steps
            valid = valid & (kpos[None, None, None, :] <= qpos[None, None, :, None])
        out = mha(q, ck, cv, valid, sm_scale)
        new_cache = {"k": ck, "v": cv, "pos": pos + s}
        return linear(out.reshape(b, s, h * hd), p["wo"]), new_cache

    m = mask
    if causal and m is None:
        m = causal_mask(s, x.device)
    out = mha(q, k, v, m, sm_scale)
    return linear(out.reshape(b, s, h * hd), p["wo"]), None


def init_kv_cache(cfg, batch: int, max_len: int, dtype, device="cuda") -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros((batch, max_len, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
