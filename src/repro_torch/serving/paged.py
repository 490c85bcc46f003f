"""Block-paged KV cache with static shapes, plus the paged decode/prefill
steps for dense-attention LMs.

Layout: the physical KV store is ``(n_layers, n_pages, page_size, kv_heads,
head_dim)``.  A slot's logical KV window is ``pages_per_slot =
ceil(max_len / page_size)`` pages, mapped through a ``page_table`` row of
physical page ids; the logical window length ``T = pages_per_slot *
page_size`` is what attention sees, with positions ``>= pos`` masked.
Every shape is static — slots grow and shrink purely by rewriting the
(tiny, host-side) page table and per-slot ``pos``.

Physical pages ``[0, pool_pages)`` form the shared allocation pool;
pages ``[pool_pages, pool_pages + slots)`` are per-slot *garbage pages*:
an idle slot's page-table row points at its own garbage page, so the
always-full-batch decode step's KV writes from dead slots land in
disjoint junk rows (never a scatter collision with a live slot, which
keeps runs deterministic) and are never read.

Because masked score entries are exact zeros after softmax (the
``NEG_INF`` shift underflows ``exp`` to 0.0), recycled pages need no
zeroing: stale values contribute exactly nothing.

The steps run eagerly: the layer loop is a Python loop over the stacked
per-layer parameters, and the KV writes update the page store **in
place** (``index_copy_`` into each layer's flat row view) instead of
returning a new store.  A step that fails midway may therefore have
written the rows at the live slots' current positions; those rows are
masked until the position is reached and are rewritten by the step that
reaches it, so a retried step (or a re-prefilled request) reads nothing
stale.

The dense blocks inside these steps route through the Stripe-compiled
programs of :mod:`repro_torch.serving.stripe_decode` when ``progs`` is
given, or through equivalent plain torch ops when it is None (A/B path).
Both compute in float32, matching the reference attention path's upcast.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.lower_torch import torch_dtype
from ..models import lm
from ..nn.attention import NEG_INF, causal_mask, mha
from ..nn.core import apply_norm, apply_rope, embed_lookup, rms_head_norm
from ..reliability import faults
from .stripe_decode import DecodePrograms, run_attn_out, run_mlp, run_qkv


# --------------------------------------------------------------- page pool
class PagePool:
    """Host-side allocator over the shared physical page pool.

    Allocation and release are O(pages) list ops on python ints — the
    device never sees the free list, only the rewritten page tables.
    LIFO reuse keeps the hot pages hot and is deterministic.
    """

    def __init__(self, pool_pages: int, slots: int):
        self.pool_pages = int(pool_pages)
        self.slots = int(slots)
        self._free: List[int] = list(range(self.pool_pages))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def total_pages(self) -> int:
        """Physical pages including the per-slot garbage pages."""
        return self.pool_pages + self.slots

    def garbage_page(self, slot: int) -> int:
        return self.pool_pages + slot

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> Optional[List[int]]:
        if faults.fires("paged.alloc", n=n, free=len(self._free)):
            # injected transient allocation failure: report exhaustion;
            # the engine defers the admission instead of crashing
            return None
        if len(self._free) < n:
            return None
        got = self._free[-n:]
        del self._free[-n:]
        return got

    def release(self, pages: List[int]) -> None:
        for p in pages:
            if not (0 <= p < self.pool_pages):
                raise ValueError(f"released page {p} outside the pool")
        self._free.extend(pages)


def pages_needed(plen: int, new_tokens: int, page_size: int) -> int:
    """Pages a request occupies over its whole lifetime: KV rows are
    written for positions ``[0, plen + new_tokens - 1)`` (the last
    emitted token is never written back)."""
    rows = plen + max(new_tokens, 1) - 1
    return -(-rows // page_size)


def init_pages(cfg, total_pages: int, page_size: int,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    dtype = torch_dtype(cfg.dtype)
    shape = (cfg.n_layers, total_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


# --------------------------------------------------------- torch fallback
def _proj(x2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bd,de->be", x2d.float(), w.float())


def _mlp_torch(x2d: torch.Tensor, resid2d: torch.Tensor, p, act: str) -> torch.Tensor:
    from ..nn.core import _ACT

    x2d = x2d.float()
    if act.endswith("_glu"):
        a = _ACT[act.split("_")[0]](_proj(x2d, p["w_gate"])) * _proj(x2d, p["w_up"])
    else:
        a = _ACT[act](_proj(x2d, p["w_up"]))
    return _proj(a, p["w_down"]) + resid2d.float()


def _qkv(progs, xn2d, ap):
    if progs is not None:
        return run_qkv(progs, xn2d, ap["wq"], ap["wk"], ap["wv"])
    return _proj(xn2d, ap["wq"]), _proj(xn2d, ap["wk"]), _proj(xn2d, ap["wv"])


def _attn_out(progs, a2, x2d, ap):
    if progs is not None:
        return run_attn_out(progs, a2, x2d, ap["wo"])
    return _proj(a2, ap["wo"]) + x2d.float()


def _mlp(progs, xn2d, x1, mp, act):
    if progs is not None:
        return run_mlp(progs, xn2d, x1, mp, act)
    return _mlp_torch(xn2d, x1, mp, act)


# ------------------------------------------------------------ decode step
def make_decode_step(cfg, progs: Optional[DecodePrograms], page_size: int):
    """Build the continuous decode step.

    Signature: ``fn(params, pages_k, pages_v, page_table, pos, tok) ->
    (next_tok, pages_k, pages_v)`` with ``page_table (S, PPS) int32``,
    ``pos (S,) int32`` (per-slot lengths), ``tok (S,) int32``, all on the
    engine's device; the page stores are updated in place and returned.
    """
    ps = int(page_size)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kv
    sm_scale = 1.0 / np.sqrt(hd)

    def step(params, pages_k, pages_v, page_table, pos, tok):
        s = page_table.shape[0]
        pps = page_table.shape[1]
        t_total = pps * ps
        n_phys = pages_k.shape[1]
        dev = page_table.device
        page_table = page_table.long()
        pos = pos.long()
        x = embed_lookup(params["embed"], tok[:, None])  # (S, 1, D)

        # flat-row addressing over (n_phys * ps) KV rows
        gather_rows = (page_table[:, :, None] * ps
                       + torch.arange(ps, device=dev)[None, None, :]).reshape(s, t_total)
        cur_page = torch.gather(page_table, 1, (pos // ps)[:, None])[:, 0]
        write_rows = cur_page * ps + pos % ps  # (S,) — disjoint by construction
        kpos = torch.arange(t_total, device=dev)
        valid = kpos[None, :] < (pos + 1)[:, None]  # (S, T)
        mask = valid[:, None, None, :]  # (S, 1|KV, 1|G, T)
        neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

        for li in range(cfg.n_layers):
            p_i = lm.layer(params["blocks"], li)
            ap = p_i["attn"]
            xn = apply_norm(p_i["ln1"], x, cfg.norm)
            q2, k2, v2 = _qkv(progs, xn[:, 0], ap)
            q = q2.reshape(s, 1, h, hd)
            k = k2.reshape(s, 1, kv, hd)
            v = v2.reshape(s, 1, kv, hd)
            if cfg.qk_norm:
                q = rms_head_norm(q, ap["q_norm"])
                k = rms_head_norm(k, ap["k_norm"])
            q = apply_rope(q, pos[:, None], cfg.rope, cfg.rope_theta)
            k = apply_rope(k, pos[:, None], cfg.rope, cfg.rope_theta)

            flat_k = pages_k[li].view(n_phys * ps, kv, hd)
            flat_v = pages_v[li].view(n_phys * ps, kv, hd)
            flat_k.index_copy_(0, write_rows, k[:, 0].to(flat_k.dtype))
            flat_v.index_copy_(0, write_rows, v[:, 0].to(flat_v.dtype))
            ck = flat_k[gather_rows].float()  # (S, T, KV, hd)
            cv = flat_v[gather_rows].float()

            qg = q[:, 0].reshape(s, kv, g, hd).float()
            if progs is not None and progs.scores is not None:
                scores = progs.scores({"Q": qg, "K": ck})["S"]
            else:
                scores = torch.einsum("bkgd,btkd->bkgt", qg, ck)
            scores = scores * sm_scale
            scores = torch.where(mask, scores, neg)
            probs = torch.softmax(scores, dim=-1)
            if progs is not None and progs.values is not None:
                o = progs.values({"P": probs, "V": cv})["O"]
            else:
                o = torch.einsum("bkgt,btkd->bkgd", probs, cv)
            a2 = o.reshape(s, h * hd)
            x1 = _attn_out(progs, a2, x[:, 0], ap).to(x.dtype)

            xn2 = apply_norm(p_i["ln2"], x1[:, None], cfg.norm)
            y = _mlp(progs, xn2[:, 0], x1, p_i["mlp"], cfg.act)
            x = y.to(x.dtype)[:, None]

        logits = lm._logits(params, cfg, x)  # (S, 1, V)
        nxt = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)
        return nxt, pages_k, pages_v

    return step


# ----------------------------------------------------------------- prefill
def make_prefill_step(cfg, progs: Optional[DecodePrograms], page_size: int,
                      bucket_len: int):
    """Build the batch-1 paged prefill for one compile bucket.

    Signature: ``fn(params, tokens (1, Lb), length (int), page_row (PPS,)
    int32, pages_k, pages_v) -> (first_tok scalar, pages_k, pages_v)``.
    Tokens are right-padded to the bucket; rows at positions ``>= length``
    scatter junk into the slot's own allocated / garbage pages, which
    attention masks, and which decode overwrites in place before each
    position ever becomes visible.
    """
    ps = int(page_size)
    lb = int(bucket_len)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sm_scale = 1.0 / np.sqrt(hd)

    def step(params, tokens, length, page_row, pages_k, pages_v):
        n_phys = pages_k.shape[1]
        dev = tokens.device
        page_row = page_row.long()
        x = embed_lookup(params["embed"], tokens)  # (1, Lb, D)
        t = torch.arange(lb, device=dev)
        write_rows = page_row[t // ps] * ps + t % ps  # (Lb,)
        positions = t[None]  # (1, Lb)
        cmask = causal_mask(lb, dev)

        for li in range(cfg.n_layers):
            p_i = lm.layer(params["blocks"], li)
            ap = p_i["attn"]
            xn = apply_norm(p_i["ln1"], x, cfg.norm)
            q2, k2, v2 = _qkv(progs, xn[0], ap)
            q = q2.reshape(1, lb, h, hd)
            k = k2.reshape(1, lb, kv, hd)
            v = v2.reshape(1, lb, kv, hd)
            if cfg.qk_norm:
                q = rms_head_norm(q, ap["q_norm"])
                k = rms_head_norm(k, ap["k_norm"])
            q = apply_rope(q, positions, cfg.rope, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope, cfg.rope_theta)

            pages_k[li].view(n_phys * ps, kv, hd).index_copy_(
                0, write_rows, k[0].to(pages_k.dtype))
            pages_v[li].view(n_phys * ps, kv, hd).index_copy_(
                0, write_rows, v[0].to(pages_v.dtype))

            out = mha(q, k, v, cmask, sm_scale)  # causal full-sequence
            x1 = _attn_out(progs, out.reshape(lb, h * hd), x[0], ap).to(x.dtype)
            xn2 = apply_norm(p_i["ln2"], x1[None], cfg.norm)
            y = _mlp(progs, xn2[0], x1, p_i["mlp"], cfg.act)
            x = y.to(x.dtype)[None]

        n = int(length)
        logits = lm._logits(params, cfg, x[:, n - 1:n])  # (1, 1, V)
        tok = torch.argmax(logits[0, 0, : cfg.vocab]).to(torch.int32)
        return tok, pages_k, pages_v

    return step
