"""The MoE dispatch's positions (``kernels/moe_dispatch.py``,
``csrc/moe_dispatch.cu``) and the gather that fills the experts' rows
from them (``nn/moe.py::moe_apply``).

* CPU: the plain version's ``pair_of_slot`` and drop count equal the
  definition written out pair by pair (a pair's position is the
  number of pairs of its expert before it in token-major order, counted
  in the global order where a rank holds blocks of it), over tokens that
  are not a multiple of the kernel's tile, a capacity of 4 with heavy
  drops, a capacity past every pair, 16 and 128 experts, skewed routing,
  and a sharded rank's two blocks with offsets and an expert range.
* CPU: the gather formulation's expert rows, gate weights per slot and
  destination rows equal the scatter formulation the dispatch had before
  (``index_add_`` of k copies of each token, ``scatter_reduce_`` of the
  token ids) bit for bit, and so does ``moe_apply``'s dispatch buffer.
* Card (skipped without one): the kernel equals the plain version exactly
  at a wave prefill's shape (t 16384, k 8, e 128, cap 1280) and a decode
  call's (t 16), on skewed routing and on the sharded blocks; each call
  launches it twice; a CUDA tensor never takes the plain version.  On a
  machine with a card and no JAX:

      python -m pytest -q --noconftest -m cuda tests/test_torch_moe_dispatch.py

This file imports nothing of JAX or of the JAX package."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.kernels import moe_dispatch as MD  # noqa: E402
from repro_torch.nn import moe as t_moe  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")


def _routing(rng, t, k, e, skew=0.0):
    """(t*k,) int64 expert ids, each token's k distinct, token-major:
    ``skew`` > 0 favours a few experts, as a collapsed router does."""
    bias = np.zeros(e)
    bias[: max(1, e // 16)] = skew
    scores = rng.randn(t, e) + bias
    return torch.from_numpy(np.argsort(-scores, axis=1, kind="stable")[:, :k].reshape(-1).copy())


def _definition(eid, cap, e0, el, before=None):
    """slot, pair_of_slot and the drop count pair by pair: a pair's
    position is the number of its expert's pairs before it (plus
    ``before[i]``, the pairs of its expert ahead of its block globally)."""
    ids = eid.numpy()
    n = len(ids)
    slot = np.full(n, el * cap, np.int64)
    pair_of_slot = np.full(el * cap, n, np.int64)
    dropped = 0
    for i in range(n):
        pos = int(np.count_nonzero(ids[:i] == ids[i])) + (0 if before is None else before[i])
        if pos >= cap:
            dropped += 1
        elif e0 <= ids[i] < e0 + el:
            slot[i] = (ids[i] - e0) * cap + pos
            pair_of_slot[slot[i]] = i
    return slot, pair_of_slot, dropped


def _slots(pair_of_slot, n, el, cap):
    """Each pair's slot, from the map of slots to pairs: ``el * cap``
    (the overflow row) for a pair that fills none."""
    filled = pair_of_slot < n
    return torch.full((n,), el * cap, dtype=torch.int64).scatter_(
        0, pair_of_slot[filled], torch.arange(el * cap)[filled])


# (t, k, e, cap, skew): t*k = 111 and 2100 are not multiples of the
# kernel's tile (1024 pairs); cap 4 drops most pairs; cap 600 >= t*k none
CASES = [(37, 3, 16, 8, 0.0), (700, 3, 16, 4, 0.0), (300, 2, 16, 600, 0.0),
         (256, 8, 128, 20, 0.0), (256, 8, 128, 20, 4.0), (16, 8, 128, 4, 0.0)]
IDS = [f"t{t}-k{k}-e{e}-cap{c}" + ("-skew" if s else "") for t, k, e, c, s in CASES]


@pytest.mark.parametrize("t,k,e,cap,skew", CASES, ids=IDS)
def test_plain_dispatch_is_the_definition(t, k, e, cap, skew):
    eid = _routing(np.random.RandomState(t + e), t, k, e, skew)
    pair_of_slot, dropped = MD.dispatch(eid, e, cap)
    want = _definition(eid, cap, 0, e)
    assert np.array_equal(pair_of_slot.numpy(), want[1])
    assert np.array_equal(_slots(pair_of_slot, t * k, e, cap).numpy(), want[0])
    assert dropped.dim() == 0 and int(dropped) == want[2]
    if t * k >= 8 * cap * e:                          # far past capacity
        assert want[2] > t * k // 2
    if cap >= t * k:
        assert want[2] == 0


def _sharded_case(t=96, k=4, e=16, blocks=(1, 3), n_blocks=4, skew=0.0, seed=3):
    """A global routing of ``n_blocks`` blocks of t tokens, of which a rank
    holds ``blocks`` (its pod group's, 'pod' major); the offsets the
    sharded step's hook would give it, and each held pair's pairs ahead
    of its block globally."""
    glob = _routing(np.random.RandomState(seed), n_blocks * t, k, e, skew).reshape(n_blocks, -1)
    eid = glob[list(blocks)].reshape(-1)
    counts = torch.stack([torch.bincount(glob[b], minlength=e) for b in range(n_blocks)])
    ahead = torch.cumsum(counts, dim=0) - counts
    seen = []

    def offsets(c):
        seen.append(c.clone())
        return ahead[list(blocks)].to(c.device)

    before = np.concatenate([ahead[b].numpy()[glob[b].numpy()] for b in blocks])
    return eid, offsets, seen, counts[list(blocks)], before


def test_plain_dispatch_counts_a_ranks_blocks_in_the_global_order():
    e, cap, e0, el = 16, 30, 4, 8
    eid, offsets, seen, counts, before = _sharded_case(e=e)
    pair_of_slot, dropped = MD.dispatch(eid, e, cap, (e0, el), blocks=2, offsets=offsets)
    assert len(seen) == 1 and torch.equal(seen[0], counts)
    want = _definition(eid, cap, e0, el, before)
    assert np.array_equal(pair_of_slot.numpy(), want[1])
    assert int(dropped) == want[2] > 0
    # pairs outside the expert range fill no slot
    slot = _slots(pair_of_slot, eid.numel(), el, cap)
    assert np.array_equal(slot.numpy(), want[0])
    outside = (eid < e0) | (eid >= e0 + el)
    assert bool(outside.any()) and bool((slot[outside] == el * cap).all())


def test_dispatch_refuses_what_it_does_not_take():
    eid = torch.zeros(12, dtype=torch.int64)
    with pytest.raises(TypeError):
        MD.dispatch(eid.int(), 4, 4)
    with pytest.raises(ValueError):
        MD.dispatch(eid, 4, 4, blocks=5)
    with pytest.raises(ValueError):
        MD.dispatch(eid, 4, 4, (2, 3))
    before = MD.launches
    MD.dispatch(eid, 4, 4)
    assert MD.launches == before                     # the plain version launches nothing


def _scatter_formulation(xt, gate_vals, slot, k, el, cap):
    """The dispatch before the gather: k copies of each token, the kept
    ones scatter-added into zeroed rows, the gate weights the same way,
    and each slot's token by a max-reduction of the token ids."""
    t, d = xt.shape
    keep = slot < el * cap
    src = xt.repeat_interleave(k, dim=0)
    buf = torch.zeros((el * cap + 1, d), dtype=xt.dtype).index_add_(
        0, slot, src * keep[:, None].to(xt.dtype))
    w_buf = torch.zeros((el * cap + 1,), dtype=torch.float32).index_add_(
        0, slot, gate_vals.reshape(-1) * keep)
    tok_ids = torch.arange(t).repeat_interleave(k)
    tok_of_slot = torch.full((el * cap + 1,), -1, dtype=torch.int64).scatter_reduce_(
        0, slot, torch.where(keep, tok_ids, -1), "amax", include_self=True)
    dest = torch.where(tok_of_slot >= 0, tok_of_slot, t)
    return buf[: el * cap], w_buf[: el * cap], dest[: el * cap]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t,k,e,cap,skew", CASES, ids=IDS)
def test_gather_equals_the_scatter_formulation(t, k, e, cap, skew, dtype):
    rng = np.random.RandomState(7)
    d = 24
    eid = _routing(rng, t, k, e, skew)
    xt = torch.from_numpy(rng.randn(t, d).astype(np.float32)).to(dtype)
    gate_vals = torch.from_numpy(rng.rand(t, k).astype(np.float32))
    pair_of_slot, _ = MD.dispatch(eid, e, cap)
    slot = _slots(pair_of_slot, t * k, e, cap)
    tok = pair_of_slot // k
    buf = torch.cat([xt, torch.zeros((1, d), dtype=dtype)])[tok]
    w_buf = torch.cat([gate_vals.reshape(-1), torch.zeros(1)])[pair_of_slot]
    want = _scatter_formulation(xt, gate_vals, slot, k, e, cap)
    assert torch.equal(buf, want[0])
    assert torch.equal(w_buf, want[1])
    assert torch.equal(tok, want[2])


@pytest.mark.parametrize("capacity", [1.25, 0.25])
def test_moe_apply_fills_the_experts_rows_as_the_scatter_did(capacity, monkeypatch):
    cfg = api.configs.get("qwen3-moe-30b-a3b").scaled()
    cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))
    p = t_moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 16, cfg.d_model).astype(np.float32))
    seen = []
    real = t_moe.constrain
    monkeypatch.setattr(t_moe, "constrain", lambda v, *a, **kw: seen.append(v) or real(v, *a, **kw))
    t_moe.moe_apply(p, x, cfg)
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    t = 32
    cap = max(int(np.ceil(capacity * t * k / e)), 4)
    xt = x.reshape(t, -1)
    _, idx = t_moe.route(p, xt, cfg)
    pair_of_slot, _ = MD.dispatch_plain(idx.reshape(-1), e, cap, (0, e))
    slot = _slots(pair_of_slot, t * k, e, cap)
    want = _scatter_formulation(xt, torch.zeros(t, k), slot, k, e, cap)[0]
    assert torch.equal(seen[0].reshape(e * cap, -1), want)


def _dispatch_span(p, x, cfg):
    """``moe_apply`` under a fresh tracer: its ``moe.dispatch`` span."""
    old = obs_trace.get_tracer()
    tracer = obs_trace.Tracer(enabled=True)
    obs_trace.set_tracer(tracer)
    try:
        t_moe.moe_apply(p, x, cfg)
    finally:
        obs_trace.set_tracer(old)
    rec, = [r for r in tracer.spans() if r.name == "moe.dispatch"]
    return rec


def test_the_span_says_the_plain_version_ran_on_the_cpu():
    cfg = api.configs.get("qwen3-moe-30b-a3b").scaled()
    p = t_moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 16, cfg.d_model).astype(np.float32))
    before = MD.launches
    rec = _dispatch_span(p, x, cfg)
    assert MD.launches == before
    assert rec.attrs["kernel"] == 0 and rec.attrs["tokens"] == 32


# ------------------------------------------------------------------ the card
CARD_CASES = [(16384, 8, 128, 1280, 0.0), (16384, 8, 128, 1280, 6.0), (16, 8, 128, 4, 0.0),
              (700, 3, 16, 4, 0.0), (5000, 2, 16, 700, 3.0)]
CARD_IDS = [f"t{t}-k{k}-e{e}-cap{c}" + ("-skew" if s else "") for t, k, e, c, s in CARD_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("t,k,e,cap,skew", CARD_CASES, ids=CARD_IDS)
def test_kernel_equals_plain_on_the_card(t, k, e, cap, skew):
    _card()
    eid = _routing(np.random.RandomState(t + e), t, k, e, skew)
    want = MD.dispatch(eid, e, cap)
    before = MD.launches
    got = MD.dispatch(eid.cuda(), e, cap)
    torch.cuda.synchronize()
    assert MD.launches == before + 2
    for g, w, what in zip(got, want, ("pair_of_slot", "dropped")):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w), what


@pytest.mark.cuda
@pytest.mark.parametrize("t", [96, 5000])
def test_kernel_counts_a_ranks_blocks_on_the_card(t):
    _card()
    e, cap, e0, el = 16, 2 * t // 4 + 3, 4, 8
    eid, offsets, seen, counts, _ = _sharded_case(t=t, e=e, skew=2.0)
    want = MD.dispatch(eid, e, cap, (e0, el), blocks=2, offsets=offsets)
    got = MD.dispatch(eid.cuda(), e, cap, (e0, el), blocks=2, offsets=offsets)
    torch.cuda.synchronize()
    assert torch.equal(seen[1].cpu(), counts)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_a_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    _card()

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(MD, "dispatch_plain", refuse)
    cfg = api.configs.get("qwen3-moe-30b-a3b").scaled()
    p = t_moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cuda")
    x = torch.randn(2, 16, cfg.d_model, device="cuda")
    before = MD.launches
    rec = _dispatch_span(p, x, cfg)
    assert MD.launches == before + 2
    assert rec.attrs["kernel"] == 1 and rec.attrs["pairs"] == 32 * cfg.moe.top_k
