"""The sharded step of every model family: the port's twin of GSPMD
partitioning ``jax.jit(fn)`` under ``in_shardings``.

The JAX package shards a train, prefill or decode step by handing
``jax.jit`` the specs of ``parallel/sharding.py`` and letting GSPMD place
every collective (hinted by ``constrain`` in ``models/lm.py`` and
``nn/moe.py``).  The port has no partitioner, so this module places them
by hand: each rank of :func:`~.spmd.shard_map` runs the port's own
``models/`` and ``nn/`` functions on its shards (one copy of the model
code; on one device its hooks are absent and nothing changes), with a
:class:`Rank` passed as ``dist`` that puts a collective wherever the
specs split a tensor.  :data:`FAMILIES` says where each family keeps its
parameters and its cache (:class:`Family`); a family it does not name
raises.  The LM family (dense, moe, vlm; ``models/lm.py``):

* column-parallel projections (``wq``, ``wk``, ``wv``, ``w_gate``,
  ``w_up``) run local, on a per-rank view of the config (heads and
  ``d_ff`` divided); ``patch_proj``'s output is split over ``d_model``
  and is gathered over 'model' before it joins the stream;
* row-parallel projections (``wo``, ``w_down``) end in a ``psum`` over
  'model';
* the embedding looks up the rank's vocabulary range (zero outside it)
  and ``psum``\\ s; the logits stay split over the vocabulary and the
  cross-entropy is vocabulary-parallel (``pmax`` and ``psum`` over
  'model', the gold logit from its owner, padded columns masked by
  global index);
* the mean over tokens and the gradients are summed over 'data';
* where a spec cuts what the local math needs whole, the step gathers it
  and reduce-scatters its gradient: ``wk`` / ``wv`` when the KV heads do
  not divide over 'model', the expert weights' second dim on 'data';
* MoE: each 'model' rank runs its experts, then a ``psum``; the capacity
  comes from the global token count, each token's position in its
  expert is counted in the global token order (an exclusive prefix of
  the per-expert counts over the 'data' ranks), the auxiliary loss is
  ``e * sum(me * ce)`` of the global means, and the dispatch buffer is
  cut along the capacity over 'data' as ``constrain`` pins it;
* the decode cache is laid out by ``cache_specs``: batch on 'data', or
  (batch 1) the sequence on 'data'; the cached positions on 'model'
  flash-decode style, else the KV heads, else the head dim.  A rank
  combines partial softmaxes over the split positions (as
  ``sp_attention.sp_decode_attention`` does) and each new K/V position
  is written by the rank that holds it.

The other families reuse those hooks and add a region per recurrent
block (``Rank.whole``, ``rows``, ``head_split``):

* hybrid (zamba2, ``models/hybrid.py``): the shared block is an LM layer
  (its attention and MLP on the rank's heads and columns, a KV cache per
  group); a Mamba2 layer (``nn/ssm.py``) gathers ``in_proj``'s output
  and ``conv_w`` whole over 'model', runs the conv, the SSD and the gated
  norm on every head, and ends in the row-parallel ``out_proj`` and a
  ``psum``;
* ssm (xLSTM, ``models/xlstm_model.py``, ``nn/xlstm.py``): an mLSTM
  block gathers ``up_proj``'s output and ``conv_w``, runs the GLA on the
  rank's heads where they divide over 'model' (else gathers ``wq`` /
  ``wk`` / ``wv`` and runs all), and ends in ``down_proj``; an sLSTM block
  gathers ``w_gates``, ``r_gates`` and ``w_up`` once a call, runs the
  recurrence with every gate on the rank (no collective in its time
  loop), and ends in ``w_down``; the embedding is tied;
* audio (the encoder-decoder, ``models/encdec.py``): ``frame_proj``'s
  output is gathered as ``patch_proj``'s; the encoder's attention is
  non-causal; cross-attention's K / V come from ``memory`` (which enters
  each region as the stream does) through the rank's ``wk`` / ``wv``.

In each recurrent region every gradient is partial (its f at the input,
its g after the last projection), so its replicated parameters
(``A_log``, ``D``, ``dt_bias``, ``norm_scale``, the gates' weights and
biases, ``skip_scale``) are summed over 'model' and its gathers' adjoints
reduce-scatter.  ``cache_specs`` lays the recurrent states out with
'model' on their last dim that divides and 'data' on the first dim as
long as the batch (where the batch divides); a rank computes with the
batch as the stream's and every other dim whole, so each serving call
re-lays them out at its entry (gathers) and writes its block back at
its exit (:meth:`Rank.states_in`, :meth:`Rank.states_out`).  An
encoder-decoder's prefill places ``memory`` in the cache (the reference
has no spec for it): batch on 'data' where the batch divides, else
replicated.

The backward keeps every collective on the rank threads.  On the card
PyTorch runs the backward of every rank of one device on one autograd
thread, where a collective inside a ``torch.autograd.Function`` would
wait for ranks that can never arrive.  So every collective point of the
forward is a *cut*: its input is detached and its output a fresh leaf,
and :meth:`Rank.backward` walks the cuts from the last to the first,
applying each collective's adjoint on the rank thread (Megatron's *f*:
identity forward, ``psum`` backward; *g*: ``psum`` forward, identity
backward; a gather's adjoint a reduce-scatter) and calling
``backward()`` on the local segment before it.  The loss and the MoE
auxiliary loss carry local surrogates whose gradients are the rank's
share of the global one.  The forward keeps its graph (no remat: the
step's activations are small beside its weights).

The entry points run on the mesh's explicit devices (the card unless the
caller builds a CPU mesh); a mesh has the axes ``'data'`` and / or
``'model'``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .. import tree as T
from ..models import encdec, hybrid, lm, xlstm_model
from ..nn.attention import NEG_INF, _gqa_scores, _gqa_values, attention
from ..nn.core import apply_rope, linear, rms_head_norm
from ..optim import adamw
from . import sharding as shd
from . import spmd
from .spmd import Mesh, P, Placed

__all__ = ["Rank", "Family", "FAMILIES", "sharded_loss", "sharded_loss_and_grads",
           "sharded_train_step", "sharded_prefill", "sharded_decode_step", "place_params",
           "place_opt_state", "init_cache", "DP"]

# the data-parallel axes of the step (the reference's tests shard the
# batch on ('data',))
DP = ("data",)
_AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Family:
    """Where a model family keeps what the sharded step reads.

    ``attn`` / ``mlp`` / ``moe``: the path of one layer's attention, MLP
    and MoE parameters in the tree (every attention and MLP of the family
    has the same shapes, so the same specs), under ``stack`` leading
    stacked-layer dims.  ``regions``: the keys of the tensor-parallel
    regions (between the step's f and g), where a replicated parameter
    gets a partial gradient on every 'model' rank.  ``kv``: the cache's
    path to the dict holding ``k``, ``v`` and ``pos``; ``states``: the
    cache's path to the recurrent states, whose batch dim is
    ``state_batch``; ``memory``: the cache holds the encoder's output."""
    module: Any
    regions: Tuple[str, ...]
    attn: Optional[Tuple[str, ...]] = None
    mlp: Optional[Tuple[str, ...]] = None
    moe: Optional[Tuple[str, ...]] = None
    stack: int = 0
    kv: Optional[Tuple[str, ...]] = None
    states: Optional[Tuple[str, ...]] = None
    state_batch: int = 0
    memory: bool = False


_LM = Family(lm, ("attn", "mlp", "moe"), attn=("blocks", "attn"), mlp=("blocks", "mlp"),
             moe=("blocks", "moe"), stack=1, kv=())
FAMILIES = {
    "dense": _LM, "moe": _LM, "vlm": _LM,
    "hybrid": Family(hybrid, ("attn", "mlp", "mamba"), attn=("shared", "attn"),
                     mlp=("shared", "mlp"), kv=("attn",), states=("mamba",), state_batch=2),
    "ssm": Family(xlstm_model, ("core",), states=()),
    "audio": Family(encdec, ("attn", "self_attn", "cross_attn", "mlp"), attn=("encoder", "attn"),
                    mlp=("encoder", "mlp"), stack=1, kv=("kv",), memory=True),
}


def _size(mesh: Mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1)
    return n


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _split(spec, dim: int) -> Tuple[str, ...]:
    return _axes_of(spec[dim]) if dim < len(spec) else ()


def _named(spec) -> set:
    return {a for e in spec for a in _axes_of(e)}


def _at(tree: Any, path: Optional[Tuple[str, ...]]) -> Any:
    """The subtree at ``path`` (None where a key is missing)."""
    if path is None:
        return None
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


def _layer_specs(pspecs: Any, path, stack: int) -> Any:
    """One layer's specs: the subtree at ``path`` without its ``stack``
    leading stacked-layer dims."""
    sub = _at(pspecs, path)
    return None if sub is None else shd.map_specs(lambda s: P(*tuple(s)[stack:]), sub)


def _check_mesh(mesh: Mesh) -> None:
    extra = [a for a in mesh.axis_names if a not in _AXES]
    if extra:
        raise ValueError(f"the sharded step runs on meshes with axes {_AXES}; this one has "
                         f"{mesh.axis_names}")


class Rank:
    """One rank's view of a sharded call, passed to the model code as
    ``dist``: the mesh's axes, this rank's coordinates, the specs of its
    parameters (and of its cache), and the collective at each hook.

    ``train`` records the cuts for :meth:`backward`; without it every cut
    is its plain collective."""

    def __init__(self, mesh: Mesh, pspecs: Any, dp: bool, train: bool = False,
                 kv_spec: Optional[P] = None, pos0: int = 0, family: Family = _LM):
        self.mesh = mesh
        self.m = mesh.shape.get("model", 1)
        self.mi = spmd.axis_index("model") if self.m > 1 else 0
        self.dsz = _size(mesh, DP)
        self.di = spmd.axis_index(DP) if self.dsz > 1 else 0
        self.dp = dp
        self.tape = [] if train else None
        self.kv_spec = kv_spec
        self.pos0 = pos0
        self.regions = family.regions
        # one layer's specs (the stacked dims dropped)
        self.attn_specs = _layer_specs(pspecs, family.attn, family.stack)
        self.mlp_specs = _layer_specs(pspecs, family.mlp, family.stack)
        self.moe_specs = _layer_specs(pspecs, family.moe, family.stack)
        self.embed_split = "model" in _split(pspecs["embed"], 0)
        self._moe_slice = None
        self._cap_cut = False

    # ------------------------------------------------------------ collectives
    def _psum(self, x, axes):
        return spmd.psum(x, axes) if _size(self.mesh, axes) > 1 else x

    def _cut(self, src: torch.Tensor, fwd, bwd) -> torch.Tensor:
        """``fwd(src)`` as a fresh leaf whose gradient :meth:`backward`
        sends back through ``bwd``, outside autograd."""
        if self.tape is None or not src.requires_grad:
            return fwd(src)
        dst = fwd(src.detach()).requires_grad_()
        self.tape.append((src, dst, bwd))
        return dst

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f: a replicated value enters a tensor-parallel region
        (identity forward, ``psum`` over 'model' backward)."""
        if self.m == 1:
            return x
        return self._cut(x, lambda t: t, lambda g: spmd.psum(g, "model"))

    def reduce(self, h: torch.Tensor) -> torch.Tensor:
        """Megatron's g: the region's partial sums leave it (``psum`` over
        'model' forward, identity backward)."""
        if self.m == 1:
            return h
        return self._cut(h, lambda t: spmd.psum(t, "model"), lambda g: g)

    def _gather(self, x, axes, dim: int, partial: bool):
        """``all_gather`` along ``dim``; the adjoint reduce-scatters a
        gradient that is partial over ``axes`` and slices one that is not."""
        n = _size(self.mesh, axes)
        if n == 1:
            return x
        w = x.shape[dim]
        i = spmd.axis_index(axes)

        def bwd(g):
            if partial:
                return spmd.psum_scatter(g, axes, scatter_dimension=dim, tiled=True)
            return g.narrow(dim, i * w, w).contiguous()
        return self._cut(x, lambda t: spmd.all_gather(t, axes, axis=dim, tiled=True), bwd)

    def backward(self, total: torch.Tensor, leaves: Sequence[torch.Tensor]) -> list:
        """This rank's share of the gradient of ``total`` for each of
        ``leaves``: the local segment of the loss first, then each cut from
        the last to the first, its collective's adjoint applied on this
        thread before the segment that feeds it.  Gradients are summed
        here, out of place (``.grad`` accumulation may alias one leaf's
        gradient with another's)."""
        tape, self.tape = self.tape, []
        dsts = [dst for _, dst, _ in tape]
        leaves = list(leaves)
        acc: list = [None] * (len(tape) + len(leaves))
        params = list(range(len(tape), len(acc)))

        def push(out, grad, upto: int) -> None:
            index = list(range(upto)) + params
            got = torch.autograd.grad(out, dsts[:upto] + leaves, grad, retain_graph=True,
                                      allow_unused=True)
            for i, g in zip(index, got):
                if g is not None:
                    acc[i] = g if acc[i] is None else acc[i] + g

        push(total, None, len(tape))
        for j in range(len(tape) - 1, -1, -1):
            src, dst, bwd = tape[j]
            push(src, bwd(acc[j] if acc[j] is not None else torch.zeros_like(dst)), j)
        return [g if g is not None else torch.zeros_like(l)
                for g, l in zip(acc[len(tape):], leaves)]

    def grads(self, paths, specs, grads: list) -> list:
        """Each leaf's gradient, reduced over the axes it is neither split
        on nor already reduced over: 'data' where the batch is split on it;
        'model' for a replicated leaf inside a tensor-parallel region.  A
        leaf split on 'data' was reduce-scattered at its gather."""
        grads = list(grads)
        groups: Dict[tuple, list] = {}
        for j, (path, spec) in enumerate(zip(paths, specs)):
            named = _named(spec)
            axes = []
            if "data" not in named and self.dp:
                axes.append("data")
            if "model" not in named and any(r in path for r in self.regions):
                axes.append("model")
            axes = tuple(a for a in _AXES if a in axes and self.mesh.shape.get(a, 1) > 1)
            if axes:
                groups.setdefault(axes, []).append(j)
        for axes, idx in groups.items():
            summed = spmd.psum([grads[j] for j in idx], axes)
            for j, g in zip(idx, summed):
                grads[j] = g
        return grads

    def global_norm(self, specs, grads) -> torch.Tensor:
        """The global norm of the sharded gradients: each leaf's squared
        norm summed over the axes it is split on (a replicated leaf counted
        once), then over the leaves in order."""
        sq = [torch.sum(torch.square(g.to(torch.float32))) for g in grads]
        groups: Dict[tuple, list] = {}
        for j, spec in enumerate(specs):
            axes = tuple(a for a in _AXES if a in _named(spec) and self.mesh.shape.get(a, 1) > 1)
            if axes:
                groups.setdefault(axes, []).append(j)
        for axes, idx in groups.items():
            summed = spmd.psum(torch.stack([sq[j] for j in idx]), axes)
            for n, j in enumerate(idx):
                sq[j] = summed[n]
        total = 0
        for s in sq:
            total = total + s
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))

    # ------------------------------------------------------------- the stream
    def stream_shape(self, x: torch.Tensor) -> tuple:
        """The global shape of a stream activation (batch first)."""
        return (x.shape[0] * (self.dsz if self.dp else 1), *x.shape[1:])

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The vocabulary-parallel lookup: the rank's rows, zero outside
        its range, summed over 'model'."""
        if not self.embed_split or self.m == 1:
            return table[tokens.long()]
        vl = table.shape[0]
        idx = tokens.long() - self.mi * vl
        mine = (idx >= 0) & (idx < vl)
        x = table[idx.clamp(0, vl - 1)] * mine[..., None].to(table.dtype)
        return self.reduce(x)

    def columns(self, pe: torch.Tensor, full: int) -> torch.Tensor:
        """A stub frontend's output (``patch_proj``, ``frame_proj``), split
        over ``d_model`` (``full`` wide), gathered over 'model' before it
        joins the replicated stream."""
        if pe.shape[-1] == full:
            return pe
        return self._gather(pe, ("model",), pe.ndim - 1, partial=False)

    def region(self, fn, p, x: torch.Tensor, *args) -> torch.Tensor:
        """A tensor-parallel region (the MLP): ``fn(p, x, *args)`` on the
        rank's column / row blocks between f and g.  Weights the specs
        leave whole run on 'model' rank 0 alone."""
        x = self.enter(x)
        if self.m > 1 and "model" not in _split(self.mlp_specs["w_down"], 0):
            return self.reduce(fn(p, x, *args) if self.mi == 0 else torch.zeros_like(x))
        return self.reduce(fn(p, x, *args))

    def xent(self, logits: torch.Tensor, labels: torch.Tensor, real_vocab: int) -> torch.Tensor:
        """The vocabulary-parallel mean cross-entropy: its value global, its
        gradient the rank's share (a surrogate)."""
        lf = logits.float()
        vl = lf.shape[-1]
        v0 = self.mi * vl
        col = v0 + torch.arange(vl, device=lf.device)
        lf = torch.where(col < real_vocab, lf, torch.full_like(lf, -1e30))
        lab = labels.long() - v0
        mine = (lab >= 0) & (lab < vl)
        gold = torch.gather(lf, -1, lab.clamp(0, vl - 1)[..., None])[..., 0] * mine
        n = labels.numel() * (self.dsz if self.dp else 1)
        with torch.no_grad():
            mx = lf.amax(dim=-1)
            mx = spmd.pmax(mx, "model") if self.m > 1 else mx
            se, g = self._psum([torch.exp(lf - mx[..., None]).sum(dim=-1), gold], ("model",))
            total = torch.sum(torch.log(se) + mx - g)
            if self.dp:
                total = self._psum(total, DP)
            value = total / n
            prob = torch.exp(lf - mx[..., None]) / se[..., None]
        sur = (torch.sum(prob * lf) - torch.sum(gold)) / n
        return value + (sur - sur.detach())

    # -------------------------------------------------------------- attention
    def _heads(self, cfg):
        """(this rank's first q head, its q heads, the KV heads they use)."""
        h, kv = cfg.n_heads, cfg.n_kv_heads
        if self.m == 1 or "model" not in _split(self.attn_specs["wq"], 1):
            return 0, h, 0, kv
        if h % self.m:
            raise NotImplementedError(f"{cfg.name}: {h} q heads do not split over "
                                      f"'model' = {self.m}")
        hl = h // self.m
        h0 = self.mi * hl
        g = h // kv
        if hl % g and g % hl:
            raise NotImplementedError(f"{cfg.name}: {hl} q heads a rank, {g} a KV head")
        return h0, hl, h0 // g, max(hl // g, 1)

    def attention(self, p, xn: torch.Tensor, cfg, cache=None, causal: bool = True,
                  memory: Optional[torch.Tensor] = None):
        """Self-attention (``causal`` or not), or cross-attention to
        ``memory`` (the encoder's output, replicated over 'model' like the
        stream: it enters the region too), on the rank's heads."""
        if cache is not None:
            return self._cached_attention(p, xn, cfg, cache)
        hd = cfg.hd
        h0, hl, kv0, kvl = self._heads(cfg)
        x = self.enter(xn)
        mem = None if memory is None else self.enter(memory)
        if hl == cfg.n_heads and self.m > 1:
            # the specs leave the attention whole: 'model' rank 0 runs it
            if self.mi:
                return self.reduce(torch.zeros_like(x)), None
            out, _ = attention(p, x, cfg, causal=causal, memory=mem)
            return self.reduce(out), None
        q = dict(p)
        for name in ("wk", "wv"):
            w = p[name]
            base = 0
            if "model" in _split(self.attn_specs[name], 1):
                if cfg.n_kv_heads % self.m:
                    # the column split cuts the KV heads: gather them whole
                    w = self._gather(w, ("model",), 1, partial=True)
                else:
                    base = kv0
            q[name] = w.narrow(1, (kv0 - base) * hd, kvl * hd)
        local = dataclasses.replace(cfg, n_heads=hl, n_kv_heads=kvl, head_dim=hd)
        out, _ = attention(q, x, local, causal=causal, memory=mem)
        return self.reduce(out), None

    def _layout(self) -> Tuple[Tuple[str, ...], ...]:
        spec = tuple(self.kv_spec)[1:] + (None,) * 5
        return tuple(_axes_of(spec[d]) for d in range(1, 4))   # positions, KV heads, head dim

    def _cached_attention(self, p, xn: torch.Tensor, cfg, cache):
        b, s, _ = xn.shape
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        model = self.m > 1
        q = linear(xn, p["wq"])
        k = linear(xn, p["wk"])
        v = linear(xn, p["wv"])
        if model and "model" in _split(self.attn_specs["wq"], 1):
            q = spmd.all_gather(q, "model", axis=2, tiled=True)
        if model and "model" in _split(self.attn_specs["wk"], 1):
            k, v = (spmd.all_gather(t, "model", axis=2, tiled=True) for t in (k, v))
        q, k, v = q.reshape(b, s, h, hd), k.reshape(b, s, kv, hd), v.reshape(b, s, kv, hd)
        if cfg.qk_norm:
            q = rms_head_norm(q, p["q_norm"])
            k = rms_head_norm(k, p["k_norm"])
        steps = torch.arange(s, dtype=torch.int32, device=xn.device)
        positions = cache["pos"] + steps[None]
        q = apply_rope(q, positions, cfg.rope, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope, cfg.rope_theta)
        out = self._partial_softmax(q, k, v, cache, 1.0 / float(hd) ** 0.5)
        h0, hl, _, _ = self._heads(cfg)
        if hl == h and model and self.mi:
            o = torch.zeros_like(xn)      # the specs leave wo whole: rank 0 applies it
        else:
            o = linear(out[:, :, h0:h0 + hl].reshape(b, s, hl * hd), p["wo"])
        return self.reduce(o), {"k": cache["k"], "v": cache["v"], "pos": cache["pos"] + s}

    def _partial_softmax(self, q, k, v, cache, sm_scale: float) -> torch.Tensor:
        """Attention of every q head over the rank's block of the cache,
        the new positions written first by the rank that holds them; the
        blocks' partial softmaxes combined over the axes that split the
        positions, the head dim and the KV heads."""
        t_ax, kv_ax, hd_ax = self._layout()
        ck, cv = cache["k"], cache["v"]                      # (B, T, KV, hd) blocks
        tl, kvl, hdl = ck.shape[1:]
        t0 = (spmd.axis_index(t_ax) if t_ax else 0) * tl
        kv0 = (spmd.axis_index(kv_ax) if kv_ax else 0) * kvl
        d0 = (spmd.axis_index(hd_ax) if hd_ax else 0) * hdl
        b, s = q.shape[:2]
        pos0 = self.pos0
        lo, hi = max(pos0, t0), min(pos0 + s, t0 + tl)
        if lo < hi:
            ck[:, lo - t0:hi - t0] = k[:, lo - pos0:hi - pos0, kv0:kv0 + kvl,
                                       d0:d0 + hdl].to(ck.dtype)
            cv[:, lo - t0:hi - t0] = v[:, lo - pos0:hi - pos0, kv0:kv0 + kvl,
                                       d0:d0 + hdl].to(cv.dtype)
        g = q.shape[2] // k.shape[2]
        qh = q[:, :, kv0 * g:(kv0 + kvl) * g, d0:d0 + hdl]
        scores = _gqa_scores(qh.float(), ck.float()) * sm_scale      # (B, Hh, s, T)
        if hd_ax:
            scores = spmd.psum(scores, hd_ax)
        kpos = t0 + torch.arange(tl, device=q.device)
        valid = kpos[None, :] < pos0 + s
        if s > 1:
            qpos = pos0 + torch.arange(s, device=q.device)
            valid = valid & (kpos[None, :] <= qpos[:, None])
        scores = torch.where(valid, scores, torch.tensor(NEG_INF, device=scores.device))
        mx = scores.amax(dim=-1)
        if t_ax:
            mx = spmd.pmax(mx, t_ax)
        prob = torch.exp(scores - mx[..., None])
        l_sum = prob.sum(dim=-1)                                     # (B, Hh, s)
        acc = _gqa_values(prob, cv.float())                          # (B, s, Hh, hd)
        if t_ax:
            l_sum, acc = spmd.psum([l_sum, acc], t_ax)
        out = acc / l_sum.permute(0, 2, 1)[..., None]
        if hd_ax:
            out = spmd.all_gather(out, hd_ax, axis=3, tiled=True)
        if kv_ax:
            out = spmd.all_gather(out, kv_ax, axis=2, tiled=True)
        return out.to(q.dtype)

    # ----------------------------------------------------- recurrent regions
    def whole(self, t: torch.Tensor, dim: int, full: int) -> torch.Tensor:
        """``t`` whole along ``dim`` (``full`` wide) inside a tensor-parallel
        region: a column block of a weight or of a projection's output,
        split over 'model' by the specs, is gathered, and its adjoint
        reduce-scatters (the region's gradient is partial)."""
        if t.shape[dim] == full:
            return t
        return self._gather(t, ("model",), dim % t.ndim, partial=True)

    def rows(self, h: torch.Tensor, w: torch.Tensor, full: int) -> torch.Tensor:
        """g after a row-parallel projection: ``h``'s channels (``full``
        in all; ``h`` holds them whole, or this rank's block of them) times
        ``w``'s rows (whole, or the rank's row block), summed over 'model'.
        Where both are whole (the rows do not divide over 'model'), each
        rank takes a near-equal block of them."""
        nh, nw = h.shape[-1], w.shape[0]
        if self.m == 1:
            return linear(h, w)
        if nh == full and nw == full:
            lo, hi = full * self.mi // self.m, full * (self.mi + 1) // self.m
            out = linear(h[..., lo:hi], w[lo:hi])
        elif nh == full:
            out = linear(h.narrow(-1, self.mi * nw, nw), w)
        elif nw == full:
            out = linear(h, w.narrow(0, self.mi * nh, nh))
        else:
            out = linear(h, w)
        return self.reduce(out)

    def head_split(self, ws: Sequence[torch.Tensor], nh: int, full: int):
        """``(ws, h0, hl)``: column-parallel head projections ``ws``
        (``full`` columns, ``nh`` heads) and the heads ``h0 .. h0 + hl``
        they give this rank.  Where the column blocks are whole heads
        (``nh`` divides over 'model') each rank runs its own heads; else
        the weights are gathered whole and every rank runs all heads."""
        if self.m == 1 or all(w.shape[-1] == full for w in ws):
            return list(ws), 0, nh
        if nh % self.m == 0:
            hl = nh // self.m
            return list(ws), self.mi * hl, hl
        return [self.whole(w, w.ndim - 1, full) for w in ws], 0, nh

    def join_heads(self, t: torch.Tensor, nh: int) -> torch.Tensor:
        """A state of this rank's heads (dim 1) joined over 'model' into
        every head's (serving: no gradient)."""
        if t.shape[1] == nh:
            return t
        return spmd.all_gather(t, "model", axis=1, tiled=True)

    def relayout(self, t: torch.Tensor, src: P, dst: P) -> torch.Tensor:
        """This rank's block of a value laid out by ``src``, re-laid out by
        ``dst``: each dim gathered over the axes only ``src`` splits it on,
        then cut to this rank's block over those only ``dst`` does.  Every
        gather comes before every cut (one axis may move from one dim to
        another).  ``t`` itself where the two agree; else a fresh tensor."""
        def axes(spec, d):
            return tuple(x for x in _split(spec, d) if self.mesh.shape.get(x, 1) > 1)

        moved = [d for d in range(t.ndim) if axes(src, d) != axes(dst, d)]
        out = t
        for d in moved:
            if axes(src, d):
                out = spmd.all_gather(out, axes(src, d), axis=d, tiled=True)
        for d in moved:
            b = axes(dst, d)
            if b:
                w = out.shape[d] // _size(self.mesh, b)
                out = out.narrow(d, spmd.axis_index(b) * w, w)
        return out if out is t else out.clone()

    def states_in(self, cache: Any, cspecs: Any, family: Family):
        """The cache with each recurrent state (``family.states``) re-laid
        out from the cache's layout (``cache_specs``: 'model' on the last
        dim that divides; where the batch divides, 'data' on the first dim
        as long as the batch, which may be a stacked layer dim) into the
        one the rank computes in (the batch as the stream's, every other
        dim whole), and what :meth:`states_out` writes back."""
        if family.states is None:
            return cache, []
        pairs, treedef = T.flatten_with_path(cache)
        out, back = [], []
        n = len(family.states)
        for (path, t), spec in zip(pairs, _flat_specs(cspecs)):
            if tuple(path[:n]) == family.states:
                want = P(*(None,) * family.state_batch, DP if self.dp else None)
                w = self.relayout(t, spec, want)
                if w is not t:
                    back.append((t, w, want, spec))
                t = w
            out.append(t)
        return T.unflatten(treedef, out), back

    def states_out(self, back) -> None:
        """Write each rank's block of the new states into the cache."""
        for t, w, src, dst in back:
            t.copy_(self.relayout(w, src, dst))

    # -------------------------------------------------------------------- MoE
    def enter_moe(self, x: torch.Tensor) -> torch.Tensor:
        """f, and the tokens this rank routes: its own where the batch is
        split on 'data'; else, where they divide, its block of the
        replicated tokens (gathered back at :meth:`leave_moe`)."""
        x = self.enter(x)
        self._moe_slice = None
        b, s, d = x.shape
        if not self.dp and self.dsz > 1 and (b * s) % self.dsz == 0:
            if self.tape is not None:
                raise NotImplementedError("the sharded train step splits the batch on 'data'")
            n = b * s // self.dsz
            self._moe_slice = (b, s)
            return x.reshape(1, b * s, d).narrow(1, self.di * n, n)
        return x

    def _moe_split(self) -> bool:
        return self.dsz > 1 and (self.dp or self._moe_slice is not None)

    def moe_tokens(self, t: int) -> int:
        return t * self.dsz if self._moe_split() else t

    def moe_aux(self, probs: torch.Tensor, top1: torch.Tensor, t_all: int) -> torch.Tensor:
        """``e * sum(me * ce)`` of the global means; its gradient this
        rank's share, on 'model' rank 0 alone (the others route the same
        tokens)."""
        e = probs.shape[-1]
        with torch.no_grad():
            sp, sc = probs.sum(dim=0), top1.sum(dim=0)
            if self._moe_split():
                sp, sc = spmd.psum([sp, sc], DP)
            me, ce = sp / t_all, sc / t_all
            value = e * torch.sum(me * ce)
        sur = e * torch.sum(ce * probs.sum(dim=0)) / t_all
        if self.mi:
            sur = sur * 0.0
        return value + (sur - sur.detach())

    def moe_offsets(self, counts: torch.Tensor) -> torch.Tensor:
        """Per expert, the (token, choice) pairs of the 'data' ranks before
        this one: positions counted in the global token order."""
        if not self._moe_split():
            return torch.zeros_like(counts)
        every = spmd.all_gather(counts, DP, axis=0, tiled=False)    # (ranks, e)
        return every[: self.di].sum(dim=0)

    def moe_experts(self, e: int) -> Tuple[int, int]:
        if self.m == 1:
            return 0, e
        if "model" not in _split(self.moe_specs["w_gate"], 0):
            raise NotImplementedError(f"{e} experts do not split over 'model' = {self.m}")
        el = e // self.m
        return self.mi * el, el

    def _cap_split(self, cap: int) -> bool:
        return self.dsz > 1 and cap % self.dsz == 0

    def moe_dispatch(self, h: torch.Tensor) -> torch.Tensor:
        """The capacity rows of this rank's experts, every 'data' rank's
        tokens in them: cut along the capacity over 'data' where it divides
        (as ``constrain`` pins it), else whole."""
        cap = h.shape[1]
        self._cap_cut = self._cap_split(cap)
        if not self._moe_split():
            if self._cap_split(cap):
                n = cap // self.dsz
                return h.narrow(1, self.di * n, n)
            return h
        if self._cap_split(cap):
            return self._cut(h, lambda t: spmd.psum_scatter(t, DP, scatter_dimension=1, tiled=True),
                             lambda g: spmd.all_gather(g, DP, axis=1, tiled=True))
        return self._cut(h, lambda t: spmd.psum(t, DP), lambda g: spmd.psum(g, DP))

    def moe_collect(self, o: torch.Tensor) -> torch.Tensor:
        """The experts' outputs over the whole capacity."""
        return self._gather(o, DP, 1, partial=True) if self._cap_cut else o

    def moe_weights(self, p) -> dict:
        """The rank's experts' weights whole: a second dim split on 'data'
        gathered (its gradient reduce-scattered)."""
        out = {}
        for name in ("w_gate", "w_up", "w_down"):
            if name not in p:
                continue
            w = p[name]
            if "data" in _split(self.moe_specs[name], 1):
                w = self._gather(w, DP, 1, partial=True)
            out[name] = w
        return out

    def leave_moe(self, out: torch.Tensor) -> torch.Tensor:
        if self._moe_slice is None:
            return out
        b, s = self._moe_slice
        self._moe_slice = None
        return self._gather(out, DP, 1, partial=False).reshape(b, s, out.shape[-1])


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------
def _sizes(mesh: Mesh) -> dict:
    return dict(mesh.shape)


def _on_mesh(mesh: Mesh, specs: Any) -> Any:
    return shd.map_specs(lambda s: shd.Sharding(mesh, s).spec, specs)


def place_params(mesh: Mesh, params: Any) -> Any:
    """``params`` placed on ``mesh`` by ``param_specs``."""
    return shd.place(params, shd.make_sharding(mesh, shd.param_specs(params, _sizes(mesh))))


def place_opt_state(mesh: Mesh, state: Any) -> Any:
    """An AdamW state placed on ``mesh`` by ``opt_specs`` (``m`` and ``v``
    as their parameters, ``step`` on every rank)."""
    pspecs = shd.param_specs(state["m"], _sizes(mesh))
    return shd.place(state, shd.make_sharding(mesh, shd.opt_specs(pspecs, state)))


def init_cache(model, mesh: Mesh, batch: int, max_len: int, dtype=None) -> Any:
    """The model's initial decode cache placed on ``mesh`` by
    ``cache_specs`` (each rank's block made on its device; the global
    cache is never built).  Each leaf of ``model.init_cache`` holds one
    value (zeros; an sLSTM's normalizer ``n`` ones), read from a cache of
    batch 1 and length 1."""
    meta = model.init_cache(batch, max_len, dtype=dtype, device="meta")
    fill = model.init_cache(1, 1, dtype=dtype, device="cpu")
    specs = shd.cache_specs(meta, batch, _size(mesh, DP), DP, _sizes(mesh))

    def one(sh: shd.Sharding, leaf: torch.Tensor, probe: torch.Tensor) -> Placed:
        value = probe.reshape(-1)[0].item()
        if not torch.all(probe == value):
            raise ValueError(f"init_cache: a leaf of shape {tuple(leaf.shape)} does not hold "
                             f"one value")
        shards = []
        for r, dev in enumerate(mesh.flat_devices()):
            blk = spmd.block_of(mesh, r, leaf, sh.spec)
            shards.append(torch.full(blk.shape, value, dtype=leaf.dtype, device=dev))
        return Placed(mesh, sh.spec, shards, leaf.shape, leaf.dtype)

    return shd.map_specs(one, shd.make_sharding(mesh, specs), meta, fill)


def _specs_of(mesh: Mesh, tree: Any, rule) -> Any:
    """The specs a call cuts ``tree`` by: a placed leaf's own, else
    ``rule``'s on this mesh."""
    ruled = _on_mesh(mesh, rule(tree))
    return shd.map_specs(lambda s, leaf: leaf.spec if isinstance(leaf, Placed) else s,
                         ruled, tree)


def _batch_specs(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, P]:
    return _on_mesh(mesh, shd.batch_specs(batch, DP, _sizes(mesh)))


def _family(model) -> Family:
    """The model's family; one the sharded step does not cover raises
    (it never runs unsharded)."""
    fam = FAMILIES.get(model.cfg.family)
    if fam is None:
        raise NotImplementedError(f"the sharded step covers the families {sorted(FAMILIES)}, "
                                  f"not {model.cfg.family} ({model.cfg.name})")
    return fam


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------
def _loss_and_grads(rank: Rank, fam: Family, cfg, params: Any, batch: Dict[str, torch.Tensor],
                    pspecs: Any) -> Tuple[torch.Tensor, dict, list]:
    pairs, treedef = T.flatten_with_path(params)
    leaves = [leaf.detach().requires_grad_() for _, leaf in pairs]
    total, metrics = fam.module.loss_fn(T.unflatten(treedef, leaves), cfg, batch, remat=False,
                                        dist=rank)
    paths = [tuple(str(k) for k in path) for path, _ in pairs]
    grads = rank.grads(paths, _flat_specs(pspecs), rank.backward(total, leaves))
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _flat_specs(specs: Any) -> list:
    out = []
    shd.map_specs(lambda s: out.append(s), specs)
    return out


def _train_args(model, mesh: Mesh, params: Any, batch: Dict[str, Any]):
    fam = _family(model)
    _check_mesh(mesh)
    pspecs = _specs_of(mesh, params, lambda t: shd.param_specs(t, _sizes(mesh)))
    bspecs = _batch_specs(mesh, batch)
    dp = bool(_axes_of(bspecs["tokens"][0]))
    if _size(mesh, DP) > 1 and not dp:
        raise ValueError(f"the sharded train step splits the batch on 'data': batch "
                         f"{batch['tokens'].shape[0]} over {_size(mesh, DP)} ranks")
    return fam, pspecs, bspecs, dp


def sharded_loss_and_grads(model, mesh: Mesh, params: Any, batch: Dict[str, torch.Tensor],
                           timeout: Optional[float] = None) -> Tuple[torch.Tensor, list]:
    """The twin of ``train/loop.py::loss_and_grads`` on ``mesh``: the loss
    (the model's total, with the MoE auxiliary term) and every
    parameter's gradient in the tree's leaf order, assembled.  ``params``
    may be placed (``place_params``) or global; ``batch`` is global."""
    fam, pspecs, bspecs, dp = _train_args(model, mesh, params, batch)

    def body(p, b):
        rank = Rank(mesh, pspecs, dp, train=True, family=fam)
        loss, _, grads = _loss_and_grads(rank, fam, model.cfg, p, b, pspecs)
        return loss, grads

    fn = spmd.shard_map(body, mesh, (pspecs, bspecs), (P(), _flat_specs(pspecs)),
                        timeout=timeout)
    return fn(params, batch)


def sharded_loss(model, mesh: Mesh, params: Any, batch: Dict[str, torch.Tensor],
                 timeout: Optional[float] = None) -> Tuple[torch.Tensor, dict]:
    """``model.loss(params, batch)`` on ``mesh``: ``(total, metrics)``,
    global values (``{"loss", "aux"}`` for the LM family, ``{"loss"}``
    for the others)."""
    fam, pspecs, bspecs, dp = _train_args(model, mesh, params, batch)

    def body(p, b):
        rank = Rank(mesh, pspecs, dp, family=fam)
        with torch.no_grad():
            total, metrics = fam.module.loss_fn(p, model.cfg, b, remat=False, dist=rank)
        return total, metrics

    return spmd.shard_map(body, mesh, (pspecs, bspecs), P(), timeout=timeout)(params, batch)


def sharded_train_step(model, mesh: Mesh, params: Any, opt_state: Any,
                       batch: Dict[str, torch.Tensor], opt_cfg: adamw.AdamWConfig,
                       timeout: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """One AdamW step on ``mesh``, in place on the placed ``params`` and
    ``opt_state`` (``place_params``, ``place_opt_state``): each rank
    updates its shards, the global-norm clip taken over every rank's.
    Returns ``{"loss", "grad_norm", "lr"}``."""
    for leaf in T.leaves(params) + T.leaves(opt_state):
        if not isinstance(leaf, Placed):
            raise TypeError("sharded_train_step updates placed trees in place: pass "
                            "place_params(mesh, params) and place_opt_state(mesh, state)")
    fam, pspecs, bspecs, dp = _train_args(model, mesh, params, batch)
    ospecs = shd.map_specs(lambda s, leaf: leaf.spec, shd.opt_specs(pspecs, opt_state), opt_state)

    def body(p, o, b):
        rank = Rank(mesh, pspecs, dp, train=True, family=fam)
        loss, _, grads = _loss_and_grads(rank, fam, model.cfg, p, b, pspecs)
        gnorm = rank.global_norm(_flat_specs(pspecs), grads)
        step = o["step"]
        info = adamw.apply_updates_(p, T.unflatten(T.flatten(p)[1], grads), o, opt_cfg,
                                    gnorm=gnorm)
        step.copy_(o["step"])
        return {"loss": loss, **info}

    return spmd.shard_map(body, mesh, (pspecs, ospecs, bspecs), P(),
                          timeout=timeout)(params, opt_state, batch)


def _serve_args(model, mesh: Mesh, params: Any, cache: Any):
    fam = _family(model)
    _check_mesh(mesh)
    for leaf in T.leaves(cache):
        if not isinstance(leaf, Placed):
            raise TypeError("the sharded cache is written in place: pass "
                            "sharded.init_cache(model, mesh, batch, max_len)")
    pspecs = _specs_of(mesh, params, lambda t: shd.param_specs(t, _sizes(mesh)))
    return fam, pspecs


def _logit_spec(pspecs, dp: bool) -> P:
    table = pspecs["embed"] if "unembed" not in pspecs else pspecs["unembed"]
    vocab = _split(table, 0 if "unembed" not in pspecs else 1)
    return P(DP if dp else None, None, vocab[0] if vocab else None)


def _serve(model, mesh, params, cache, inputs: Dict[str, torch.Tensor], step, timeout,
           prefill: bool):
    """One serving call: each rank re-lays its recurrent states out (if the
    family has them), runs ``step``, advances ``pos`` and writes the
    states back; an encoder-decoder's prefill places the encoder's output
    in the cache as ``memory``: batch on 'data' as the stream, else
    replicated (the reference has no spec for it)."""
    fam, pspecs = _serve_args(model, mesh, params, cache)
    bspecs = _batch_specs(mesh, inputs)
    dp = bool(_axes_of(bspecs["tokens"][0]))
    # a key with no value (an encoder-decoder's memory before its prefill)
    # is not passed to the ranks
    given = {k: v for k, v in cache.items() if v is not None} if isinstance(cache, dict) else cache
    cspecs = T.tree_map(lambda leaf: leaf.spec, given)
    kv_spec = None if fam.kv is None else _at(cspecs, fam.kv)["k"]
    memory = [None] * mesh.size

    def body(p, b, c):
        kv = _at(c, fam.kv)
        pos = None if kv is None else kv["pos"]
        rank = Rank(mesh, pspecs, dp, kv_spec=kv_spec, pos0=0 if pos is None else int(pos[0]),
                    family=fam)
        with torch.no_grad():
            work, back = rank.states_in(c, cspecs, fam)
            logits, new = step(p, b, work, rank)
            if pos is not None:
                new_pos = _at(new, fam.kv)["pos"]
                if new_pos is not pos:
                    pos.copy_(new_pos)
            rank.states_out(back)
        if fam.memory:
            memory[spmd.current_rank()] = new["memory"]
        return logits

    fn = spmd.shard_map(body, mesh, (pspecs, bspecs, cspecs), _logit_spec(pspecs, dp),
                        timeout=timeout)
    logits = fn(params, inputs, given)
    if fam.memory and prefill:
        first = memory[0]
        b = first.shape[0] * (_size(mesh, DP) if dp else 1)
        cache["memory"] = Placed(mesh, P(DP if dp else None), memory,
                                 (b, *first.shape[1:]), first.dtype)
    return logits, cache


def sharded_prefill(model, mesh: Mesh, params: Any, batch: Dict[str, torch.Tensor], cache: Any,
                    timeout: Optional[float] = None) -> Tuple[torch.Tensor, Any]:
    """``model.prefill(params, batch, cache)`` on ``mesh``: the last
    position's logits (global) and the placed cache (``init_cache``),
    written in place (an encoder-decoder's ``memory`` placed in it)."""
    mod = _family(model).module
    return _serve(model, mesh, params, cache, batch,
                  lambda p, b, c, r: mod.prefill(p, model.cfg, b, c, dist=r), timeout,
                  prefill=True)


def sharded_decode_step(model, mesh: Mesh, params: Any, cache: Any, tokens: torch.Tensor,
                        timeout: Optional[float] = None) -> Tuple[torch.Tensor, Any]:
    """``model.decode_step(params, cache, tokens)`` on ``mesh``: tokens
    (B, 1) global; the logits (global) and the placed cache, written in
    place."""
    mod = _family(model).module
    return _serve(model, mesh, params, cache, {"tokens": tokens},
                  lambda p, b, c, r: mod.decode_step(p, model.cfg, c, b["tokens"], dist=r),
                  timeout, prefill=False)
