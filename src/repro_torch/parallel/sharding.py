"""Sharding rules: tree-path-based partition specs for params, optimizer
state, batches and caches, the twin of the JAX package's
``parallel/sharding.py``.  The rules are a copy (spec for spec equal to
the reference's); they are written over the port's :class:`~.spmd.P` and
``repro_torch.tree``.

Strategy (the reference's, for GSPMD):

* 2-D weights follow Megatron: column-parallel in-projections shard their
  output dim on 'model', row-parallel out-projections their input dim;
  the embedding shards vocab on 'model';
* MoE expert-stacked weights shard experts on 'model' (EP) and their
  second dim on 'data';
* the multi-pod 'pod' axis is pure data parallelism;
* batches shard batch on ('pod', 'data'); decode caches shard batch on
  'data' when batch >= |data|, otherwise the *sequence* dimension
  (sequence-parallel decode).

Where the reference builds ``NamedSharding``\\ s for ``jax.device_put``,
the port has :class:`Sharding` (a mesh and a spec) and :func:`place`,
which cuts each leaf into per-rank shards once, on each rank's device
(:class:`~.spmd.Placed`); ``shard_map`` then hands each rank its shard as
it is.  :func:`assemble` gives the global values back.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import tree as T
from . import spmd
from .spmd import Mesh, P, Placed

__all__ = ["DEFAULT_AXES", "param_spec", "param_specs", "opt_specs", "batch_specs",
           "cache_specs", "Sharding", "make_sharding", "place", "assemble", "map_specs"]


# last-dim-rule tables: rule applies to the trailing ndims of the leaf
_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "up_proj", "in_proj", "w_gates"}
_ROW_PARALLEL = {"wo", "w_down", "down_proj", "out_proj"}


def _ndim(leaf) -> int:
    return len(leaf.shape)


def _rule_for(path: Tuple[str, ...], leaf) -> Tuple[Optional[str], ...]:
    name = path[-1] if path else ""
    parent = path[-2] if len(path) >= 2 else ""
    nd = _ndim(leaf)

    if name in ("embed",):
        # vocab over model, d replicated (the reference's choice: sharding d
        # over 'data' too makes GSPMD all-reduce the vocab-sharded logits)
        return ("model", None)
    if name in ("unembed",):
        return (None, "model")
    if parent == "moe" or (name in ("w_gate", "w_up", "w_down") and nd - _stack_dims(path, leaf) == 3):
        # expert-stacked (E, D, F): EP over model
        if name in ("w_gate", "w_up", "w_down"):
            return ("model", "data", None)
        if name == "router":
            return (None, None)
    if name in _COL_PARALLEL:
        # pure Megatron TP (the contraction dim stays whole)
        return (None, "model")
    if name in _ROW_PARALLEL:
        return ("model", None)
    if name in ("patch_proj", "frame_proj"):
        return (None, "model")
    if name == "r_gates":
        return (None, None, "model")
    if name == "conv_w":
        return (None, "model")
    return None  # replicate


def _stack_dims(path: Tuple[str, ...], leaf) -> int:
    """Leading stacked-layer dims (the layer stack adds 1; zamba's mamba
    adds 2).  Heuristic: params under 'blocks'/'encoder'/'decoder' have 1,
    under 'mamba' have 2."""
    for key in path:
        if key in ("blocks", "encoder", "decoder"):
            return 1
        if key == "mamba":
            return 2
    return 0


DEFAULT_AXES = {"pod": 2, "data": 16, "model": 16}


def _axis_len(axis, sizes) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(axis, 1)


def _guard(spec_dims, shape, sizes):
    """Drop any axis whose length does not divide the dim (the reference's
    ``jit`` requires exact divisibility for in_shardings)."""
    out = []
    for d, axis in enumerate(spec_dims):
        if axis is not None and shape[d] % _axis_len(axis, sizes) != 0:
            axis = None
        out.append(axis)
    return tuple(out)


def param_spec(path: Tuple[str, ...], leaf, sizes=None) -> P:
    sizes = sizes or DEFAULT_AXES
    rule = _rule_for(path, leaf)
    nd = _ndim(leaf)
    if rule is None:
        return P()
    rule = tuple(rule)
    base = max(nd - len(rule), 0)
    full = (None,) * base + rule[: nd - base] if len(rule) <= nd else (None,) * nd
    return P(*_guard(full, leaf.shape, sizes))


def _path_names(path: tuple) -> Tuple[str, ...]:
    return tuple(str(k) for k in path)


def _map_with_path(fn, tree: Any) -> Any:
    pairs, treedef = T.flatten_with_path(tree)
    return T.unflatten(treedef, [fn(_path_names(path), leaf) for path, leaf in pairs])


def param_specs(params: Any, sizes=None) -> Any:
    return _map_with_path(lambda path, leaf: param_spec(path, leaf, sizes), params)


def opt_specs(params_specs: Any, opt_state_shape: Any) -> Any:
    """m/v mirror the param specs; step is replicated."""
    return {
        "m": params_specs,
        "v": params_specs,
        "step": P(),
    }


def batch_specs(batch: Any, dp_axes=("pod", "data"), sizes=None) -> Any:
    sizes = sizes or DEFAULT_AXES

    def spec(leaf):
        nd = _ndim(leaf)
        dims = _guard((dp_axes,) + (None,) * (nd - 1), leaf.shape, sizes)
        return P(*dims)
    return T.tree_map(spec, batch)


def cache_specs(cache: Any, batch_size: int, dp_size: int, dp_axes=("data",), sizes=None) -> Any:
    """Decode-state sharding, key-aware:

    * KV caches ('k'/'v': (..., B, S, KV, hd)): B shards on data when
      divisible, otherwise (long-context, B=1) the *sequence* dim shards
      on data (sequence-parallel decode); then, flash-decode style, the
      cached positions shard over 'model' where they are not on data,
      else the KV heads, else the head dim.
    * SSM/conv/sLSTM states: batch on data, head/channel dim on 'model'.
    """
    sizes = sizes or DEFAULT_AXES
    batch_ok = batch_size >= dp_size and batch_size % dp_size == 0
    tp = sizes.get("model", 1)

    def spec_for(path, leaf):
        shape = leaf.shape
        nd = len(shape)
        if nd == 0:
            return P()
        name = path[-1] if path else ""
        out = [None] * nd
        if name in ("k", "v") and nd >= 4:
            b_d, s_d, kv_d, hd_d = nd - 4, nd - 3, nd - 2, nd - 1
            if batch_ok:
                out[b_d] = dp_axes
            elif shape[s_d] % dp_size == 0:
                out[s_d] = dp_axes  # sequence-parallel long-context decode
            # flash-decode style: shard cached positions over 'model'
            if out[s_d] is None and shape[s_d] % tp == 0:
                out[s_d] = "model"
            elif shape[kv_d] % tp == 0:
                out[kv_d] = "model"
            elif shape[hd_d] % tp == 0:
                out[hd_d] = "model"
            return P(*_guard(tuple(out), shape, sizes))
        if name == "pos":
            return P()
        # generic state (conv: (...,B,W,C); ssd C/n: (...,B,nh,...); slstm)
        placed_dp = False
        for d, s in enumerate(shape):
            if not placed_dp and s == batch_size and batch_ok:
                out[d] = dp_axes
                placed_dp = True
                break
        for d in range(nd - 1, -1, -1):
            if out[d] is None and d != 0 and shape[d] % tp == 0 and shape[d] >= tp:
                out[d] = "model"
                break
        return P(*_guard(tuple(out), shape, sizes))

    return _map_with_path(spec_for, cache)


# --------------------------------------------------------------------------
# placement: the port's twin of NamedSharding + jax.device_put
# --------------------------------------------------------------------------
class Sharding:
    """A mesh and a spec: where each block of a value lives.  Axis names
    the mesh lacks are dropped from the spec (the rules count them as
    size 1), so one spec tree places onto ``(2, 4)``, ``(1, 4)`` or
    ``(8,)`` meshes alike."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*(_on_mesh(e, mesh) for e in spec))

    def __repr__(self) -> str:
        return f"Sharding({self.mesh!r}, {self.spec!r})"


def _on_mesh(entry, mesh: Mesh):
    if entry is None:
        return None
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    kept = tuple(a for a in axes if a in mesh.shape)
    if not kept:
        return None
    if isinstance(entry, str):
        return kept[0]
    return kept


def map_specs(fn, specs: Any, *trees: Any) -> Any:
    """``fn(spec_leaf, *leaves)`` over a tree whose leaves are ``P``\\ s or
    :class:`Sharding`\\ s (a ``P`` is a tuple, which ``repro_torch.tree``
    would walk into), with the matching leaves of ``trees``."""
    if isinstance(specs, (P, Sharding)):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        # in sorted key order, as ``repro_torch.tree`` flattens
        return {k: map_specs(fn, specs[k], *(t[k] for t in trees)) for k in sorted(specs)}
    if isinstance(specs, (list, tuple)):
        return type(specs)(map_specs(fn, s, *(t[i] for t in trees))
                           for i, s in enumerate(specs))
    if specs is None:
        return None
    raise TypeError(f"map_specs: a spec tree holds P or Sharding leaves, not "
                    f"{type(specs).__name__}")


def make_sharding(mesh: Mesh, tree_specs: Any) -> Any:
    return map_specs(lambda s: Sharding(mesh, s), tree_specs)


def _tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, Placed):
        return _assemble_leaf(leaf)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.from_numpy(np.asarray(leaf))


def place(tree: Any, shardings: Any) -> Any:
    """Cut every leaf of ``tree`` (tensors, numpy arrays or placed values)
    into one shard a rank of its :class:`Sharding`, each copied onto its
    rank's device: a tree of :class:`~.spmd.Placed` (a placed leaf is
    assembled first, so a value moves from one mesh onto another)."""
    def one(sh: Sharding, leaf):
        if not isinstance(sh, Sharding):
            raise TypeError(f"place: a tree of Sharding (make_sharding), not {sh!r}")
        if leaf is None:
            return None
        t = _tensor(leaf)
        devices = sh.mesh.flat_devices()
        shards = [spmd.block_of(sh.mesh, r, t, sh.spec).to(devices[r], copy=True)
                  for r in range(sh.mesh.size)]
        return Placed(sh.mesh, sh.spec, shards, t.shape, t.dtype)

    return map_specs(one, shardings, tree)


def _assemble_leaf(leaf: Placed) -> torch.Tensor:
    return spmd._assemble(leaf.mesh, leaf.shards, leaf.spec)


def assemble(tree: Any) -> Any:
    """The global value of every placed leaf (on its mesh's first device; a
    replicated leaf may share rank 0's storage); other leaves as they
    are."""
    return T.tree_map(lambda leaf: _assemble_leaf(leaf) if isinstance(leaf, Placed) else leaf,
                      tree)
