"""Nested containers of tensors (dicts, lists, tuples) in the JAX package's
leaf order.

``jax.tree`` flattens a dict in the order of its sorted keys, where
``torch.utils._pytree`` keeps insertion order.  The checkpoint's ``a{i}``
arrays and ``global_norm``'s order of summation follow the leaf order, so
the port flattens as ``jax.tree`` does: dict keys sorted, lists and tuples
in order, ``None`` an empty subtree, anything else a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["flatten", "flatten_with_path", "unflatten", "leaves", "tree_map", "key_path"]

_LEAF = "*"
_END = object()


def flatten_with_path(tree: Any) -> Tuple[List[Tuple[tuple, Any]], Any]:
    """``([(path, leaf), ...], treedef)``: each path is the tuple of dict
    keys and sequence indices from the root to the leaf."""
    out: List[Tuple[tuple, Any]] = []

    def walk(t, path):
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(walk(t[k], path + (k,)) for k in keys))
        if isinstance(t, (list, tuple)):
            kind = "list" if isinstance(t, list) else "tuple"
            return (kind, len(t), tuple(walk(c, path + (i,)) for i, c in enumerate(t)))
        if t is None:
            return ("none",)
        out.append((path, t))
        return _LEAF

    treedef = walk(tree, ())
    return out, treedef


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    pairs, treedef = flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def unflatten(treedef: Any, flat: List[Any]) -> Any:
    it = iter(flat)

    def build(d):
        if d == _LEAF:
            return next(it)
        kind = d[0]
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if kind == "list":
            return [build(c) for c in d[2]]
        if kind == "tuple":
            return tuple(build(c) for c in d[2])
        return None

    out = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError("unflatten: more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of ``tree``, in a tree of the same
    structure."""
    flat, treedef = flatten(tree)
    return unflatten(treedef, [fn(x) for x in flat])


def key_path(path: tuple) -> str:
    """A leaf's ``/``-joined key path, as the checkpoint's manifest names
    it (``blocks/attn/wq``, ``0/ln/scale``)."""
    return "/".join(str(k) for k in path)
