"""Exact reference interpreter for Stripe programs (numpy, scalar loops).

This is the semantic ground truth for the Nested Polyhedral Model: it
executes arbitrary nested blocks point-by-point, honouring refinement
offsets, constraints, and aggregation operations.  It is intentionally
simple and slow — passes prove semantic preservation against it on small
shapes, and kernels/jnp lowerings are tested against it.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np

from .ir import (
    AGG_IDENTITY,
    Block,
    Constant,
    Intrinsic,
    Load,
    Program,
    RefDir,
    Special,
    Store,
)

_UNARY = {
    "neg": lambda a: -a,
    "exp": math.exp,
    "log": math.log,
    "tanh": math.tanh,
    "sqrt": math.sqrt,
    "rsqrt": lambda a: 1.0 / math.sqrt(a),
    "sigmoid": lambda a: 1.0 / (1.0 + math.exp(-a)),
    "relu": lambda a: a if a > 0 else 0 * a,
    "abs": abs,
    "square": lambda a: a * a,
    "erf": math.erf,
    "gelu": lambda a: 0.5 * a * (1.0 + math.erf(a / math.sqrt(2.0))),
    "silu": lambda a: a / (1.0 + math.exp(-a)),
    "sign": lambda a: (a > 0) - (a < 0),
    "floor": math.floor,
    "cast": lambda a: a,
}
_BINARY = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "max": max,
    "min": min,
    "pow": lambda a, b: a ** b,
}

_AGG_FN = {
    "add": lambda old, new: old + new,
    "max": max,
    "min": min,
    "mul": lambda old, new: old * new,
    "assign": lambda old, new: new,
}


def _eval_intrinsic(op: str, args):
    if len(args) == 1 and op in _UNARY:
        return _UNARY[op](args[0])
    if len(args) == 2 and op in _BINARY:
        return _BINARY[op](args[0], args[1])
    if op in ("add", "mul", "max", "min"):  # n-ary fold
        out = args[0]
        for a in args[1:]:
            out = _BINARY[op](out, a)
        return out
    raise KeyError(f"unknown intrinsic {op}/{len(args)}")


class _View:
    __slots__ = ("array", "base")

    def __init__(self, array: np.ndarray, base: Tuple[int, ...]):
        self.array = array
        self.base = base


def _run_block(block: Block, env: Dict[str, int], views: Mapping[str, _View]) -> None:
    my: Dict[str, _View] = {}
    for r in block.refs:
        if r.dir == RefDir.NONE:
            ident = AGG_IDENTITY.get(r.agg or "assign", 0.0)
            arr = np.full(r.shape, ident, dtype=np.dtype(r.dtype) if "int" not in r.dtype else np.dtype(r.dtype))
            if "int" in r.dtype:
                arr = np.zeros(r.shape, dtype=np.dtype(r.dtype))
            my[r.into] = _View(arr, tuple(0 for _ in r.shape))
        else:
            pv = views[r.from_buf]
            base = tuple(b + o.eval(env) for b, o in zip(pv.base, r.offsets))
            my[r.into] = _View(pv.array, base)

    scalars: Dict[str, object] = {}
    for s in block.stmts:
        if isinstance(s, Load):
            v = my[s.buf]
            scalars[s.into] = v.array[v.base]
        elif isinstance(s, Constant):
            scalars[s.into] = s.value
        elif isinstance(s, Intrinsic):
            scalars[s.into] = _eval_intrinsic(s.op, [scalars[a] for a in s.args])
        elif isinstance(s, Store):
            v = my[s.buf]
            agg = block.ref(s.buf).agg or "assign"
            old = v.array[v.base]
            v.array[v.base] = _AGG_FN[agg](old, scalars[s.scalar])
        elif isinstance(s, Special):
            raise NotImplementedError(f"special '{s.op}' in reference interpreter")
        elif isinstance(s, Block):
            for sub_env in s.poly.points(env):
                _run_block(s, dict(sub_env), my)
        else:  # pragma: no cover
            raise TypeError(type(s))


def execute_reference(prog: Program, inputs: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Run a Stripe program; returns all non-input buffers."""
    arrays: Dict[str, np.ndarray] = {}
    for name, d in prog.buffers.items():
        if name in prog.inputs:
            a = np.asarray(inputs[name], dtype=np.dtype(d.dtype))
            if tuple(a.shape) != d.shape:
                raise ValueError(f"input {name}: expected {d.shape}, got {a.shape}")
            arrays[name] = a.copy()
        else:
            # Identity of the first aggregation that writes this buffer.
            agg = _first_agg(prog.entry, name) or "assign"
            ident = AGG_IDENTITY.get(agg, 0.0)
            if np.dtype(d.dtype).kind in "iu" or agg == "assign":
                arrays[name] = np.zeros(d.shape, dtype=np.dtype(d.dtype))
            else:
                arrays[name] = np.full(d.shape, ident, dtype=np.dtype(d.dtype))

    views = {name: _View(arr, tuple(0 for _ in arr.shape)) for name, arr in arrays.items()}
    for env in prog.entry.poly.points({}):
        _run_block(prog.entry, dict(env), views)
    return {n: a for n, a in arrays.items() if n not in prog.inputs}


def _first_agg(block: Block, root: str, current: str | None = None) -> str | None:
    current = current or root
    for s in block.stmts:
        if isinstance(s, Store) and s.buf == current:
            return block.ref(s.buf).agg or "assign"
        if isinstance(s, Block):
            for r in s.refs:
                if r.from_buf == current:
                    got = _first_agg(s, root, r.into)
                    if got:
                        return got
                    if r.agg:
                        return r.agg
    return None
