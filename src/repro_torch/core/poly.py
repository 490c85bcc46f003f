"""Bounded integer polyhedra (paper Definition 1, restricted as in §3.2).

Stripe encourages rectilinear iteration spaces: every index carries a
``range`` (``0 <= idx < range``) and a block may add extra affine
constraints (``expr >= 0``) for the non-rectilinear parts (halos, overflow
removal).  This module provides the small amount of polyhedral math the
passes need: point enumeration (small spaces only), membership, cardinality,
bounds propagation, and emptiness checks.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Iterator, List, Mapping, Sequence, Tuple

from .affine import Affine


@dataclasses.dataclass(frozen=True)
class Index:
    """A polyhedron dimension: ``0 <= name < range``.

    ``affine`` (when set) declares this index to be a pass-through of a
    parent-block expression instead of a free iteration variable (Stripe
    passes parent indices to children explicitly this way); such an index
    has range 1 and contributes no iteration.
    """

    name: str
    range: int
    affine: Affine | None = None

    def __post_init__(self):
        if self.affine is None and self.range < 0:
            raise ValueError(f"index {self.name} has negative range {self.range}")

    def is_passthrough(self) -> bool:
        return self.affine is not None

    def __str__(self) -> str:
        if self.affine is not None:
            return f"{self.name}={self.affine}"
        return f"{self.name}:{self.range}"


@dataclasses.dataclass(frozen=True)
class Constraint:
    """``expr >= 0`` over the block's (and its parents') index names."""

    expr: Affine

    def satisfied(self, env: Mapping[str, int]) -> bool:
        return self.expr.eval(env) >= 0

    def __str__(self) -> str:
        return f"{self.expr} >= 0"


class Polyhedron:
    """Iteration space: free indices with ranges + affine constraints."""

    def __init__(self, idxs: Sequence[Index], constraints: Sequence[Constraint] = ()):
        self.idxs = list(idxs)
        self.constraints = list(constraints)

    # ------------------------------------------------------------- helpers
    def free_idxs(self) -> List[Index]:
        return [i for i in self.idxs if not i.is_passthrough()]

    def names(self) -> List[str]:
        return [i.name for i in self.idxs]

    def rect_size(self) -> int:
        """Cardinality ignoring constraints (the bounding box)."""
        n = 1
        for i in self.free_idxs():
            n *= i.range
        return n

    # ----------------------------------------------------------- iteration
    def points(self, parent_env: Mapping[str, int] | None = None) -> Iterator[Dict[str, int]]:
        """Enumerate integer points (small spaces; oracle / tests only)."""
        parent_env = dict(parent_env or {})
        free = self.free_idxs()
        ranges = [range(i.range) for i in free]
        for combo in itertools.product(*ranges):
            env = dict(parent_env)
            env.update({i.name: v for i, v in zip(free, combo)})
            for i in self.idxs:
                if i.is_passthrough():
                    env[i.name] = i.affine.eval(env)
            if all(c.satisfied(env) for c in self.constraints):
                yield env

    def contains(self, env: Mapping[str, int]) -> bool:
        for i in self.free_idxs():
            v = env[i.name]
            if not (0 <= v < i.range):
                return False
        full = dict(env)
        for i in self.idxs:
            if i.is_passthrough():
                full[i.name] = i.affine.eval(full)
        return all(c.satisfied(full) for c in self.constraints)

    def count(self, parent_env: Mapping[str, int] | None = None) -> int:
        return sum(1 for _ in self.points(parent_env))

    # ------------------------------------------------- bounds / emptiness
    def expr_bounds(self, expr: Affine, outer_bounds: Mapping[str, Tuple[int, int]] | None = None) -> Tuple[int, int]:
        """Inclusive (lo, hi) interval bound of ``expr`` over the bounding
        box (interval arithmetic — sound, not tight w.r.t. constraints)."""
        lo = hi = expr.const
        bounds = dict(outer_bounds or {})
        for i in self.idxs:
            if not i.is_passthrough():
                bounds.setdefault(i.name, (0, i.range - 1))
        # Passthrough indices: resolve recursively via their affine defs.
        for i in self.idxs:
            if i.is_passthrough() and i.name not in bounds:
                bounds[i.name] = self.expr_bounds(i.affine, bounds)
        for n, c in expr.terms:
            if n not in bounds:
                raise KeyError(f"no bounds known for index '{n}'")
            blo, bhi = bounds[n]
            lo += min(c * blo, c * bhi)
            hi += max(c * blo, c * bhi)
        return lo, hi

    def definitely_empty(self, outer_bounds: Mapping[str, Tuple[int, int]] | None = None) -> bool:
        """True if some constraint can never be satisfied (interval test)."""
        if any(i.range == 0 for i in self.free_idxs()):
            return True
        for c in self.constraints:
            _, hi = self.expr_bounds(c.expr, outer_bounds)
            if hi < 0:
                return True
        return False

    def constraint_always_true(self, c: Constraint, outer_bounds: Mapping[str, Tuple[int, int]] | None = None) -> bool:
        lo, _ = self.expr_bounds(c.expr, outer_bounds)
        return lo >= 0

    def simplified_constraints(self, outer_bounds: Mapping[str, Tuple[int, int]] | None = None) -> List[Constraint]:
        """Drop constraints that the bounding box already implies."""
        return [c for c in self.constraints if not self.constraint_always_true(c, outer_bounds)]

    def __str__(self) -> str:
        s = ", ".join(str(i) for i in self.idxs)
        if self.constraints:
            s += " | " + ", ".join(str(c) for c in self.constraints)
        return f"[{s}]"


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def factors(n: int) -> List[int]:
    out = [d for d in range(1, int(math.isqrt(n)) + 1) if n % d == 0]
    out += [n // d for d in reversed(out) if d * d != n]
    return out
