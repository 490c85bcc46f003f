"""Affine polynomials over integer index variables.

Stripe (§3.2) requires every buffer access and every iteration-space
constraint to be an affine function of index names (including parent-block
indices).  ``Affine`` is the single currency for offsets, strides applied to
indices, and constraint left-hand-sides.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Tuple, Union

IntLike = Union[int, "Affine"]


@dataclasses.dataclass(frozen=True)
class Affine:
    """``sum(coef[name] * name) + const`` with integer coefficients."""

    terms: Tuple[Tuple[str, int], ...] = ()
    const: int = 0

    # ---------------------------------------------------------------- ctor
    @staticmethod
    def make(terms: Mapping[str, int] | Iterable[Tuple[str, int]] = (), const: int = 0) -> "Affine":
        if isinstance(terms, Mapping):
            items = terms.items()
        else:
            items = terms
        merged: Dict[str, int] = {}
        for name, coef in items:
            if coef:
                merged[name] = merged.get(name, 0) + coef
        merged = {k: v for k, v in merged.items() if v}
        return Affine(tuple(sorted(merged.items())), int(const))

    @staticmethod
    def var(name: str, coef: int = 1) -> "Affine":
        return Affine.make({name: coef})

    @staticmethod
    def lift(v: IntLike) -> "Affine":
        if isinstance(v, Affine):
            return v
        return Affine((), int(v))

    # ------------------------------------------------------------- algebra
    def __add__(self, other: IntLike) -> "Affine":
        o = Affine.lift(other)
        merged = dict(self.terms)
        for name, coef in o.terms:
            merged[name] = merged.get(name, 0) + coef
        return Affine.make(merged, self.const + o.const)

    __radd__ = __add__

    def __neg__(self) -> "Affine":
        return Affine.make({n: -c for n, c in self.terms}, -self.const)

    def __sub__(self, other: IntLike) -> "Affine":
        return self + (-Affine.lift(other))

    def __rsub__(self, other: IntLike) -> "Affine":
        return Affine.lift(other) + (-self)

    def __mul__(self, k: int) -> "Affine":
        if isinstance(k, Affine):
            if k.is_const():
                k = k.const
            else:  # pragma: no cover - guarded misuse
                raise TypeError("Affine*Affine is not affine")
        return Affine.make({n: c * k for n, c in self.terms}, self.const * k)

    __rmul__ = __mul__

    # ------------------------------------------------------------- queries
    def is_const(self) -> bool:
        return not self.terms

    def coef(self, name: str) -> int:
        for n, c in self.terms:
            if n == name:
                return c
        return 0

    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.terms)

    def eval(self, env: Mapping[str, int]) -> int:
        total = self.const
        for n, c in self.terms:
            total += c * env[n]
        return total

    def partial_eval(self, env: Mapping[str, int]) -> "Affine":
        """Substitute the names present in ``env``; keep the rest symbolic."""
        terms: Dict[str, int] = {}
        const = self.const
        for n, c in self.terms:
            if n in env:
                const += c * env[n]
            else:
                terms[n] = terms.get(n, 0) + c
        return Affine.make(terms, const)

    def substitute(self, subst: Mapping[str, "Affine"]) -> "Affine":
        """Substitute names by affine expressions (used when splitting an
        index ``i -> tile*i_outer + i_inner`` during tiling)."""
        out = Affine.lift(self.const)
        for n, c in self.terms:
            repl = subst.get(n)
            out = out + (repl * c if repl is not None else Affine.make({n: c}))
        return out

    def rename(self, mapping: Mapping[str, str]) -> "Affine":
        return Affine.make({mapping.get(n, n): c for n, c in self.terms}, self.const)

    # ------------------------------------------------------------- display
    def __str__(self) -> str:
        parts = []
        for n, c in self.terms:
            if c == 1:
                parts.append(n)
            elif c == -1:
                parts.append(f"-{n}")
            else:
                parts.append(f"{c}*{n}")
        if self.const or not parts:
            parts.append(str(self.const))
        s = " + ".join(parts)
        return s.replace("+ -", "- ")

    __repr__ = __str__


def aff(v: IntLike) -> Affine:
    return Affine.lift(v)
