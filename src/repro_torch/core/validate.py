"""Verification that Stripe blocks satisfy Definition 2 (parallel
polyhedral blocks).

Two flavours:

* ``validate_program`` — an *exact* oracle that enumerates iteration points
  and checks conditions (1)-(3) of Def. 2 directly.  Used by tests and by
  passes on small shapes to prove a rewrite preserved parallel semantics.
* ``affine_map_injective`` — a sound *structural* sufficient condition for
  write-map injectivity on spaces too large to enumerate (mixed-radix
  stride argument), used by the pass pipeline on production shapes.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Mapping, Sequence, Tuple

from .affine import Affine
from .ir import Block, Constant, Intrinsic, Load, Program, RefDir, Special, Store


class ValidationError(Exception):
    pass


# --------------------------------------------------------------------------
# Structural scoping checks (Def. 2 condition 1)
# --------------------------------------------------------------------------
def check_scoping(block: Block, parent_bufs: Sequence[str], errors: List[str], path: str = "") -> None:
    me = f"{path}/{block.name}"
    local = set()
    for r in block.refs:
        if r.dir != RefDir.NONE and r.from_buf not in parent_bufs:
            errors.append(f"{me}: refinement '{r.into}' refers to undeclared parent buffer '{r.from_buf}'")
        local.add(r.into)
    scalars = set()
    idx_names = {i.name for i in block.idxs} | set(block.passed)
    for c in block.constraints:
        for n in c.expr.names():
            if n not in idx_names:
                errors.append(f"{me}: constraint uses unknown index '{n}' (not local, not passed)")
    for s in block.stmts:
        if isinstance(s, Load):
            if s.buf not in local:
                errors.append(f"{me}: load from undeclared buffer '{s.buf}'")
            elif not block.ref(s.buf).is_scalar_view():
                errors.append(f"{me}: load({s.buf}) requires a scalar view")
            scalars.add(s.into)
        elif isinstance(s, Store):
            if s.buf not in local:
                errors.append(f"{me}: store to undeclared buffer '{s.buf}'")
            if s.scalar not in scalars:
                errors.append(f"{me}: store of undefined scalar '${s.scalar}'")
        elif isinstance(s, Intrinsic):
            for a in s.args:
                if a not in scalars:
                    errors.append(f"{me}: intrinsic '{s.op}' uses undefined scalar '${a}'")
            scalars.add(s.into)
        elif isinstance(s, Constant):
            scalars.add(s.into)
        elif isinstance(s, Special):
            for b in (*s.ins, *s.outs):
                if b not in local:
                    errors.append(f"{me}: special '{s.op}' uses undeclared buffer '{b}'")
        elif isinstance(s, Block):
            check_scoping(s, sorted(local), errors, me)
        else:  # pragma: no cover
            errors.append(f"{me}: unknown statement {type(s)}")


# --------------------------------------------------------------------------
# Exact footprint enumeration (oracle)
# --------------------------------------------------------------------------
Access = Tuple[str, Tuple[int, ...], str, str]  # (root buffer, element, kind, agg)


_ALLOC_UID = itertools.count()


def _enter_block(block: Block, env: Mapping[str, int], bases: Mapping[str, Tuple[str, Tuple[int, ...]]]):
    new = {}
    for r in block.refs:
        if r.dir == RefDir.NONE:
            # fresh local allocation per block *invocation*: unique root so
            # iteration-local temporaries never alias across iterations
            new[r.into] = (f"!local{next(_ALLOC_UID)}:{r.into}", tuple(0 for _ in r.shape))
        else:
            root, base = bases[r.from_buf]
            off = tuple(b + o.eval(env) for b, o in zip(base, r.offsets))
            new[r.into] = (root, off)
    return new


def _leaf_accesses(block: Block, env: Dict[str, int], bases, out: List[Access], limit: List[int]) -> None:
    if limit[0] <= 0:
        raise ValidationError("enumeration limit exceeded")
    my_bases = _enter_block(block, env, bases)
    for s in block.stmts:
        if isinstance(s, Load):
            root, base = my_bases[s.buf]
            out.append((root, base, "read", ""))
        elif isinstance(s, Store):
            root, base = my_bases[s.buf]
            out.append((root, base, "write", block.ref(s.buf).agg or "assign"))
        elif isinstance(s, Special):
            for b in s.ins:
                root, base = my_bases[b]
                out.append((root, base, "read_region", ""))
            for b in s.outs:
                root, base = my_bases[b]
                out.append((root, base, "write_region", block.ref(b).agg or "assign"))
        elif isinstance(s, Block):
            for sub_env in s.poly.points(env):
                limit[0] -= 1
                _leaf_accesses(s, dict(sub_env), my_bases, out, limit)


def iteration_footprints(block: Block, parent_env: Mapping[str, int], bases, limit: int = 200000):
    """Per-iteration (reads, writes) footprints of ``block`` under a parent
    environment.  writes maps element -> agg op."""
    result = []
    budget = [limit]
    if block.poly.rect_size() > limit:
        raise ValidationError("enumeration limit exceeded")
    for env in block.poly.points(parent_env):
        budget[0] -= 1
        if budget[0] <= 0:
            raise ValidationError("enumeration limit exceeded")
        acc: List[Access] = []
        _leaf_accesses(block, dict(env), bases, acc, budget)
        reads = set()
        writes: Dict[Tuple[str, Tuple[int, ...]], str] = {}
        for root, elem, kind, agg in acc:
            if kind.startswith("read"):
                reads.add((root, elem))
            else:
                writes[(root, elem)] = agg
        result.append((dict(env), reads, writes))
    return result


def check_block_parallel(block: Block, parent_env: Mapping[str, int], bases, errors: List[str], path: str, limit: int = 200000) -> None:
    """Exact Def. 2 conditions (2) and (3) for one block, then recurse."""
    me = f"{path}/{block.name}"
    try:
        foot = iteration_footprints(block, parent_env, bases, limit)
    except ValidationError:
        # too large to enumerate: sound structural check instead — assign
        # outputs must have provably injective write maps (mixed-radix)
        ranges = block.idx_ranges()
        for r in block.refs:
            if r.dir in (RefDir.OUT, RefDir.INOUT) and (r.agg or "assign") == "assign":
                if not affine_map_injective(list(r.offsets), ranges):
                    errors.append(
                        f"{me}: cannot prove injective writes to '{r.into}' (assign, too large to enumerate)")
        return

    all_writes: Dict[Tuple[str, Tuple[int, ...]], List[int]] = {}
    for it, (_env, _reads, writes) in enumerate(foot):
        for key, agg in writes.items():
            all_writes.setdefault(key, []).append(it)

    # (2) no iteration reads an element written by a *different* iteration
    for it, (_env, reads, writes) in enumerate(foot):
        for key in reads:
            writers = all_writes.get(key, [])
            if any(w != it for w in writers):
                errors.append(f"{me}: element {key} read by iter {it} but written by other iterations {writers}")
                return  # one witness is enough

    # (3) multi-written elements must have a real aggregation (not assign)
    for it, (_env, _reads, writes) in enumerate(foot):
        for key, agg in writes.items():
            if agg == "assign" and len(all_writes[key]) > 1:
                errors.append(f"{me}: element {key} written by {len(all_writes[key])} iterations with agg=assign")
                return

    # Recurse into children for one representative parent point.
    for env in block.poly.points(parent_env):
        my_bases = _enter_block(block, env, bases)
        for s in block.stmts:
            if isinstance(s, Block):
                check_block_parallel(s, env, my_bases, errors, me, limit)
        break


def validate_program(prog: Program, limit: int = 200000) -> List[str]:
    """Returns a list of violations; empty list means the program is a valid
    nested-polyhedral-model program (exact check; small shapes only)."""
    errors: List[str] = []
    check_scoping(prog.entry, list(prog.buffers), errors)
    if errors:
        return errors
    bases = {name: (name, tuple(0 for _ in d.shape)) for name, d in prog.buffers.items()}
    for s in prog.entry.stmts:
        if isinstance(s, Block):
            check_block_parallel(s, {}, bases, errors, prog.entry.name, limit)
    return errors


# --------------------------------------------------------------------------
# Structural (sound, incomplete) injectivity for large spaces
# --------------------------------------------------------------------------
def affine_map_injective(exprs: Sequence[Affine], ranges: Mapping[str, int]) -> bool:
    """Sufficient condition that the map ``i -> (e_0(i), ..)`` is injective
    over the rectangular domain: each variable feeds exactly one output
    dim, and within each dim the (|coef|, range) pairs satisfy the
    mixed-radix condition |c_{k+1}| >= |c_k| * r_k when sorted by |coef|."""
    used: Dict[str, int] = {}
    for d, e in enumerate(exprs):
        for n in e.names():
            if ranges.get(n, 1) <= 1:
                continue
            if n in used and used[n] != d:
                return False
            used[n] = d
    for d, e in enumerate(exprs):
        pairs = sorted(
            (abs(c), ranges[n]) for n, c in e.terms if ranges.get(n, 1) > 1
        )
        span = 1
        for c, r in pairs:
            if c < span:
                return False
            span = c * r  # smallest stride that the next var must clear
    return True
