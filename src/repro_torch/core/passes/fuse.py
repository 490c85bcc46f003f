"""Fusion groups (paper §2.3, "Scalarization and Memory Localization").

Generalizes the classic contraction+consumer rewrite into **fusion
groups over the whole program DAG**: each contraction acts as a group
*anchor* into which the pass merges

* **elementwise prologues** — an elementwise producer of a contraction
  input is inlined into the anchor's leaf, so the input is transformed
  tile-by-tile inside the kernel instead of materializing a transformed
  copy in outer memory;
* **chains of elementwise consumers** — bias/activation/scale chains
  hanging off the contraction output become the group's epilogue;
* **multi-consumer broadcasts** — a diamond where several elementwise
  consumers of the same intermediate rejoin into one result (e.g.
  ``O = relu(T) * sigmoid(T)``) is absorbed atomically when exactly one
  buffer escapes the closure.

Every candidate merge is **cost-arbitrated** (`cost.FusionDecision`):
HBM bytes saved by eliminating the intermediate (one write + one read)
against HBM bytes added by re-fetching fused inputs per revisiting grid
tile, subject to the VMEM arena pressure of a canonical tile priced with
``core/memplan``'s slot model (streamed views double-buffered to the
hardware's ``pipeline_depth``, reduction-resident views in one slot,
the output accumulator plus its f32 scratch) — the same arithmetic the
autotiler's feasibility check and the schedule-time allocator use.
Accepted and rejected merges are recorded in the pass trace
(``params["_report"]``), so a compile's fusion decisions are auditable
and persisted with the compilation cache payload.

The rewrite itself makes the group's internal tensors *block-local
scalar accumulators* (internally-scoped temporaries in Def. 2's terms):

    O[i,j] = gelu(T[i,j] + b[j]),  T[i,j] += A[i,c]*B[c,j]
      ==>
    block [i, j] {                       # fused, one iteration per output
      acc: local (1,1) :add
      block [c] { acc += A[i,c]*B[c,j] } # reduction fully inside
      $t = load(acc); $b = load(b[j]); $s = add($t,$b)
      $r = gelu($s); O = store($r)
    }

which autotiling then tiles like any other block and the Pallas backend
lowers as **one kernel**: T (and every other group-internal buffer) is
never materialized.  The fused block carries a ``members:`` tag naming
the semantic op blocks it absorbed, which the driver uses for per-group
jnp lowering and cache bookkeeping.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple, Union

from ..affine import Affine, aff
from ..cost import FusionDecision, fusion_vmem_pressure, canonical_tile, refetch_bytes
from ..hwconfig import HardwareConfig
from ..ir import (
    Block,
    Constant,
    Intrinsic,
    Load,
    Program,
    RefDir,
    Refinement,
    Store,
    dtype_bytes,
)
from ..flat import analyze_flat
from ..tiling import split_block
from . import register

MEMBERS_TAG = "members:"


def _buffer_usage(prog: Program) -> Dict[str, Dict[str, List[Block]]]:
    use: Dict[str, Dict[str, List[Block]]] = {}
    for s in prog.entry.stmts:
        if not isinstance(s, Block):
            continue
        for r in s.refs:
            d = use.setdefault(r.from_buf, {"r": [], "w": []})
            if r.dir in (RefDir.IN, RefDir.INOUT):
                d["r"].append(s)
            if r.dir in (RefDir.OUT, RefDir.INOUT):
                d["w"].append(s)
    return use


def _out_vars(block: Block) -> Optional[List[str]]:
    """Per-dim plain index variables of the block's OUT access, or None."""
    for r in block.refs:
        if r.dir == RefDir.OUT:
            return _plain_vars(r.offsets)
    return None


def _plain_vars(offsets: Sequence[Affine]) -> Optional[List[str]]:
    """Each dim a distinct bare index (coef 1, const 0), else None."""
    vs: List[str] = []
    for e in offsets:
        if len(e.terms) == 1 and e.const == 0 and e.terms[0][1] == 1:
            vs.append(e.terms[0][0])
        else:
            return None
    return vs if len(set(vs)) == len(vs) else None


def _unique_name(base: str, used: Set[str]) -> str:
    if base not in used:
        return base
    n = 2
    while f"{base}_{n}" in used:
        n += 1
    return f"{base}_{n}"


def members_of(block: Block) -> List[str]:
    """Semantic op-block names a fused block absorbed (in program order);
    a non-fused block is its own single-member group."""
    for t in block.tags:
        if t.startswith(MEMBERS_TAG):
            return t[len(MEMBERS_TAG):].split(",")
    return [block.name.split(".")[0]]


def _set_members(block: Block, names: Sequence[str]) -> None:
    block.tags = {t for t in block.tags if not t.startswith(MEMBERS_TAG)}
    block.add_tag(MEMBERS_TAG + ",".join(names))


def _buf_bytes(prog: Program, name: str) -> int:
    d = prog.buffers[name]
    return d.size() * dtype_bytes(d.dtype)


def _interleaved_writer(blocks: List[Block], lo: int, hi: int,
                        skip: Set[int], reads: Set[str]) -> Optional[str]:
    """Name of a non-member block in (lo, hi] that writes a buffer the
    group reads (a WAR hazard for moving the reads to position hi)."""
    for q in blocks[lo + 1 : hi + 1]:
        if id(q) in skip:
            continue
        writes = {r.from_buf for r in q.refs if r.dir in (RefDir.OUT, RefDir.INOUT)}
        if writes & reads:
            return q.name
    return None


# --------------------------------------------------------------------------
# Epilogue members
# --------------------------------------------------------------------------
class _Member:
    """An elementwise consumer absorbed into a group's epilogue."""

    def __init__(self, block: Block, rename: Dict[str, str], out_buf: str,
                 out_axes: Tuple[str, ...]):
        self.block = block
        self.rename = rename      # member index var -> group output var
        self.out_buf = out_buf
        self.out_axes = out_axes  # group var addressing each out dim

    def external_refs(self, internal: Set[str]) -> List[Refinement]:
        return [r for r in self.block.refs
                if r.dir == RefDir.IN and r.from_buf not in internal]


def _member_compat(c: Block, internal_axes: Dict[str, Tuple[str, ...]],
                   group_ranges: Mapping[str, int],
                   anchor_axes: Tuple[str, ...]) -> Union[_Member, str]:
    """Check that ``c`` can join the epilogue; returns a _Member or a
    human-readable rejection reason."""
    if c.constraints:
        return "member has constraints"
    try:
        cop = analyze_flat(c)
    except ValueError as e:
        return f"not a flat elementwise block ({e})"
    if cop.agg != "assign":
        return "member aggregates (not elementwise)"
    rename: Dict[str, str] = {}
    n_internal = 0
    for r in c.refs:
        if r.dir == RefDir.NONE:
            return "member has local allocations"
        if r.dir != RefDir.IN or r.from_buf not in internal_axes:
            continue
        n_internal += 1
        vs = _plain_vars(r.offsets)
        axes = internal_axes[r.from_buf]
        if vs is None or len(vs) != len(axes):
            return f"non-pointwise read of {r.from_buf}"
        for var, want in zip(vs, axes):
            if rename.get(var, want) != want:
                return f"conflicting index mapping on {var}"
            rename[var] = want
    if n_internal == 0:
        return "reads no group intermediate"
    free = c.idx_ranges()
    for v, rng in free.items():
        if v not in rename:
            return f"member index {v} not driven by the group"
        if rng != group_ranges.get(rename[v]):
            return f"range mismatch on {v}"
    ov = _out_vars(c)
    if ov is None:
        return "member output access is not a plain index tuple"
    out_ref = next(r for r in c.refs if r.dir == RefDir.OUT)
    if any(s != 1 for s in out_ref.shape):
        return "member output is not a scalar view"
    out_axes = tuple(rename[v] for v in ov)
    if out_axes != anchor_axes:
        # A permuting member would need the accumulator tile transposed
        # before the store — the Pallas emitter stores the tile interior
        # as-is, so axis permutations are rejected (the op stays unfused).
        return "member output permutes the group axes"
    return _Member(c, rename, out_ref.from_buf, out_axes)


def _collect_closure(anchor: Block, t_buf: str, t_axes: Tuple[str, ...],
                     group_ranges: Mapping[str, int], blocks: List[Block],
                     use, prog: Program, limit: int = 16
                     ) -> Tuple[List[_Member], str]:
    """Grow the elementwise closure downstream of ``t_buf``.  Returns the
    members in topological order, or ([], reason).  Legal only when
    exactly one produced buffer escapes the closure."""
    internal_axes: Dict[str, Tuple[str, ...]] = {t_buf: t_axes}
    members: List[_Member] = []
    in_closure: Set[int] = {id(anchor)}
    first_reason = ""
    candidates = {id(b): b for b in blocks
                  if id(b) != id(anchor) and any(
                      r.dir == RefDir.IN for r in b.refs)}
    progressed = True
    while progressed and len(members) < limit:
        progressed = False
        for buf in list(internal_axes):
            for c in use.get(buf, {}).get("r", []):
                if id(c) in in_closure:
                    continue
                # Defer a member whose non-internal input is produced by a
                # block still adjacent to the closure (a diamond join must
                # wait for all its arms to be absorbed, so those inputs
                # resolve to scalars instead of external refs).
                deferred = False
                for r in c.refs:
                    if r.dir != RefDir.IN or r.from_buf in internal_axes:
                        continue
                    for w in use.get(r.from_buf, {}).get("w", []):
                        if id(w) in in_closure or id(w) not in candidates:
                            continue
                        if any(q.dir == RefDir.IN and q.from_buf in internal_axes
                               for q in w.refs):
                            deferred = True
                if deferred:
                    continue
                got = _member_compat(c, internal_axes, group_ranges, t_axes)
                if isinstance(got, str):
                    first_reason = first_reason or f"{c.name}: {got}"
                    continue
                members.append(got)
                in_closure.add(id(c))
                internal_axes[got.out_buf] = got.out_axes
                progressed = True
    if not members:
        return [], first_reason or "no elementwise consumer"
    # ---- escape analysis: exactly one produced buffer may leave ----------
    escaping = []
    for buf in internal_axes:
        if buf in prog.outputs:
            escaping.append(buf)
            continue
        outside_r = [b for b in use.get(buf, {}).get("r", []) if id(b) not in in_closure]
        outside_w = [b for b in use.get(buf, {}).get("w", []) if id(b) not in in_closure]
        if outside_r or outside_w:
            escaping.append(buf)
    if len(escaping) != 1:
        return [], f"{len(escaping)} buffers escape the closure ({', '.join(sorted(escaping))})"
    final = escaping[0]
    if final == t_buf:
        return [], "the contraction output itself escapes"
    note = f"member limit {limit} reached" if len(members) >= limit else ""
    # reorder so the final producer is last (collection is already topo;
    # just rotate the final member to the end if needed)
    fi = next(i for i, m in enumerate(members) if m.out_buf == final)
    if fi != len(members) - 1:
        # the final member must not feed any *other* member
        if any(final in (r.from_buf for r in m.block.refs if r.dir == RefDir.IN)
               for i, m in enumerate(members) if i != fi):
            return [], "the escaping buffer feeds other members"
        members.append(members.pop(fi))
    return members, note


def _chain_walk(anchor: Block, t_buf: str, t_axes: Tuple[str, ...],
                group_ranges: Mapping[str, int], use, prog: Program,
                limit: int = 16) -> Tuple[List[_Member], str]:
    """Fallback: follow single-reader links only (a pure consumer chain);
    every prefix of the result is a legal group."""
    members: List[_Member] = []
    buf, axes = t_buf, t_axes
    reason = ""
    while len(members) < limit:
        if buf != t_buf and buf in prog.outputs:
            break  # the chain head escapes here; stop extending
        readers = use.get(buf, {}).get("r", [])
        if len(readers) != 1 or readers[0] is anchor:
            reason = reason or f"{buf} has {len(readers)} readers"
            break
        got = _member_compat(readers[0], {buf: axes}, group_ranges, t_axes)
        if isinstance(got, str):
            reason = f"{readers[0].name}: {got}"
            break
        if len(use.get(got.out_buf, {}).get("w", [])) != 1:
            reason = f"{got.out_buf} has multiple writers"
            break
        members.append(got)
        buf, axes = got.out_buf, got.out_axes
    if len(members) >= limit and not reason:
        reason = f"member limit {limit} reached"
    return members, reason


# --------------------------------------------------------------------------
# Prologue inlining
# --------------------------------------------------------------------------
def _producer_compat(P: Block, read_vars: List[str],
                     anchor_ranges: Mapping[str, int]) -> Union[Dict[str, str], str]:
    """Check elementwise producer P can be inlined where the anchor reads
    its output with per-dim vars ``read_vars``; returns the index rename
    (P var -> anchor var) or a reason."""
    if P.constraints:
        return "producer has constraints"
    try:
        pop = analyze_flat(P)
    except ValueError as e:
        return f"producer not flat ({e})"
    if pop.agg != "assign":
        return "producer aggregates"
    pv = _out_vars(P)
    out_ref = next(r for r in P.refs if r.dir == RefDir.OUT)
    if pv is None or len(pv) != len(read_vars) or any(s != 1 for s in out_ref.shape):
        return "producer output access is not a plain index tuple"
    free = P.idx_ranges()
    if set(free) - set(pv):
        return "producer has free reduction indices"
    rename = dict(zip(pv, read_vars))
    for v in pv:
        if free.get(v) != anchor_ranges.get(rename[v]):
            return f"range mismatch on {v}"
    return rename


def _inline_producer(c: Block, u_ref: Refinement, P: Block,
                     rename: Dict[str, str], prefix: str) -> None:
    """Splice P's statement list into anchor ``c`` in place of its load of
    P's output, renaming indices into the anchor's space."""
    used = {r.into for r in c.refs}
    smap: Dict[str, str] = {}
    new_stmts: List = []
    stored: Optional[str] = None
    for s in P.stmts:
        if isinstance(s, Load):
            ref = P.ref(s.buf)
            into = _unique_name(ref.from_buf, used)
            used.add(into)
            c.refs.append(ref.clone(
                offsets=tuple(o.rename(rename) for o in ref.offsets), into=into))
            smap[s.into] = prefix + s.into
            new_stmts.append(Load(into, prefix + s.into))
        elif isinstance(s, Constant):
            smap[s.into] = prefix + s.into
            new_stmts.append(Constant(s.value, prefix + s.into))
        elif isinstance(s, Intrinsic):
            smap[s.into] = prefix + s.into
            new_stmts.append(Intrinsic(s.op, tuple(smap[a] for a in s.args),
                                       prefix + s.into))
        elif isinstance(s, Store):
            stored = smap[s.scalar]
    assert stored is not None
    # replace the anchor's load of the intermediate with P's body
    out: List = []
    alias: Dict[str, str] = {}
    for s in c.stmts:
        if isinstance(s, Load) and s.buf == u_ref.into:
            out.extend(new_stmts)
            alias[s.into] = stored
        elif isinstance(s, Intrinsic):
            out.append(Intrinsic(s.op, tuple(alias.get(a, a) for a in s.args), s.into))
        elif isinstance(s, Store):
            out.append(Store(s.buf, alias.get(s.scalar, s.scalar)))
        else:
            out.append(s)
    c.stmts = out
    c.refs = [r for r in c.refs if r is not u_ref]


def _inline_prologues(prog: Program, hw: HardwareConfig, params: Mapping,
                      decisions: List[FusionDecision], seen: Set[Tuple]) -> None:
    changed = True
    while changed:
        changed = False
        blocks = [s for s in prog.entry.stmts if isinstance(s, Block)]
        use = _buffer_usage(prog)
        for c in blocks:
            try:
                cop = analyze_flat(c)
            except ValueError:
                continue
            if cop.agg == "assign":
                continue
            anchor_ranges = c.idx_ranges()
            out_vars = _out_vars(c)
            if out_vars is None:
                continue
            for r in list(c.refs):
                if r.dir != RefDir.IN:
                    continue
                ubuf = r.from_buf
                if ubuf in prog.inputs or ubuf in prog.outputs:
                    continue
                uu = use.get(ubuf, {"r": [], "w": []})
                if len(uu["w"]) != 1 or uu["w"][0] is c or uu["r"] != [c]:
                    continue
                P = uu["w"][0]
                if sum(1 for q in c.refs if q.from_buf == ubuf) != 1:
                    continue
                key = (c.name, P.name, "prologue")
                if key in seen:
                    continue
                vs = _plain_vars(r.offsets)
                if vs is None:
                    continue
                rename = _producer_compat(P, vs, anchor_ranges)
                if isinstance(rename, str):
                    continue  # legality, not cost: no decision recorded
                hazard = _interleaved_writer(
                    blocks, blocks.index(P), blocks.index(c), {id(P), id(c)},
                    {q.from_buf for q in P.refs if q.dir == RefDir.IN})
                if hazard:
                    continue
                # ---- cost arbitration -------------------------------------
                seen.add(key)
                saved = 2 * _buf_bytes(prog, ubuf)
                tile = canonical_tile(anchor_ranges, params, set(out_vars))
                added = 0
                p_in_refs = [q.clone(offsets=tuple(o.rename(rename) for o in q.offsets))
                             for q in P.refs if q.dir == RefDir.IN]
                for q in p_in_refs:
                    q_vars = {n for e in q.offsets for n in e.names()}
                    added += refetch_bytes(q_vars, anchor_ranges, out_vars, tile,
                                           _buf_bytes(prog, q.from_buf))
                trial = [q for q in c.refs if q.dir != RefDir.NONE and q is not r] + p_in_refs
                vmem, cap, fits = fusion_vmem_pressure(
                    trial, anchor_ranges, hw, params, set(out_vars))
                ok = fits and saved >= added
                why = "" if ok else (
                    f"arena {vmem}B > cap {cap}B" if not fits
                    else f"refetch {added}B > saved {saved}B")
                decisions.append(FusionDecision(
                    group=c.name, member=P.name, kind="prologue", accepted=ok,
                    hbm_saved=saved, hbm_added=added, vmem_bytes=vmem,
                    vmem_cap=cap, reason=why))
                if not ok:
                    continue
                _inline_producer(c, r, P, rename, f"p{len(members_of(c))}_")
                _set_members(c, [P.name.split(".")[0]] + members_of(c))
                c.add_tag("fused_prologue")
                prog.entry.stmts.remove(P)
                changed = True
                break
            if changed:
                break


# --------------------------------------------------------------------------
# Group materialization
# --------------------------------------------------------------------------
def _materialize_group(anchor: Block, members: List[_Member],
                       prog: Program) -> Optional[Block]:
    pop = analyze_flat(anchor)
    pv = _out_vars(anchor)
    t_buf = pop.out_ref.from_buf
    f = split_block(anchor, {v: 1 for v in pv}, name_suffix="f")
    base = members_of(anchor)
    names = [m.block.name.split(".")[0] for m in members]
    f.name = "+".join([anchor.name] + names)
    # partition annotations ride along so the mesh split decision stays
    # visible on the fused block
    f.tags = {"contraction", "fused"} | {
        t for m in [anchor] + [m.block for m in members]
        for t in m.tags if t == "partitioned" or t.startswith("partition:")}
    _set_members(f, base + names)

    acc_name = None
    for i, r in enumerate(f.refs):
        if r.from_buf == t_buf and r.dir in (RefDir.OUT, RefDir.INOUT):
            f.refs[i] = Refinement(
                dir=RefDir.NONE, from_buf=r.into, into=r.into,
                offsets=(aff(0),) * r.rank, shape=(1,) * r.rank,
                dtype=r.dtype, agg=pop.agg,
            )
            acc_name = r.into
            break
    if acc_name is None:
        return None

    used = {r.into for r in f.refs}
    acc_scalar = "acc0"
    stmts: List = [Load(acc_name, acc_scalar)]
    scalar_of: Dict[str, str] = {t_buf: acc_scalar}
    ext_into: Dict[Tuple, str] = {}
    for mi, m in enumerate(members):
        pref = f"e{mi}_"
        last = mi == len(members) - 1
        smap: Dict[str, str] = {}
        for s in m.block.stmts:
            if isinstance(s, Load):
                ref = m.block.ref(s.buf)
                if ref.from_buf in scalar_of:
                    smap[s.into] = scalar_of[ref.from_buf]
                    continue
                offs = tuple(o.rename(m.rename) for o in ref.offsets)
                key = (ref.from_buf, tuple(str(o) for o in offs))
                into = ext_into.get(key)
                if into is None:
                    into = _unique_name(ref.from_buf, used)
                    used.add(into)
                    f.refs.append(ref.clone(offsets=offs, into=into))
                    ext_into[key] = into
                smap[s.into] = pref + s.into
                stmts.append(Load(into, pref + s.into))
            elif isinstance(s, Constant):
                smap[s.into] = pref + s.into
                stmts.append(Constant(s.value, pref + s.into))
            elif isinstance(s, Intrinsic):
                smap[s.into] = pref + s.into
                stmts.append(Intrinsic(s.op, tuple(smap[a] for a in s.args),
                                       pref + s.into))
            elif isinstance(s, Store):
                out_ref = m.block.ref(s.buf)
                if last:
                    into = _unique_name(out_ref.from_buf + "_out", used)
                    used.add(into)
                    f.refs.append(out_ref.clone(
                        offsets=tuple(o.rename(m.rename) for o in out_ref.offsets),
                        into=into))
                    stmts.append(Store(into, smap[s.scalar]))
                else:
                    scalar_of[out_ref.from_buf] = smap[s.scalar]
            else:
                return None
    f.stmts.extend(stmts)
    return f


# --------------------------------------------------------------------------
# Group formation
# --------------------------------------------------------------------------
def _form_groups(prog: Program, hw: HardwareConfig, params: Mapping,
                 decisions: List[FusionDecision], seen: Set[Tuple]) -> None:
    changed = True
    while changed:
        changed = False
        blocks = [s for s in prog.entry.stmts if isinstance(s, Block)]
        use = _buffer_usage(prog)
        for p in blocks:
            if "fused" in p.tags:
                continue
            try:
                pop = analyze_flat(p)
            except ValueError:
                continue
            if pop.agg == "assign":
                continue
            t_buf = pop.out_ref.from_buf
            if t_buf in prog.outputs or t_buf in prog.inputs:
                continue
            pv = _out_vars(p)
            if pv is None:
                continue
            u = use.get(t_buf, {"r": [], "w": []})
            if u["w"] != [p] or not u["r"]:
                continue
            ranges = p.idx_ranges()
            axes = tuple(pv)
            limit = int(params.get("member_limit", 16))
            members, why = _collect_closure(p, t_buf, axes, ranges, blocks, use,
                                            prog, limit=limit)
            chain = bool(members) and all(
                len(use.get(b_, {}).get("r", [])) == 1
                for b_ in [t_buf] + [m.out_buf for m in members[:-1]])
            if not members:
                members, why2 = _chain_walk(p, t_buf, axes, ranges, use, prog,
                                            limit=limit)
                chain = True
                why = why2
                if not members:
                    key = (p.name, "", "closure")
                    if key not in seen:
                        seen.add(key)
                        decisions.append(FusionDecision(
                            group=p.name, member="", kind="epilogue",
                            accepted=False, reason=why2))
                    continue
            if members and "member limit" in why:
                # truncated growth is auditable too: record why the tail
                # of the consumer chain stays unfused
                key = (p.name, "", "limit")
                if key not in seen:
                    seen.add(key)
                    decisions.append(FusionDecision(
                        group=p.name, member="", kind="epilogue",
                        accepted=False, reason=why))

            accepted = _arbitrate(p, members, chain, ranges, pv, t_buf, prog,
                                  hw, params, decisions, seen)
            if not accepted:
                continue
            group_reads = {r.from_buf for r in p.refs if r.dir == RefDir.IN}
            internal = {t_buf} | {m.out_buf for m in accepted[:-1]}
            for m in accepted:
                group_reads |= {r.from_buf for r in m.external_refs(internal)}
            anchor_idx = blocks.index(p)
            place_idx = max([anchor_idx] + [blocks.index(m.block) for m in accepted])
            skip = {id(p)} | {id(m.block) for m in accepted}
            hazard = _interleaved_writer(blocks, anchor_idx, place_idx, skip, group_reads)
            if hazard:
                key = (p.name, hazard, "hazard")
                if key not in seen:
                    seen.add(key)
                    decisions.append(FusionDecision(
                        group=p.name, member=",".join(m.block.name for m in accepted),
                        kind="epilogue", accepted=False,
                        reason=f"interleaved writer {hazard} between anchor and members"))
                continue
            fused = _materialize_group(p, accepted, prog)
            if fused is None:
                continue
            # place the group where its last member ran; drop the rest
            new_stmts: List = []
            for s in prog.entry.stmts:
                if isinstance(s, Block) and id(s) in skip:
                    if s is blocks[place_idx]:
                        new_stmts.append(fused)
                    continue
                new_stmts.append(s)
            prog.entry.stmts = new_stmts
            changed = True
            break


def _arbitrate(p: Block, members: List[_Member], chain: bool,
               ranges: Mapping[str, int], out_vars: List[str], t_buf: str,
               prog: Program, hw: HardwareConfig, params: Mapping,
               decisions: List[FusionDecision], seen: Set[Tuple]) -> List[_Member]:
    """Cost-arbitrate the candidate members.  Chains accept the longest
    profitable prefix (one decision per member); diamonds are atomic."""
    tile = canonical_tile(ranges, params, set(out_vars))
    base_refs = [r for r in p.refs if r.dir in (RefDir.IN, RefDir.OUT, RefDir.INOUT)]
    internal = {t_buf} | {m.out_buf for m in members}

    def ext_refs(m: _Member) -> List[Refinement]:
        return [r.clone(offsets=tuple(o.rename(m.rename) for o in r.offsets))
                for r in m.external_refs(internal)]

    def added_for(refs: List[Refinement]) -> int:
        total = 0
        for q in refs:
            q_vars = {n for e in q.offsets for n in e.names()}
            total += refetch_bytes(q_vars, ranges, out_vars, tile,
                                   _buf_bytes(prog, q.from_buf))
        return total

    if not chain:
        all_ext: List[Refinement] = []
        for m in members:
            all_ext.extend(ext_refs(m))
        saved = 2 * sum(_buf_bytes(prog, b) for b in
                        [t_buf] + [m.out_buf for m in members[:-1]])
        added = added_for(all_ext)
        vmem, cap, fits = fusion_vmem_pressure(
            base_refs + all_ext, ranges, hw, params, set(out_vars))
        ok = fits and saved >= added
        why = "" if ok else (f"arena {vmem}B > cap {cap}B" if not fits
                             else f"refetch {added}B > saved {saved}B")
        key = (p.name, ",".join(m.block.name for m in members), "epilogue")
        if key not in seen:
            seen.add(key)
            decisions.append(FusionDecision(
                group=p.name, member=",".join(m.block.name for m in members),
                kind="epilogue", accepted=ok, hbm_saved=saved, hbm_added=added,
                vmem_bytes=vmem, vmem_cap=cap, reason=why))
        return members if ok else []

    accepted: List[_Member] = []
    cur_refs = list(base_refs)
    consumed = t_buf
    for m in members:
        refs_m = ext_refs(m)
        saved = 2 * _buf_bytes(prog, consumed)
        added = added_for(refs_m)
        vmem, cap, fits = fusion_vmem_pressure(
            cur_refs + refs_m, ranges, hw, params, set(out_vars))
        ok = fits and saved >= added
        why = "" if ok else (f"arena {vmem}B > cap {cap}B" if not fits
                             else f"refetch {added}B > saved {saved}B")
        key = (p.name, m.block.name, "epilogue")
        if key not in seen:
            seen.add(key)
            decisions.append(FusionDecision(
                group=p.name, member=m.block.name, kind="epilogue", accepted=ok,
                hbm_saved=saved, hbm_added=added, vmem_bytes=vmem, vmem_cap=cap,
                reason=why))
        if not ok:
            break
        accepted.append(m)
        cur_refs.extend(refs_m)
        consumed = m.out_buf
    return accepted


@register("fuse")
def fuse_pass(prog: Program, hw: HardwareConfig, params: Mapping) -> Program:
    decisions: List[FusionDecision] = []
    seen: Set[Tuple] = set()
    # Grouping preference is a hardware parameterization:
    # * "epilogue" (default) absorbs consumer chains into their producer —
    #   never recomputes, the right choice when the backend applies the
    #   epilogue on the accumulator tile (Pallas/TPU);
    # * "prologue" inlines elementwise producers into the *next*
    #   contraction first — elementwise work feeds the dot instead of
    #   trailing it, which keeps XLA:CPU's gemm + transcendental loops on
    #   their parallel library paths (a dot-terminated executable).
    if params.get("prefer", "epilogue") == "prologue":
        _inline_prologues(prog, hw, params, decisions, seen)
        _form_groups(prog, hw, params, decisions, seen)
    else:
        _form_groups(prog, hw, params, decisions, seen)
        _inline_prologues(prog, hw, params, decisions, seen)
    report = params.get("_report")
    if report is not None:
        report.extend(d.to_json() for d in decisions)
    return prog
