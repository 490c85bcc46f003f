"""Shard planning: how a Stripe program runs on a device mesh (a copy of
the JAX package's ``core/shardplan.py``: pure Python, no framework).

The paper claims the nested polyhedral model "naturally models …
multiple compute units"; this module is that claim at the machine level.
Given a *semantic* program (the frontend's flat op blocks, before any
single-device restructuring), :func:`plan_program` picks one split
index per block and derives everything the multi-device lowering needs:

* a :class:`BufView` per buffer per era — sharded at one dim (possibly
  with halo margins) or replicated;
* the explicit collectives (``psum`` / ``all_gather`` / halo
  ``ppermute`` pairs / ring-overlapped matmul) that keep the sharded
  execution bit-equivalent to the single-device one, each priced with
  the interconnect model in :mod:`repro_torch.core.cost`;
* an ordered emission script (``plan.steps``) of shard-local compute
  *segments* interleaved with those collectives — ``mesh_lower`` plays
  it inside ``parallel.spmd.shard_map``, compiling each segment with the
  ordinary single-device ``stripe_jit`` pipeline (hybrid cuda/torch
  composer and all);
* local per-segment :class:`~repro_torch.core.ir.Program`\\ s with every
  buffer resized to its shard-local shape, halo accesses shifted into
  the padded coordinate frame, and the frontend's boundary constraints
  dropped where zero-filled halo margins implement them for free.

Split selection is cost-arbitrated, not positional: every index of a
splittable block whose range divides the mesh size seeds a candidate
plan, the split is propagated forward through use-def chains (readers
of a sharded buffer vote with the index that carries the sharded dim),
and the plan with the lowest ``compute/n + exposed communication``
wins.  Three split kinds emerge:

* **output split** — the classic data-parallel case; downstream
  elementwise ops follow the sharded dim and only program outputs are
  gathered;
* **reduction split** — each shard computes a full-shape partial and a
  ``psum`` combines them; when the block is an exact matmul the plan
  may instead choose the **ring overlap**
  (``parallel.collective_matmul``'s reduce-scatter interleave), hiding
  the collective behind the shard-local compute when the cost model
  says the hiding exceeds the per-step ring overhead;
* **halo split** — a spatial dim of a stencil/conv is split and the
  margins exchanged with ``ppermute`` pairs.  Edge devices receive
  zeros (ppermute's fill), which is exactly the masking the frontend's
  boundary constraints encode — legal only for add-aggregated product
  blocks, which the planner checks.

Programs with no divisible index (or with access patterns outside the
supported forms) raise :class:`UnsupportedMesh`; the driver falls back
to the single-device path and records why.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .affine import Affine, aff
from .cost import RING_STEP_OVERHEAD_S, collective_seconds, link_bandwidth
from .hwconfig import HardwareConfig
from .ir import (
    Block,
    Program,
    RefDir,
    Refinement,
    TensorDecl,
    dtype_bytes,
    row_major_strides,
)


class UnsupportedMesh(Exception):
    """No shard plan exists for this program on this mesh — the caller
    should compile single-device and record the reason."""


@dataclasses.dataclass(frozen=True)
class BufView:
    """One buffer's layout during one era of the shard body: sharded at
    ``dim`` with ``lo``/``hi`` halo margins of padding, or replicated
    (``dim == -1``)."""

    dim: int = -1
    lo: int = 0
    hi: int = 0

    @property
    def sharded(self) -> bool:
        return self.dim >= 0

    def local_shape(self, shape: Sequence[int], n: int) -> Tuple[int, ...]:
        if not self.sharded:
            return tuple(shape)
        s = list(shape)
        s[self.dim] = s[self.dim] // n + self.lo + self.hi
        return tuple(s)


@dataclasses.dataclass
class Collective:
    """One inter-shard data movement the plan emits.  ``nbytes`` is the
    predicted per-device bytes actually moved over the links (ring
    formulas — an all-gather moves ``(n-1)/n`` of its payload, a psum
    twice that, a halo exactly its margins); ``pos`` is the semantic-
    block index *before* which it runs (``len(blocks)`` = epilogue)."""

    op: str              # "psum" | "all_gather" | "halo" | "ring_matmul"
    buffer: str
    nbytes: float
    pos: int
    dim: int = -1
    lo: int = 0
    hi: int = 0
    block: str = ""      # the block this collective serves
    overlap: bool = False
    t_comm_s: float = 0.0
    t_hidden_s: float = 0.0

    def to_json(self) -> Dict:
        return {
            "collective": self.op, "buffer": self.buffer,
            "bytes": self.nbytes, "block": self.block, "dim": self.dim,
            "lo": self.lo, "hi": self.hi,
            "overlap": self.overlap, "t_comm_s": self.t_comm_s,
            "t_hidden_s": self.t_hidden_s,
        }


@dataclasses.dataclass
class BlockPlan:
    """Per-semantic-block shard decision."""

    name: str
    kind: str                      # "shard" | "kred" | "ring" | "replicated"
    split: str = ""                # the split index ("" for replicated)
    views: Dict[str, BufView] = dataclasses.field(default_factory=dict)
    ring: Optional[Dict] = None    # {"x","w","out","m","f",...} for "ring"


@dataclasses.dataclass
class Segment:
    """A run of consecutive blocks compiled as one shard-local program."""

    program: Program
    inputs: List[str]
    outputs: List[str]


@dataclasses.dataclass
class ShardPlan:
    n: int
    mesh_shape: Tuple[int, ...]
    seed: str                              # "block.var" that seeded the plan
    block_plans: List[BlockPlan]
    in_specs: Dict[str, int]               # program input -> sharded dim (-1 = replicated)
    collectives: List[Collective]
    steps: List[Tuple]                     # ordered emission script
    compute_s: float = 0.0
    comm_s: float = 0.0

    @property
    def cost_s(self) -> float:
        exposed = sum(
            max(c.t_comm_s - (c.t_hidden_s if c.overlap else 0.0), 0.0)
            for c in self.collectives)
        return self.compute_s + exposed

    def collective_bytes(self) -> float:
        return sum(c.nbytes for c in self.collectives)

    def splits(self) -> Dict[str, str]:
        return {bp.name: bp.split for bp in self.block_plans if bp.split}

    def report(self, scale_compute: bool = True) -> List[Dict]:
        """Pass-trace records for ``score_pass_trace``.  ``scale_compute``
        emits the per-block split records that divide autotile roofline
        terms by ``n`` — the annotation path (partition ran before
        autotile, which then priced global shapes) wants it; the
        driver's mesh path, whose segment traces are already
        local-sized, must not."""
        out: List[Dict] = [{
            "mesh": list(self.mesh_shape), "n": self.n, "seed": self.seed,
            "compute_s": self.compute_s, "comm_s": self.comm_s,
            "collective_bytes": self.collective_bytes(),
        }]
        if scale_compute:
            out.extend({"block": bp.name, "split": bp.split, "n": self.n}
                       for bp in self.block_plans
                       if bp.split and bp.kind in ("shard", "kred", "ring"))
        out.extend(c.to_json() for c in self.collectives)
        return out

    # -------------------------------------------------------------- segments
    def build_segments(self, prog: Program) -> List[Segment]:
        """Materialize the plan's compute segments as shard-local
        programs over the *semantic* blocks of ``prog``."""
        semantic = prog.source or prog
        by_name = {s.name: s for s in semantic.entry.stmts
                   if isinstance(s, Block)}
        plans = {bp.name: bp for bp in self.block_plans}
        segments: List[Segment] = []
        for step in self.steps:
            if step[0] != "segment":
                continue
            names = step[2]
            seg_blocks = [self._localize(by_name[nm], plans[nm], semantic)
                          for nm in names]
            segments.append(self._seg_program(
                semantic, seg_blocks, [plans[nm] for nm in names],
                f"{semantic.entry.name}.seg{len(segments)}"))
        return segments

    def _localize(self, block: Block, bp: BlockPlan, prog: Program) -> Block:
        """One semantic block rewritten into shard-local coordinates."""
        b = block.clone(deep=True)
        n = self.n
        if bp.split:
            from .poly import Index

            b.idxs = [Index(i.name, i.range // n, i.affine)
                      if i.name == bp.split else i for i in b.idxs]
        drop: set = set()
        for r in b.refs:
            view = bp.views.get(r.from_buf)
            if view is None or not view.sharded:
                continue
            decl = prog.buffers[r.from_buf]
            local = view.local_shape(decl.shape, n)
            if r.strides is not None:
                r.strides = row_major_strides(local)
            if view.lo or view.hi:
                e0 = r.offsets[view.dim]
                if len(e0.terms) > 1 or e0.const != 0:
                    # zero-filled margins implement the frontend's
                    # boundary clamp; the constraints would now mask
                    # real neighbor data
                    size = decl.shape[view.dim]
                    drop.add(str(e0))
                    drop.add(str(aff(size - 1) - e0))
                offs = list(r.offsets)
                offs[view.dim] = e0 + aff(view.lo)
                r.offsets = tuple(offs)
        if drop:
            b.constraints = [c for c in b.constraints
                             if str(c.expr) not in drop]
        return b

    def _seg_program(self, prog: Program, seg_blocks: List[Block],
                     plans: List[BlockPlan], name: str) -> Segment:
        n = self.n
        views: Dict[str, BufView] = {}
        for bp in plans:
            for buf, v in bp.views.items():
                prev = views.get(buf)
                if prev is not None and prev != v:
                    raise UnsupportedMesh(
                        f"inconsistent views of {buf!r} within one segment "
                        f"({prev} vs {v}) — planner failed to cut")
                views[buf] = v
        buffers: Dict[str, TensorDecl] = {}
        for buf, v in views.items():
            d = prog.buffers[buf]
            buffers[buf] = TensorDecl(buf, v.local_shape(d.shape, n), d.dtype)
        written: List[str] = []
        read: List[str] = []
        for b in seg_blocks:
            for r in b.refs:
                if r.dir in (RefDir.OUT, RefDir.INOUT):
                    if r.from_buf not in written:
                        written.append(r.from_buf)
                elif r.from_buf not in read:
                    read.append(r.from_buf)
        inputs = [b for b in read if b not in written]
        # everything written survives the segment: later segments, ring
        # steps or the program epilogue may consume it, and shard-local
        # dead stores are cheap at these sizes
        outputs = list(written)
        entry = Block(name=name, tags={"main"})
        for buf, decl in buffers.items():
            dir_ = (RefDir.IN if buf in inputs
                    else (RefDir.OUT if buf in outputs else RefDir.INOUT))
            entry.refs.append(Refinement(
                dir=dir_, from_buf=buf, into=buf,
                offsets=(aff(0),) * decl.rank, shape=decl.shape,
                dtype=decl.dtype, strides=row_major_strides(decl.shape)))
        entry.stmts.extend(seg_blocks)
        local = Program(buffers=buffers, entry=entry,
                        inputs=inputs, outputs=outputs)
        return Segment(program=local, inputs=inputs, outputs=outputs)


# --------------------------------------------------------------------------
# access decomposition and block classification
# --------------------------------------------------------------------------
def _split_access(e: Affine, ranges: Mapping[str, int]):
    """Decompose an access expression along a sharded dim into
    ``(carrier, lo, hi)``: the unit-coefficient index that carries the
    shard, plus the halo margins the residual terms sweep over the other
    indices' boxes.  Returns ``(None, 0, 0)`` when no index qualifies."""
    cands = [v for v, c in e.terms if c == 1 and v in ranges]
    if not cands:
        return None, 0, 0
    v = max(cands, key=lambda x: ranges[x])
    lo = hi = e.const
    for w, c in e.terms:
        if w == v:
            continue
        ext = ranges.get(w, 1) - 1
        if c >= 0:
            hi += c * ext
        else:
            lo += c * ext
    return v, max(-lo, 0), max(hi, 0)


def _store_depends_on(block: Block, ref_into: str) -> bool:
    """Does the stored scalar transitively depend on the load from
    ``ref_into``?  (Halo legality: the margin-zeroed operand must reach
    the aggregation multiplicatively, i.e. be part of the product.)"""
    from .ir import Constant, Intrinsic, Load, Store

    deps: Dict[str, List[str]] = {}
    loaded: Dict[str, str] = {}
    stored: Optional[str] = None
    for s in block.stmts:
        if isinstance(s, Load):
            loaded[s.into] = s.buf
        elif isinstance(s, Intrinsic):
            deps[s.into] = list(s.args)
        elif isinstance(s, Constant):
            deps[s.into] = []
        elif isinstance(s, Store):
            stored = s.scalar
    if stored is None:
        return False
    seen, todo = set(), [stored]
    while todo:
        x = todo.pop()
        if x in seen:
            continue
        seen.add(x)
        if loaded.get(x) == ref_into:
            return True
        todo.extend(deps.get(x, ()))
    return False


def _mul_chain(block: Block) -> bool:
    from .ir import Intrinsic

    return all(s.op == "mul" for s in block.stmts if isinstance(s, Intrinsic))


def _block_seconds(block: Block, hw: HardwareConfig,
                   decls: Mapping[str, TensorDecl]) -> float:
    """Roofline proxy for candidate arbitration (not the autotiler's
    model — just enough to rank split choices consistently)."""
    iters = 1
    for i in block.idxs:
        if not i.is_passthrough():
            iters *= i.range
    flops = 2.0 * iters if "contraction" in block.tags else float(iters)
    nbytes = sum(decls[r.from_buf].size() * dtype_bytes(r.dtype)
                 for r in block.refs if r.from_buf in decls)
    hbm_bw = hw.mem_units[0].bandwidth if hw.mem_units else 1e11
    return max(flops / max(hw.peak_flops, 1.0), nbytes / max(hbm_bw, 1.0))


def _buf_bytes(decl: TensorDecl) -> float:
    return float(decl.size() * dtype_bytes(decl.dtype))


def _match_ring_matmul(block: Block, out_ref: Refinement,
                       in_refs: List[Refinement], split: str,
                       ranges: Mapping[str, int], n: int) -> Optional[Dict]:
    """Recognize ``O[m,f] += x[m,split] * w[split,f]`` with ``F % n == 0``
    and a float dtype — the shape ``ring_matmul_reduce_scatter`` lowers."""
    if out_ref.agg != "add" or len(in_refs) != 2:
        return None
    offs = out_ref.offsets
    if len(offs) != 2 or any(len(e.terms) != 1 or e.const != 0 or
                             e.terms[0][1] != 1 for e in offs):
        return None
    m, f = offs[0].terms[0][0], offs[1].terms[0][0]
    if f not in ranges or ranges[f] % n != 0:
        return None
    if out_ref.dtype not in ("float32", "bfloat16", "float16"):
        return None
    x = w = None
    for r in in_refs:
        if len(r.offsets) != 2:
            return None
        if r.offsets == (Affine.var(m), Affine.var(split)):
            x = r
        elif r.offsets == (Affine.var(split), Affine.var(f)):
            w = r
    if x is None or w is None:
        return None
    return {"x": x.from_buf, "w": w.from_buf, "out": out_ref.from_buf,
            "m": m, "f": f}


# --------------------------------------------------------------------------
# plan construction
# --------------------------------------------------------------------------
_MAX_SEEDS = 8


def plan_program(prog: Program, n: int, hw: HardwareConfig,
                 mesh_shape: Sequence[int] = ()) -> ShardPlan:
    """Pick the cheapest shard plan for ``prog`` over ``n`` devices.

    Works on the program's *semantic* form (``prog.source`` when passes
    already ran).  Raises :class:`UnsupportedMesh` when no candidate
    split survives."""
    if n <= 1:
        raise UnsupportedMesh("mesh has a single device")
    semantic = prog.source or prog
    blocks = [s for s in semantic.entry.stmts if isinstance(s, Block)]
    if not blocks or any(not isinstance(s, Block) for s in semantic.entry.stmts):
        raise UnsupportedMesh("program is not a flat list of op blocks")
    mesh_shape = tuple(int(s) for s in mesh_shape) or (n,)

    seeds: List[Tuple[int, str]] = []
    for bi, b in enumerate(blocks):
        for i in b.idxs:
            if (not i.is_passthrough() and i.range % n == 0
                    and i.range >= n and len(seeds) < _MAX_SEEDS):
                seeds.append((bi, i.name))
    if not seeds:
        raise UnsupportedMesh(f"no block index divisible by mesh size {n}")

    plans: List[ShardPlan] = []
    errors: List[str] = []
    for bi, v in seeds:
        try:
            got = _propagate(semantic, blocks, bi, v, n, hw, mesh_shape, {})
            if not isinstance(got, ShardPlan):
                # halo margins are global (max over readers); a second
                # pass applies them uniformly from the first use
                got = _propagate(semantic, blocks, bi, v, n, hw,
                                 mesh_shape, got)
            plans.append(got)
        except UnsupportedMesh as e:
            errors.append(f"{blocks[bi].name}.{v}: {e}")
    if not plans:
        raise UnsupportedMesh("; ".join(errors) or "no feasible split")
    return min(plans, key=lambda p: p.cost_s)


def _propagate(prog: Program, blocks: List[Block], seed_idx: int,
               seed_var: str, n: int, hw: HardwareConfig,
               mesh_shape: Tuple[int, ...],
               pre_halos: Dict[str, Tuple[int, int, int]]):
    """One candidate plan: seed ``blocks[seed_idx]`` on ``seed_var`` and
    propagate forward.  The first call runs with empty ``pre_halos`` and
    returns either a finished plan or the discovered program-input halo
    margins (a dict) for the second pass."""
    decls = prog.buffers
    bw = link_bandwidth(hw, mesh_shape)
    state: Dict[str, Optional[BufView]] = {}
    defined: set = set()
    used_replicated: set = set()
    in_specs: Dict[str, int] = {b: -1 for b in prog.inputs}
    input_halos: Dict[str, Tuple[int, int, int]] = dict(pre_halos)
    need_rerun = False
    collectives: List[Collective] = []
    events: List[Tuple[int, Tuple]] = []   # (pos, emission step)
    block_plans: List[BlockPlan] = []
    compute_s = 0.0

    def decl_bytes(buf: str) -> float:
        return _buf_bytes(decls[buf])

    def emit(op: str, buf: str, pos: int, *, dim=-1, lo=0, hi=0, block="",
             payload: float = 0.0, overlap=False, t_hidden=0.0, step=None):
        if not payload:
            if op == "halo":
                d = decls[buf]
                slice_elems = d.size() // max(d.shape[dim], 1)
                payload = float((lo + hi) * slice_elems * dtype_bytes(d.dtype))
            else:
                payload = decl_bytes(buf)
        t = collective_seconds(op, payload, n, bw)
        moved = collective_seconds(op, payload, n, 1.0)
        collectives.append(Collective(
            op=op, buffer=buf, nbytes=moved, pos=pos, dim=dim, lo=lo, hi=hi,
            block=block, overlap=overlap, t_comm_s=t, t_hidden_s=t_hidden))
        if step is not None:
            events.append((pos, step))

    def widen_input_halo(buf: str, d: int, lo: int, hi: int):
        nonlocal need_rerun
        prev = input_halos.get(buf, (d, 0, 0))
        if prev[0] != d:
            raise UnsupportedMesh(f"{buf!r} halo'd at two different dims")
        merged = (d, max(prev[1], lo), max(prev[2], hi))
        if merged != input_halos.get(buf):
            input_halos[buf] = merged
            need_rerun = True

    for bi, b in enumerate(blocks):
        ranges = {i.name: i.range for i in b.idxs}
        free = {i.name: i.range for i in b.idxs if not i.is_passthrough()}
        out_refs = [r for r in b.refs if r.dir in (RefDir.OUT, RefDir.INOUT)]
        if len(out_refs) != 1:
            raise UnsupportedMesh(f"{b.name}: expected exactly one output ref")
        out_ref = out_refs[0]
        out_buf = out_ref.from_buf
        if out_buf in defined:
            raise UnsupportedMesh(f"{b.name}: multiple writers of {out_buf!r}")
        in_refs = [r for r in b.refs if r.dir == RefDir.IN]
        out_dim: Dict[str, int] = {}
        for d, e in enumerate(out_ref.offsets):
            if len(e.terms) == 1 and e.terms[0][1] == 1 and e.const == 0:
                out_dim[e.terms[0][0]] = d

        # ---- votes: each sharded input nominates the index carrying it
        votes: Dict[str, List[Refinement]] = {}
        gathers: List[Refinement] = []
        for r in in_refs:
            st = state.get(r.from_buf)
            if st is None or not st.sharded:
                continue
            v, _, _ = _split_access(r.offsets[st.dim], ranges)
            if v is None or v not in free:
                gathers.append(r)
            else:
                votes.setdefault(v, []).append(r)
        split: Optional[str] = None
        if votes:
            split = max(votes, key=lambda v: sum(
                decl_bytes(r.from_buf) for r in votes[v]))
            for v2, rs in votes.items():
                if v2 != split:
                    gathers.extend(rs)
        elif bi == seed_idx:
            split = seed_var
        if split is not None and free.get(split, 0) % n != 0:
            gathers.extend(votes.get(split, ()))
            split = None

        # ---- gathers make their buffers replicated before this block
        for r in gathers:
            buf = r.from_buf
            st = state.get(buf)
            if st is None or not st.sharded:
                continue
            if st.lo or st.hi:
                raise UnsupportedMesh(
                    f"{b.name}: cannot all-gather halo-padded {buf!r}")
            emit("all_gather", buf, bi, dim=st.dim, block=b.name,
                 step=("gather", buf, st.dim))
            state[buf] = BufView(-1)

        views: Dict[str, BufView] = {}
        kind = "replicated"
        ring = None
        add_mul = out_ref.agg == "add" and _mul_chain(b)

        def use_replicated(buf: str):
            views[buf] = BufView(-1)
            if buf in in_specs and state.get(buf) is None:
                used_replicated.add(buf)

        def slice_event(buf: str, d: int):
            events.append((bi, ("slice", buf, d, decls[buf].shape[d] // n)))

        if split is None:
            for r in in_refs:
                if r.from_buf not in views:
                    use_replicated(r.from_buf)
            views[out_buf] = BufView(-1)
            state[out_buf] = BufView(-1)
            compute_s += _block_seconds(b, hw, decls)
        elif split in out_dim:
            kind = "shard"
            halo_drop: set = set()
            for r in in_refs:
                buf = r.from_buf
                hits = [d for d, e in enumerate(r.offsets)
                        if split in e.names()]
                if not hits:
                    st = state.get(buf)
                    if st is not None and st.sharded:
                        raise UnsupportedMesh(
                            f"{b.name}: {buf!r} sharded off split {split}")
                    use_replicated(buf)
                    continue
                if len(hits) != 1:
                    raise UnsupportedMesh(
                        f"{b.name}: split {split} addresses two dims of {buf!r}")
                d = hits[0]
                v, lo, hi = _split_access(r.offsets[d], ranges)
                if v != split:
                    raise UnsupportedMesh(
                        f"{b.name}: access to {buf!r} not carried by {split}")
                if decls[buf].shape[d] != free[split]:
                    raise UnsupportedMesh(
                        f"{b.name}: {buf!r} dim {d} size "
                        f"{decls[buf].shape[d]} != range({split})")
                if lo or hi:
                    if not (add_mul and _store_depends_on(b, r.into)):
                        raise UnsupportedMesh(
                            f"{b.name}: halo access to {buf!r} outside "
                            "add-aggregated product form")
                    if max(lo, hi) > free[split] // n:
                        raise UnsupportedMesh(
                            f"{b.name}: halo margin exceeds local extent")
                    e0 = r.offsets[d]
                    size = decls[buf].shape[d]
                    halo_drop.add(str(e0))
                    halo_drop.add(str(aff(size - 1) - e0))
                st = state.get(buf)
                if st is None:  # first use of a program input
                    if buf in used_replicated:
                        if lo or hi or input_halos.get(buf):
                            raise UnsupportedMesh(
                                f"{b.name}: {buf!r} needs halo but was "
                                "already consumed replicated")
                        slice_event(buf, d)
                        state[buf] = BufView(d)
                    else:
                        in_specs[buf] = d
                        if lo or hi:
                            widen_input_halo(buf, d, lo, hi)
                        known = input_halos.get(buf)
                        if known and (known[1] or known[2]):
                            if known[0] != d:
                                raise UnsupportedMesh(
                                    f"{buf!r} halo'd at two different dims")
                            emit("halo", buf, 0, dim=d, lo=known[1],
                                 hi=known[2], block=b.name,
                                 step=("halo", buf, d, known[1], known[2]))
                            state[buf] = BufView(d, known[1], known[2])
                        else:
                            state[buf] = BufView(d)
                elif not st.sharded:  # replicated intermediate -> slice
                    if lo or hi:
                        raise UnsupportedMesh(
                            f"{b.name}: halo access to replicated "
                            f"intermediate {buf!r}")
                    slice_event(buf, d)
                    state[buf] = BufView(d)
                else:
                    if st.dim != d:
                        raise UnsupportedMesh(
                            f"{b.name}: {buf!r} sharded at dim {st.dim}, "
                            f"accessed sharded at dim {d}")
                    want = BufView(d, max(st.lo, lo), max(st.hi, hi))
                    if want != st:
                        if buf not in defined:  # program input: widen + rerun
                            widen_input_halo(buf, d, want.lo, want.hi)
                            k = input_halos[buf]
                            state[buf] = BufView(d, k[1], k[2])
                        elif st.lo or st.hi:
                            raise UnsupportedMesh(
                                f"{b.name}: {buf!r} needs re-padding over "
                                "existing halo margins")
                        else:  # sharded intermediate gains margins here
                            emit("halo", buf, bi, dim=d, lo=want.lo,
                                 hi=want.hi, block=b.name,
                                 step=("halo", buf, d, want.lo, want.hi))
                            state[buf] = want
                views[buf] = state[buf]
            for c in b.constraints:
                if split in c.expr.names() and str(c.expr) not in halo_drop:
                    raise UnsupportedMesh(
                        f"{b.name}: constraint {c} involves split {split}")
            d_out = out_dim[split]
            if decls[out_buf].shape[d_out] != free[split]:
                raise UnsupportedMesh(
                    f"{b.name}: output dim size mismatch on {split}")
            views[out_buf] = BufView(d_out)
            state[out_buf] = BufView(d_out)
            compute_s += _block_seconds(b, hw, decls) / n
        else:
            # ---- reduction split: full-shape partials + psum (or ring)
            kind = "kred"
            if not add_mul:
                raise UnsupportedMesh(
                    f"{b.name}: reduction split {split} needs an "
                    "add-aggregated product block")
            for c in b.constraints:
                if split in c.expr.names():
                    raise UnsupportedMesh(
                        f"{b.name}: constraint {c} involves reduction "
                        f"split {split}")
            for r in in_refs:
                buf = r.from_buf
                hits = [d for d, e in enumerate(r.offsets)
                        if split in e.names()]
                if not hits:
                    st = state.get(buf)
                    if st is not None and st.sharded:
                        raise UnsupportedMesh(
                            f"{b.name}: {buf!r} sharded off the reduction")
                    use_replicated(buf)
                    continue
                if len(hits) != 1:
                    raise UnsupportedMesh(
                        f"{b.name}: split {split} addresses two dims of {buf!r}")
                d = hits[0]
                v, lo, hi = _split_access(r.offsets[d], ranges)
                if v != split or lo or hi:
                    raise UnsupportedMesh(
                        f"{b.name}: reduction access to {buf!r} not a "
                        f"plain {split}")
                if decls[buf].shape[d] != free[split]:
                    raise UnsupportedMesh(
                        f"{b.name}: {buf!r} dim {d} size != range({split})")
                st = state.get(buf)
                if st is None:
                    if buf in used_replicated:
                        slice_event(buf, d)
                    else:
                        in_specs[buf] = d
                    state[buf] = BufView(d)
                elif not st.sharded:
                    slice_event(buf, d)
                    state[buf] = BufView(d)
                elif st.dim != d or st.lo or st.hi:
                    raise UnsupportedMesh(
                        f"{b.name}: {buf!r} view conflicts with the "
                        "reduction split")
                views[buf] = state[buf]
            out_bytes = decl_bytes(out_buf)
            ring_info = _match_ring_matmul(b, out_ref, in_refs, split, free, n)
            overlap = False
            t_hidden = 0.0
            if ring_info is not None:
                t_mm_local = (2.0 * free.get(ring_info["m"], 1)
                              * free[ring_info["f"]] * (free[split] // n)
                              / max(hw.peak_flops, 1.0))
                t_rs = collective_seconds("reduce_scatter", out_bytes, n, bw)
                t_hidden = min(t_rs, t_mm_local * (n - 1) / n)
                overlap = t_hidden > n * RING_STEP_OVERHEAD_S
            if overlap:
                kind = "ring"
                ring = dict(ring_info, split=split, out_dtype=out_ref.dtype)
                emit("ring_matmul", out_buf, bi + 1, block=b.name,
                     payload=out_bytes, overlap=True, t_hidden=t_hidden,
                     step=("ring", b.name, ring))
                compute_s += t_mm_local
            else:
                emit("psum", out_buf, bi + 1, block=b.name,
                     payload=out_bytes, step=("psum", out_buf))
                compute_s += _block_seconds(b, hw, decls) / n
            views[out_buf] = BufView(-1)
            state[out_buf] = BufView(-1)

        defined.add(out_buf)
        block_plans.append(BlockPlan(
            name=b.name, kind=kind, split=split or "", views=views, ring=ring))

    # ---- epilogue: program outputs must end up replicated (global)
    for o in prog.outputs:
        st = state.get(o)
        if st is None:
            raise UnsupportedMesh(f"program output {o!r} never produced")
        if st.sharded:
            if st.lo or st.hi:
                raise UnsupportedMesh(f"program output {o!r} halo-padded")
            emit("all_gather", o, len(blocks), dim=st.dim, block="<output>",
                 step=("gather", o, st.dim))

    if need_rerun and not pre_halos:
        return input_halos
    if need_rerun:
        raise UnsupportedMesh("halo margins failed to converge")

    # ---- assemble the emission script: segments cut at every event
    steps: List[Tuple] = []
    cur: List[str] = []
    n_segs = 0

    def flush():
        nonlocal cur, n_segs
        if cur:
            steps.append(("segment", n_segs, tuple(cur)))
            n_segs += 1
            cur = []

    for bi, bp in enumerate(block_plans):
        pre = [s for p, s in events
               if p == bi and s[0] in ("halo", "gather", "slice")]
        if pre:
            flush()
            steps.extend(pre)
        if bp.kind == "ring":
            flush()
            steps.extend(s for p, s in events
                         if p == bi + 1 and s[0] == "ring" and s[1] == bp.name)
        else:
            cur.append(bp.name)
            post = [s for p, s in events if p == bi + 1 and s[0] == "psum"]
            if post:
                flush()
                steps.extend(post)
    flush()
    steps.extend(s for p, s in events
                 if p == len(block_plans) and s[0] == "gather")

    return ShardPlan(
        n=n, mesh_shape=mesh_shape,
        seed=f"{blocks[seed_idx].name}.{seed_var}",
        block_plans=block_plans, in_specs=in_specs,
        collectives=collectives, steps=steps, compute_s=compute_s,
        comm_s=sum(c.t_comm_s for c in collectives))
