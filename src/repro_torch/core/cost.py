"""Cost models for autotiling (paper §3.3, Fig. 4).

Two models, selected by the hardware config:

* ``cache_lines`` — the paper's model, verbatim: *number of cache lines
  accessed divided by the number of multiply-accumulate operations
  performed*.  Overflow elements still cost lines; constrained-out points
  do not count as MACs.
* ``roofline`` — the TPU generalization: per-tile HBM traffic and MXU
  compute are converted to seconds and the dominant term is minimized
  (Williams et al. roofline, which §3.3 cites as the autotiler's target).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

from .affine import Affine
from .hwconfig import HardwareConfig
from .ir import Block, RefDir, Refinement, dtype_bytes
from .poly import Polyhedron, ceil_div


@dataclasses.dataclass
class TileCost:
    cost: float
    lines: float = 0.0
    macs: float = 0.0
    bytes_hbm: float = 0.0
    t_mem: float = 0.0
    t_compute: float = 0.0
    mem_elems: int = 0
    mem_bytes: int = 0
    n_tiles: int = 1
    feasible: bool = True
    why: str = ""
    latency_s: float = 0.0  # pipelined per-block latency (pipelined_latency)
    plan_bytes: int = 0     # planner-exact VMEM footprint of one tile
    halo_bytes: float = 0.0  # HBM traffic added by halo windows (overlap
    #                          re-fetch + one-time materialization of the
    #                          gathered operand the Pallas lowerer builds)
    # raw (datasheet-peak) roofline terms, kept next to the possibly
    # calibrated t_mem/t_compute — the calibration fit always regresses
    # on raw terms, never on its own previous output
    t_mem_raw: float = 0.0
    t_compute_raw: float = 0.0
    calibrated: bool = False


def _active_calibration(hw: HardwareConfig):
    """The measured-feedback calibration active for this config, or None.
    The no-calibration fast path never hashes the config (this runs once
    per candidate tiling inside the autotile search)."""
    from ..tune import calibrate

    if not calibrate.any_active():
        return None
    return calibrate.get_calibration(hw.fingerprint())


def pipelined_latency(t_mem: float, t_compute: float, n_tiles: int,
                      depth: int) -> float:
    """Predicted block latency under a depth-``depth`` double-buffered
    grid pipeline: prologue (first tile's fetch) + steady state (memory
    and compute overlap, the dominant per-step term repeats) + drain
    (last tile's compute).  With ``depth < 2`` (no double buffering) or
    a single tile there is nothing to overlap and the terms serialize.
    Depths beyond 2 change the memory *footprint* (more slots), not the
    steady state — one buffer ahead already hides the smaller term."""
    n = max(int(n_tiles), 1)
    if depth < 2 or n <= 1:
        return t_mem + t_compute
    step_mem = t_mem / n
    step_comp = t_compute / n
    return step_mem + (n - 1) * max(step_mem, step_comp) + step_comp


def _contig_dim(ref: Refinement) -> int:
    if not ref.strides:
        return ref.rank - 1
    best = min(range(ref.rank), key=lambda d: abs(ref.strides[d]) or 10**9)
    return best


def lines_for_view(shape: Tuple[int, ...], ref: Refinement, line: int, aligned: bool) -> int:
    """Cache lines touched by one tile-view of ``ref``."""
    cd = _contig_dim(ref)
    n = 1
    for d, ext in enumerate(shape):
        if d != cd:
            n *= ext
    ext = shape[cd]
    if aligned:
        per_row = ceil_div(ext, line)
    else:
        # worst-case unaligned: a run of ext elements can straddle one extra line
        per_row = ceil_div(ext + line - 1, line)
    return n * per_row


def _tile_view_shapes(block: Block, tiles: Mapping[str, int]) -> List[Tuple[Refinement, Tuple[int, ...], bool, bool]]:
    """For each refinement of a flat block: (ref, tile view shape, is_tiled,
    aligned_in_contig_dim)."""
    free = {i.name: i.range for i in block.idxs if not i.is_passthrough()}
    eff = {v: min(tiles.get(v, free[v]), free[v]) for v in free}
    out = []
    for r in block.refs:
        shape = []
        uses_tiled_var = False
        for e, orig in zip(r.offsets, r.shape):
            span = 0
            for n, c in e.terms:
                if n in eff:
                    span += abs(c) * (eff[n] - 1)
                    if eff[n] < free[n]:
                        uses_tiled_var = True
            shape.append(span + orig)
        # alignment of the contiguous dim: the outer-step in that dim must be
        # a multiple of the line; conservatively aligned iff the tile covers
        # the full contiguous dim or starts at offsets that are multiples.
        cd = _contig_dim(r)
        e = r.offsets[cd]
        full = all(eff.get(n, 1) >= free.get(n, 1) for n in e.names())
        out.append((r, tuple(shape), uses_tiled_var, full))
    return out


# Exact-MAC memo: keyed by IR content fingerprint (never object identity
# — ``id()`` can be reused after GC, silently returning another block's
# count) and bounded by a small LRU so long sweep processes never grow it
# without bound.
_MACS_CACHE: "collections.OrderedDict[str, Optional[int]]" = collections.OrderedDict()
_MACS_CACHE_MAX = 128


def macs_cache_key(block: Block) -> str:
    from .ir import ir_fingerprint

    return ir_fingerprint(block)


def seed_macs_cache(key: str, value: Optional[int]) -> None:
    """Pre-populate the exact-MAC memo (parallel autotune workers seed it
    with the parent process's precomputed count)."""
    _MACS_CACHE[key] = value
    _MACS_CACHE.move_to_end(key)
    while len(_MACS_CACHE) > _MACS_CACHE_MAX:
        _MACS_CACHE.popitem(last=False)


def count_macs_exact(block: Block, limit: int = 2_000_000,
                     key: Optional[str] = None) -> Optional[int]:
    key = key or macs_cache_key(block)
    if key in _MACS_CACHE:
        _MACS_CACHE.move_to_end(key)
        return _MACS_CACHE[key]
    poly = block.poly
    if poly.rect_size() > limit:
        out = None
    else:
        out = poly.count()
    seed_macs_cache(key, out)
    return out


def block_points(block: Block) -> int:
    """Total leaf iteration points (rect) including nested sub-blocks —
    the MAC count proxy for fused/nested structures."""
    rect = 1
    for i in block.idxs:
        if not i.is_passthrough():
            rect *= i.range
    subs = [s for s in block.stmts if isinstance(s, Block)]
    if not subs:
        return rect
    return rect * sum(block_points(s) for s in subs)


def evaluate_tiling(block: Block, tiles: Mapping[str, int], hw: HardwareConfig, params: Mapping) -> TileCost:
    """Cost of tiling a flat contraction/elementwise block by ``tiles``."""
    free = {i.name: i.range for i in block.idxs if not i.is_passthrough()}
    eff = {v: min(tiles.get(v, free[v]), free[v]) for v in free}
    n_tiles = 1
    for v, r in free.items():
        n_tiles *= ceil_div(r, eff[v])

    views = _tile_view_shapes(block, eff)
    inner_mem = hw.inner_mem()
    line = hw.mem_units[0].cache_line_elems
    count_untiled = params.get("count_untiled", True)

    # ---- memory footprint of one tile -------------------------------------
    mem_elems = 0
    mem_bytes = 0
    any_tiled = any(uses for _, _, uses, _ in views)
    for r, shape, uses_tiled, _ in views:
        elems = 1
        for s in shape:
            elems *= s
        # when nothing is tiled (flat candidate) every view IS the tile
        if count_untiled or uses_tiled or not any_tiled:
            mem_elems += elems
            mem_bytes += elems * dtype_bytes(r.dtype)

    # ---- planner-exact footprint of one tile -------------------------------
    # (memplan's slot model: streamed views get pipeline_depth slots, grid-
    # invariant views one, a revisited output one slot + f32 scratch)
    from . import memplan

    depth = hw.pipeline_depth
    tiled_vars = {v for v in free if eff[v] < free[v]}
    entries: List[Tuple[int, str, int]] = []
    for r, shape, _uses, _al in views:
        elems = 1
        for s in shape:
            elems *= s
        ref_grid = {n for e in r.offsets for n in e.names()} & tiled_vars
        is_out = r.dir in (RefDir.OUT, RefDir.INOUT)
        revisited = is_out and bool(tiled_vars - ref_grid)
        kind, slots = memplan.slots_for(is_out, bool(ref_grid), revisited, depth)
        entries.append((elems * dtype_bytes(r.dtype), kind, slots))
        if revisited:
            entries.append((elems * 4, "scratch", 1))  # f32 partial sums
    plan_bytes = memplan.tile_footprint_bytes(entries)

    cap_e = params.get("mem_cap_elems")
    cap_frac = params.get("mem_cap_frac")
    feasible = True
    why = ""
    if cap_e is not None and mem_elems > cap_e:
        feasible, why = False, f"tile footprint {mem_elems}e > cap {cap_e}e"
    if cap_frac is not None:
        cap = inner_mem.size_bytes * cap_frac
        if params.get("memplan", True):
            if plan_bytes > cap:
                feasible, why = False, (
                    f"planned tile {plan_bytes}B > {cap_frac} of {inner_mem.name}")
        elif mem_bytes * 2 > cap:
            feasible, why = False, f"2x tile bytes {2*mem_bytes} > {cap_frac} of {inner_mem.name}"

    # ---- MACs --------------------------------------------------------------
    macs = block_points(block)
    if params.get("exact_macs"):
        # the tile search injects the block's precomputed fingerprint so a
        # thousand-candidate sweep hashes the IR once, not per candidate
        exact = count_macs_exact(block, key=params.get("_macs_key"))
        if exact is not None and not any(isinstance(s, Block) for s in block.stmts):
            macs = exact

    model = params.get("cost", "cache_lines")
    if model == "cache_lines":
        lines = 0
        bytes_hbm = 0.0
        for r, shape, uses_tiled, aligned in views:
            if not count_untiled and not uses_tiled:
                continue
            n = lines_for_view(shape, r, line, aligned)
            lines += n
            bytes_hbm += n * line * dtype_bytes(r.dtype)
        total_lines = n_tiles * lines
        cost = total_lines / max(macs, 1)
        # seconds-uniform terms so every TileCost converts to a predicted
        # latency (the explore sweeps score cache-line configs too): line
        # transactions priced at outer-memory bandwidth, MACs at peak.
        total_bytes = n_tiles * bytes_hbm
        t_mem = total_bytes / hw.mem_units[0].bandwidth
        t_compute = 2.0 * macs / hw.peak_flops if hw.peak_flops > 0 else 0.0
        t_mem_raw, t_compute_raw = t_mem, t_compute
        cal = _active_calibration(hw)
        overhead = 0.0
        if cal is not None:
            # the paper-exact lines/MAC ranking is left untouched; only
            # the seconds-uniform terms (what the sweeps score) calibrate
            t_mem, t_compute = cal.apply(t_mem, t_compute)
            overhead = cal.overhead_s
        return TileCost(cost=cost, lines=total_lines, macs=macs,
                        bytes_hbm=total_bytes, t_mem=t_mem, t_compute=t_compute,
                        mem_elems=mem_elems, mem_bytes=mem_bytes, n_tiles=n_tiles,
                        feasible=feasible, why=why, plan_bytes=plan_bytes,
                        t_mem_raw=t_mem_raw, t_compute_raw=t_compute_raw,
                        calibrated=cal is not None,
                        latency_s=pipelined_latency(t_mem, t_compute, n_tiles,
                                                    depth) + overhead)

    # ---- roofline model ----------------------------------------------------
    # HBM traffic with *consecutive* reuse, matching the Pallas emission:
    # the grid iterates parallel (output) dims outer, reduction dims inner;
    # a ref's block stays resident only while the innermost grid dims that
    # vary do not address it (BlockSpec revisiting).  The output block is
    # revisited across the whole reduction (scratch accumulation).
    out_vars: List[str] = []
    for r, *_ in views:
        if r.dir in (RefDir.OUT, RefDir.INOUT):
            for e in r.offsets:
                for n in e.names():
                    if n not in out_vars:
                        out_vars.append(n)
    grid_dims = [v for v in free if eff[v] < free[v]]
    # order: parallel first, reduction innermost (lower_pallas.grid_order)
    grid_order = [v for v in grid_dims if v in out_vars] + [v for v in grid_dims if v not in out_vars]
    steps = {v: ceil_div(free[v], eff[v]) for v in grid_dims}
    total_steps = 1
    for v in grid_dims:
        total_steps *= steps[v]

    bytes_hbm = 0.0
    halo_bytes = 0.0
    for r, shape, _uses, _al in views:
        elems = 1
        for s in shape:
            elems *= s
        ref_vars = set()
        for e in r.offsets:
            ref_vars.update(n for n in e.names() if n in steps)
        reuse = 1
        for v in reversed(grid_order):
            if v in ref_vars:
                break
            reuse *= steps[v]
        fetches = max(total_steps // max(reuse, 1), 1)
        factor = 2 if r.dir == RefDir.INOUT else 1
        bytes_hbm += fetches * elems * dtype_bytes(r.dtype) * factor
        # Halo windows (tile view extent > the grid step along a tiled
        # dim — the conv overlap): the Pallas lowerer materializes the
        # overlapping tiles once per input (write the gathered array,
        # read the source), so charge that one-time traffic on top of the
        # per-step fetches, which already include the margin.  Larger
        # tiles along the halo dims shrink both terms — exactly the
        # amortization the autotiler should buy.
        core = 1
        for e, ext in zip(r.offsets, shape):
            step = sum(abs(c) * eff[n] for n, c in e.terms if n in steps)
            core *= step if 0 < step < ext else ext
        if elems > core:
            unique = 1
            for v in grid_dims:
                if v in ref_vars:
                    unique *= steps[v]
            halo_bytes += 2.0 * unique * elems * dtype_bytes(r.dtype)
    bytes_hbm += halo_bytes
    t_mem = bytes_hbm / hw.mem_units[0].bandwidth

    # compute term with stencil-padding utilization
    flops = 2.0 * macs
    util = 1.0
    stencil = None
    for s in hw.stencils:
        if s.name == params.get("stencil", "mxu"):
            stencil = s
            break
    if stencil is not None and "contraction" in block.tags:
        dims = _classify_mnk(block, eff)
        for extent, mult in zip(dims, stencil.dims):
            if extent is None:
                continue
            padded = ceil_div(extent, mult) * mult
            util *= extent / padded
    t_compute = flops / (hw.peak_flops * max(util, 1e-6))
    t_mem_raw, t_compute_raw = t_mem, t_compute
    cal = _active_calibration(hw)
    overhead = 0.0
    if cal is not None:
        # calibrated terms drive the ranking too: measured feedback can
        # flip which term dominates and therefore which tiling wins
        t_mem, t_compute = cal.apply(t_mem, t_compute)
        overhead = cal.overhead_s
    cost = max(t_mem, t_compute) + 1e-12 * n_tiles
    return TileCost(cost=cost, macs=macs, bytes_hbm=bytes_hbm, t_mem=t_mem,
                    t_compute=t_compute, mem_elems=mem_elems, mem_bytes=mem_bytes,
                    n_tiles=n_tiles, feasible=feasible, why=why,
                    plan_bytes=plan_bytes, halo_bytes=halo_bytes,
                    t_mem_raw=t_mem_raw, t_compute_raw=t_compute_raw,
                    calibrated=cal is not None,
                    latency_s=pipelined_latency(t_mem, t_compute, n_tiles,
                                                depth) + overhead)


# --------------------------------------------------------------------------
# Fusion profitability (fusion-group formation, fuse.py)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class FusionDecision:
    """One accepted/rejected merge during fusion-group formation.

    The model arbitrates HBM bytes saved (the eliminated intermediate's
    write + read) against HBM bytes added (inputs refetched once per grid
    tile that revisits them) and VMEM arena pressure (the canonical tile's
    footprint priced with schedule.py's address-assignment arithmetic)."""

    group: str
    member: str
    kind: str  # "prologue" | "epilogue"
    accepted: bool
    hbm_saved: int = 0
    hbm_added: int = 0
    vmem_bytes: int = 0
    vmem_cap: int = 0
    reason: str = ""

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def canonical_tile(ranges: Mapping[str, int], params: Mapping,
                   clamp_vars=None) -> Dict[str, int]:
    """The tile shape the profitability model prices a group at — fusion
    runs before autotiling, so merges are judged at a plausible tile (the
    stencil-ish default 128, clamped to each range), not the final one.
    Only ``clamp_vars`` (typically the anchor's output indices) are
    clamped: a fused group keeps its whole reduction extent resident in
    the inner memory, so reduction dims are priced at full range."""
    ct = int(params.get("canonical_tile", 128))
    if clamp_vars is None:
        clamp_vars = set(ranges)
    return {v: (min(r, ct) if v in clamp_vars else r) for v, r in ranges.items()}


def tile_view_bytes(ref: Refinement, ranges: Mapping[str, int], tile: Mapping[str, int]) -> int:
    """Bytes of one canonical-tile view of ``ref`` (span of the tiled
    index extents through the ref's affine offsets, times dtype).
    Variables absent from ``tile`` span their full range."""
    elems = 1
    for e, orig in zip(ref.offsets, ref.shape):
        span = 0
        for n, c in e.terms:
            extent = tile.get(n, ranges.get(n, 1))
            span += abs(c) * (extent - 1)
        elems *= span + orig
    return elems * dtype_bytes(ref.dtype)


def refetch_bytes(ref_vars, free: Mapping[str, int], out_vars, tile: Mapping[str, int],
                  full_bytes: int) -> int:
    """Extra HBM traffic a fused read of ``full_bytes`` incurs: the buffer
    is re-fetched once per grid tile along every *output* dimension that
    does not address it (reduction dims revisit for free — the block stays
    resident across the reduction, matching the Pallas emission)."""
    revisits = 1
    for v in out_vars:
        if v not in ref_vars:
            revisits *= ceil_div(free[v], tile.get(v, free[v]))
    return full_bytes * max(revisits - 1, 0)


def fusion_vmem_pressure(refs, ranges: Mapping[str, int], hw: HardwareConfig,
                         params: Mapping, clamp_vars=None) -> Tuple[int, int, bool]:
    """(arena bytes for one canonical tile of the candidate group, cap,
    fits).  Pressure is priced with memplan's slot model: views streamed
    by a clamped (grid) index get ``pipeline_depth`` slots, grid-
    invariant views (addressed only by the resident reduction) one slot,
    and the group's output one slot plus its f32 partial-sum scratch —
    the same arithmetic the autotiler's feasibility check and the
    schedule-time allocator use.  ``params["memplan"] = False`` restores
    the legacy blanket rule (everything double-buffered, no slot
    classes)."""
    from . import memplan
    from .passes.schedule import arena_bytes

    tile = canonical_tile(ranges, params, clamp_vars)
    cap = int(hw.inner_mem().size_bytes * params.get("mem_cap_frac", 0.45))
    if not params.get("memplan", True):
        sizes = [tile_view_bytes(r, ranges, tile) for r in refs]
        pressure = 2 * arena_bytes(sizes)
        return pressure, cap, pressure <= cap

    depth = hw.pipeline_depth
    streaming_vars = {v for v, t in tile.items() if t < ranges.get(v, 1)}
    entries: List[Tuple[int, str, int]] = []
    for r in refs:
        nbytes = tile_view_bytes(r, ranges, tile)
        ref_vars = {n for e in r.offsets for n in e.names()}
        streamed = bool(ref_vars & streaming_vars)
        is_out = r.dir in (RefDir.OUT, RefDir.INOUT)
        # at fusion time the whole reduction stays inside the tile, so an
        # output with any reduction extent is a revisited accumulator
        revisited = is_out and any(v not in ref_vars for v in ranges)
        kind, slots = memplan.slots_for(is_out, streamed, revisited, depth)
        entries.append((nbytes, kind, slots))
        if revisited:
            elems = nbytes // max(dtype_bytes(r.dtype), 1)
            entries.append((elems * 4, "scratch", 1))
    pressure = memplan.tile_footprint_bytes(entries)
    return pressure, cap, pressure <= cap


# --------------------------------------------------------------------------
# Interconnect model (multi-device lowering, core.shardplan / mesh_lower)
# --------------------------------------------------------------------------
# Fallback link bandwidth when a config models no interconnect
# (ici_link_bw == 0): a conservative PCIe-ish number so mesh plans on
# such configs still get finite, comparable communication costs instead
# of dividing by zero.
DEFAULT_LINK_BW = 16e9
# Fixed per-step cost of one ring-overlap stage (ppermute launch + loop
# bookkeeping).  A ring that cannot hide at least this much per step is
# not worth its n extra kernel launches and stays a plain psum.
RING_STEP_OVERHEAD_S = 5e-6


def link_bandwidth(hw: HardwareConfig, mesh_shape: Tuple[int, ...] = ()) -> float:
    """Effective per-device interconnect bandwidth for ring collectives
    on ``mesh_shape``.  Each mesh axis of a torus contributes an
    independent link pair, so a 2-D mesh moves ring traffic twice as
    fast as a flat ring over the same chips — this is how the mesh
    *shape* (not just its size) enters the cost model."""
    bw = hw.ici_link_bw or DEFAULT_LINK_BW
    axes = len([s for s in mesh_shape if int(s) > 1]) or 1
    return bw * axes


def collective_seconds(op: str, nbytes: float, n: int, bw: float) -> float:
    """Per-device time of one ring collective moving ``nbytes`` of
    *global* payload over ``n`` devices at link bandwidth ``bw``.

    Ring formulas (per device): all-gather and reduce-scatter each move
    ``(n-1)/n`` of the full payload; an all-reduce (psum) is
    reduce-scatter + all-gather, ``2(n-1)/n``; a halo exchange moves
    exactly its margin bytes (``nbytes`` is already the margin)."""
    n = max(int(n), 1)
    if n <= 1 or nbytes <= 0:
        return 0.0
    if op in ("all_gather", "reduce_scatter", "slice"):
        frac = (n - 1) / n
    elif op in ("psum", "ring_matmul"):
        frac = 2 * (n - 1) / n
    else:  # halo: nbytes is the exchanged margin itself
        frac = 1.0
    return frac * float(nbytes) / max(bw, 1.0)


# --------------------------------------------------------------------------
# Whole-program analytic scoring (design-space exploration, repro_torch.explore)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ProgramScore:
    """Analytic score of one compiled program on one hardware config —
    the three Pareto axes the explore subsystem reports (predicted
    latency, VMEM arena pressure, kernels launched) plus the roofline
    ingredients they came from.

    Built from the JSON pass trace (``score_pass_trace``), so a program
    can be scored from a disk-cache payload without recompiling — the
    sweep runner's fingerprint dedupe path."""

    latency_s: float = 0.0       # pipelined-wavefront latency (see below)
    latency_serial_s: float = 0.0  # blocks serialized (the legacy model)
    bytes_hbm: float = 0.0
    flops: float = 0.0
    vmem_peak_bytes: int = 0     # largest planned arena across blocks
    vmem_bump_peak_bytes: int = 0  # same views under the legacy bump model
    n_kernels: int = 0           # fusion groups = dispatch units
    n_blocks: int = 0
    n_levels: int = 0            # wavefront levels the schedule found
    # interconnect terms (partition pass's shard plan; zero on
    # single-device compiles)
    comm_bytes: float = 0.0      # predicted per-device collective bytes
    comm_s: float = 0.0          # total collective time (incl. hidden)
    n_collectives: int = 0
    per_block: List[Dict] = dataclasses.field(default_factory=list)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def score_pass_trace(trace, n_kernels: int = 0) -> ProgramScore:
    """Aggregate a ``PassManager`` trace (or its JSON round-trip from the
    disk cache) into a :class:`ProgramScore`.

    The autotile pass reports each block's chosen tiling with its
    roofline terms and pipelined per-block latency; the schedule pass
    reports per-block wavefront levels and planned arena bytes.  The
    **pipelined wavefront model** overlaps work the schedule proved
    independent: blocks in one wavefront level share the memory system
    and the compute units concurrently, so a level costs
    ``max(sum t_mem, sum t_compute, max block latency)`` and levels run
    back-to-back.  Blocks the schedule did not level (older traces, or
    passes that renamed blocks) serialize after the levels — which
    degrades exactly to the legacy sum-of-blocks model."""
    score = ProgramScore(n_kernels=n_kernels)
    recs: List[Dict] = []
    levels: Dict[str, int] = {}
    splits: Dict[str, int] = {}      # semantic block -> mesh devices
    comm_exposed = 0.0               # collective time not hidden by compute

    def split_of(block: str) -> int:
        """Shard factor for an autotile rec's block, matching the
        partition pass's semantic names against post-fuse/post-tile
        names (anchor, anchor.sub, or a+b fusion-group names)."""
        for b, k in splits.items():
            if block == b or block.startswith(b + ".") or b in block.split("+"):
                return k
        return 1

    for entry in trace or ():
        name = entry[0]
        report = entry[2] if len(entry) > 2 else []
        if name == "partition":
            # shard-plan annotations: split records scale per-device
            # compute; collective records price the interconnect.  The
            # driver's mesh path appends pre-scaled traces (segments are
            # already local-sized) and emits no split records.
            for rec in report:
                if not isinstance(rec, dict):
                    continue
                if "split" in rec and "block" in rec and rec.get("n"):
                    splits[str(rec["block"])] = max(int(rec["n"]), 1)
                if "collective" in rec:
                    t = float(rec.get("t_comm_s", 0.0))
                    hidden = float(rec.get("t_hidden_s", 0.0)) if rec.get("overlap") else 0.0
                    score.comm_bytes += float(rec.get("bytes", 0.0))
                    score.comm_s += t
                    score.n_collectives += 1
                    comm_exposed += max(t - hidden, 0.0)
        elif name == "autotile":
            for rec in report:
                if not isinstance(rec, dict) or "t_mem" not in rec:
                    continue
                k = split_of(str(rec.get("block", "")))
                if k > 1:
                    rec = dict(rec)
                    for f in ("t_mem", "t_compute", "latency_s", "bytes_hbm",
                              "macs", "t_mem_raw", "t_compute_raw"):
                        if f in rec and rec[f] is not None:
                            rec[f] = rec[f] / k
                recs.append(rec)
                score.bytes_hbm += rec.get("bytes_hbm", 0.0)
                score.flops += 2.0 * rec.get("macs", 0.0)
                # tile footprint is the pressure floor even when no arena
                # is scheduled (single-tile "fits_inner" blocks)
                score.vmem_peak_bytes = max(score.vmem_peak_bytes,
                                            int(rec.get("plan_bytes",
                                                        rec.get("mem_bytes", 0))))
                score.n_blocks += 1
                score.per_block.append(dict(rec))
        elif name == "schedule":
            for rec in report:
                if not isinstance(rec, dict):
                    continue
                if "level" in rec and "block" in rec:
                    levels[str(rec["block"])] = int(rec["level"])
                if "arena_bytes" in rec:
                    score.vmem_peak_bytes = max(score.vmem_peak_bytes,
                                                int(rec["arena_bytes"]))
                if "arena_bump_bytes" in rec:
                    score.vmem_bump_peak_bytes = max(
                        score.vmem_bump_peak_bytes, int(rec["arena_bump_bytes"]))

    def block_latency(rec: Dict) -> float:
        lat = rec.get("latency_s")
        if lat is None:
            lat = max(rec.get("t_mem", 0.0), rec.get("t_compute", 0.0))
        return float(lat)

    def level_of(rec: Dict) -> Optional[int]:
        name = str(rec.get("block", ""))
        cands = [lvl for n, lvl in levels.items()
                 if n == name or n.startswith(name + ".")]
        return min(cands) if cands else None

    by_level: Dict[int, List[Dict]] = {}
    serial: List[Dict] = []
    for rec in recs:
        lvl = level_of(rec)
        (by_level.setdefault(lvl, []) if lvl is not None else serial).append(rec)
    for lvl in sorted(by_level):
        group = by_level[lvl]
        score.latency_s += max(sum(r.get("t_mem", 0.0) for r in group),
                               sum(r.get("t_compute", 0.0) for r in group),
                               max(block_latency(r) for r in group))
    for rec in serial:
        score.latency_s += block_latency(rec)
    # collective time the overlap decisions could not hide serializes
    # after the wavefront (ring-overlapped collectives contribute only
    # their exposed remainder)
    score.latency_s += comm_exposed
    score.latency_serial_s = sum(block_latency(r) for r in recs) + comm_exposed
    score.n_levels = len(by_level)
    return score


def _classify_mnk(block: Block, eff: Mapping[str, int]):
    """(m, n, k) tile extents for stencil utilization: n = output contiguous
    var, k = largest reduction var, m = product of remaining output vars."""
    out_ref = None
    for r in block.refs:
        if r.dir in (RefDir.OUT, RefDir.INOUT):
            out_ref = r
    if out_ref is None:
        return (None, None, None)
    out_vars = [e.terms[0][0] for e in out_ref.offsets if len(e.terms) == 1]
    if not out_vars:
        return (None, None, None)
    n_var = out_vars[-1]
    red = [v for v in eff if v not in out_vars]
    k = max((eff[v] for v in red), default=None)
    # range-1 indexes are dropped from eff by the tiler; they still appear
    # in the output ref (e.g. batch=1 decode), so default their extent to 1
    m = 1
    for v in out_vars[:-1]:
        m *= eff.get(v, 1)
    return (m if out_vars[:-1] else None, eff.get(n_var, 1), k)
