"""Autotiling (paper §3.3).

Explores a space of tile shapes under memory-capacity and stencil-multiple
constraints with a cost function (cache-lines/MAC or TPU roofline, per the
hardware config) and rewrites the chosen tiling via ``split_block``.

Two additions over the plain exhaustive search:

* **Oracle replay** — when the pass manager injects a ``TilingOracle``
  (``params["_oracle"]``) with a known tiling for a block, the search is
  skipped and the recorded tiling replayed (warm compile path).
* **Parallel search** — ``params["workers"] > 1`` evaluates candidate
  chunks across a ``concurrent.futures`` process pool.  Tie-breaking is
  deterministic: candidates are globally indexed in serial enumeration
  order and the reduction takes the minimum of ``(cost, index)``, which is
  exactly the serial loop's first-best-wins rule — the parallel search
  always picks the identical tiling.
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, List, Mapping, Optional, Tuple

from ..cost import TileCost, evaluate_tiling
from ..hwconfig import HardwareConfig
from ..ir import Block, Program
from ..poly import factors
from ..tiling import split_block
from . import register

ENV_WORKERS = "STRIPE_AUTOTUNE_WORKERS"

# below this many candidates, process spawn overhead dwarfs the search
PARALLEL_MIN_COMBOS = 2048


def _candidates(r: int, search: str) -> List[int]:
    if search == "divisors":
        return factors(r)
    if search == "exhaustive":
        return list(range(1, r + 1))
    # pow2 (default): powers of two up to r, plus r itself
    out = []
    t = 1
    while t < r:
        out.append(t)
        t *= 2
    out.append(r)
    return out


def _resolve_workers(params: Mapping) -> int:
    w = params.get("workers")
    if w is None:
        w = os.environ.get(ENV_WORKERS)
    if w == "auto":
        return os.cpu_count() or 1
    try:
        return max(int(w), 1)
    except (TypeError, ValueError):
        # unset, empty, or garbage: parallelism is optional — never fail
        # a compile over it
        return 1


def _search_chunk(block: Block, hw: HardwareConfig, params: Dict, names: List[str],
                  combos: List[Tuple[int, ...]], base: int,
                  macs_exact=()):
    """Best feasible candidate in one chunk: (cost, global index, tiles)."""
    if macs_exact != ():
        # The exact MAC count (an expensive polyhedron enumeration) is
        # memoized by IR fingerprint — seed the worker's LRU with the
        # parent's precomputed (key, value) so no worker re-enumerates,
        # and thread the key so candidates don't re-hash the IR.
        from ..cost import seed_macs_cache

        seed_macs_cache(*macs_exact)
        params = dict(params, _macs_key=macs_exact[0])
    best = None
    for j, combo in enumerate(combos):
        tiles = dict(zip(names, combo))
        c = evaluate_tiling(block, tiles, hw, params)
        if not c.feasible:
            continue
        if best is None or c.cost < best[0]:
            best = (c.cost, base + j, tiles, c)
    return best


def _search_serial(block, hw, params, names, cands):
    best: Optional[Tuple[Dict[str, int], TileCost]] = None
    for combo in itertools.product(*(cands[v] for v in names)):
        tiles = dict(zip(names, combo))
        c = evaluate_tiling(block, tiles, hw, params)
        if not c.feasible:
            continue
        if best is None or c.cost < best[1].cost:
            best = (tiles, c)
    return best


def _search_parallel(block, hw, params, names, cands, workers):
    import concurrent.futures
    import multiprocessing

    combos = list(itertools.product(*(cands[v] for v in names)))
    # strip private injected state (oracles etc.) before shipping to workers
    clean = {k: v for k, v in params.items() if not k.startswith("_")}
    macs_exact = ()
    if params.get("exact_macs"):
        from ..cost import count_macs_exact, macs_cache_key

        key = params.get("_macs_key") or macs_cache_key(block)
        macs_exact = (key, count_macs_exact(block, key=key))
    chunk = max(1, -(-len(combos) // (workers * 4)))
    try:
        # forkserver: children fork from a clean single-threaded server
        # process, never from this (jax-threaded) one; workers only import
        # the pure-python cost model, so startup stays cheap
        try:
            ctx = multiprocessing.get_context("forkserver")
        except ValueError:
            ctx = multiprocessing.get_context("fork")
        with concurrent.futures.ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
            futs = [
                ex.submit(_search_chunk, block, hw, clean, names,
                          combos[i:i + chunk], i, macs_exact)
                for i in range(0, len(combos), chunk)
            ]
            results = [f.result() for f in futs]
    except (OSError, ValueError, RuntimeError):
        # no fork / pool failure: the serial path is always available
        return _search_serial(block, hw, params, names, cands)
    best = min((r for r in results if r is not None),
               key=lambda r: (r[0], r[1]), default=None)
    if best is None:
        return None
    return best[2], best[3]


def choose_tiling(block: Block, hw: HardwareConfig, params: Mapping) -> Tuple[Dict[str, int], TileCost]:
    free = {i.name: i.range for i in block.idxs if not i.is_passthrough()}
    if params.get("exact_macs") and "_macs_key" not in params:
        # hash the block once for the whole candidate sweep
        from ..cost import macs_cache_key

        params = dict(params, _macs_key=macs_cache_key(block))
    search = params.get("search", "pow2")
    names = sorted(free)
    cands = {v: _candidates(free[v], search) for v in names}
    # multiples of an existing stencil (tags like "stencil:v=8")
    for t in block.tags:
        if t.startswith("stencil:"):
            v, m = t.split(":")[1].split("=")
            m = int(m)
            cands[v] = [c for c in cands[v] if c % m == 0] or [m]

    n_combos = 1
    for v in names:
        n_combos *= len(cands[v])
    max_combos = params.get("max_combos", 200_000)
    if n_combos > max_combos:
        # coordinate-descent fallback: greedy per-dim refinement
        return _coordinate_descent(block, hw, params, free, cands)

    workers = _resolve_workers(params)
    min_combos = params.get("parallel_min_combos", PARALLEL_MIN_COMBOS)
    if workers > 1 and n_combos >= min_combos:
        best = _search_parallel(block, hw, params, names, cands, workers)
    else:
        best = _search_serial(block, hw, params, names, cands)
    if best is None:
        # nothing feasible: fall back to all-ones tiles (always fits)
        tiles = {v: 1 for v in names}
        return tiles, evaluate_tiling(block, tiles, hw, params)
    return best


def _coordinate_descent(block, hw, params, free, cands):
    tiles = {v: c[-1] for v, c in cands.items()}
    cost = evaluate_tiling(block, tiles, hw, params)
    if not cost.feasible:
        # a feasible anchor is required: one-dimensional moves from an
        # infeasible all-max start can be uniformly infeasible when the
        # memory cap needs several dims shrunk at once.  The smallest
        # candidate per dim is the conservative restart.
        tiles = {v: c[0] for v, c in cands.items()}
        cost = evaluate_tiling(block, tiles, hw, params)
    for _ in range(6):
        improved = False
        for v in sorted(free):
            best_t, best_c = tiles[v], cost
            for t in cands[v]:
                trial = dict(tiles)
                trial[v] = t
                c = evaluate_tiling(block, trial, hw, params)
                if c.feasible and (not best_c.feasible or c.cost < best_c.cost):
                    best_t, best_c = t, c
                    improved = True
            tiles[v] = best_t
            cost = best_c
        if not improved:
            break
    return tiles, cost


def _oracle_key(block: Block) -> str:
    """Tiling-oracle key: the block name qualified by the block's content
    fingerprint, so a recorded tiling replays for the *whole group* it was
    chosen for — a fused group whose membership changed (different fusion
    decisions on a warm compile of different source) never inherits a
    stale tiling."""
    from ..ir import ir_fingerprint

    return f"{block.name}#{ir_fingerprint(block)[:16]}"


@register("autotile")
def autotile_pass(prog: Program, hw: HardwareConfig, params: Mapping) -> Program:
    oracle = params.get("_oracle")
    report = params.get("_report")
    new_stmts = []
    for s in prog.entry.stmts:
        if not isinstance(s, Block) or not ({"contraction", "elementwise"} & s.tags) or "grid" in s.tags:
            new_stmts.append(s)
            continue
        free = {i.name: i.range for i in s.idxs if not i.is_passthrough()}
        key = _oracle_key(s) if oracle is not None else s.name
        known = oracle.lookup(key) if oracle is not None else None
        if known is not None:
            tiles = {v: t for v, t in known.items() if v in free}
            cost = evaluate_tiling(s, tiles, hw, params)
            oracle.replays += 1
        else:
            tiles, cost = choose_tiling(s, hw, params)
            if oracle is not None:
                oracle.searches += 1
        if oracle is not None:
            oracle.record(key, tiles)
        if report is not None:
            # per-block analytic record — cost.score_pass_trace aggregates
            # these into the explore subsystem's predicted-latency axis
            report.append({
                "block": s.name, "tiles": dict(tiles), "cost": cost.cost,
                "t_mem": cost.t_mem, "t_compute": cost.t_compute,
                "bytes_hbm": cost.bytes_hbm, "macs": cost.macs,
                "mem_bytes": cost.mem_bytes, "n_tiles": cost.n_tiles,
                "feasible": cost.feasible,
                "latency_s": cost.latency_s, "plan_bytes": cost.plan_bytes,
                "halo_bytes": cost.halo_bytes,
                "pipeline_depth": hw.pipeline_depth,
                # raw (uncalibrated) roofline terms: the calibration fit
                # regresses measured time on these, so an already
                # calibrated trace never feeds back into its own fit
                "t_mem_raw": cost.t_mem_raw, "t_compute_raw": cost.t_compute_raw,
                "calibrated": cost.calibrated,
            })
        if all(tiles.get(v, free[v]) >= free[v] for v in free) and cost.feasible:
            # whole op fits in one tile: keep flat, mark it
            s.add_tag("fits_inner")
            s.comments = f"autotile: single tile ({cost.why or 'fits'})"
            new_stmts.append(s)
            continue
        outer = split_block(s, tiles)
        outer.add_tag("autotiled")
        outer.comments = (
            f"autotile: tiles={tiles} cost={cost.cost:.3e} "
            f"(mem={cost.mem_bytes}B tiles={cost.n_tiles})"
        )
        new_stmts.append(outer)
    prog.entry.stmts = new_stmts
    return prog
