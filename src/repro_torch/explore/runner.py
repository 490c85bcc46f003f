"""Parallel sweep driver.

The pipeline per sweep point:

1. materialize the point's :class:`HardwareConfig` (``space.apply``);
2. **dedupe by fingerprint** — the config name never enters
   ``HardwareConfig.fingerprint()``, so two points that compile
   identically share one compilation-cache entry and the later one is
   never recompiled (it references the earlier result);
3. compile every corpus workload through ``compile_cached`` — the
   sweep-friendly driver entry that runs the pass pipeline under the
   two-level cache but never builds a backend;
4. score the pass trace analytically (``cost.score_pass_trace``):
   predicted latency (roofline), VMEM arena pressure, kernels launched.

Unique points fan out over a process pool (workers recompute from the
shared on-disk cache directory, so a re-run of the same sweep replays
recorded tilings instead of searching).  Optionally the top-K points by
predicted latency are *validated by measurement*: each workload is
lowered through ``stripe_jit`` on a real backend (``cuda`` on the card by
default: the port's kernels) and timed, and the measured ranking is
recorded next to the predicted one.

The measure mode (``measure_candidates``) times candidate tilings per
workload on the sweep's base config and records every measurement in
the tuning DB, which later ``stripe_jit(..., tune=...)`` compiles replay.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from ..core import cache as _cache
from ..core.cost import ProgramScore, score_pass_trace
from ..obs import trace as obs_trace
from ..core.driver import compile_cached, compile_with_tilings, stripe_jit
from ..core.hwconfig import HardwareConfig
from ..kernels._build import KernelBuildError, KernelLaunchError
from ..tune.measure import DEFAULT_CALLS, DEFAULT_ROUNDS, measure_interleaved
from .space import SearchSpace
from .workloads import Workload, get_workloads


@dataclasses.dataclass
class PointResult:
    """One sweep point's outcome — JSON-able for the report."""

    index: int
    config_name: str
    fingerprint: str
    point: Dict[str, Any]
    scores: Dict[str, Dict] = dataclasses.field(default_factory=dict)  # workload -> ProgramScore json
    latency_s: float = 0.0          # sum of per-workload predicted latencies
    vmem_peak_bytes: int = 0        # max across workloads
    n_kernels: int = 0              # sum across workloads (dispatches per corpus pass)
    comm_bytes: float = 0.0         # sum of per-device collective bytes (mesh axis)
    compile_time_s: float = 0.0
    dedup_of: Optional[int] = None  # earlier point index with the same fingerprint
    error: str = ""

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    def workload_latency(self, workload: str) -> float:
        return float(self.scores[workload]["latency_s"])


def score_config(hw: HardwareConfig, workloads: Sequence[Workload],
                 cache: Optional[_cache.CompilationCache] = None,
                 workers: Optional[int] = None) -> Tuple[Dict[str, ProgramScore], float]:
    """Compile + analytically score every workload on one config."""
    from ..core.passes.schedule import program_arena_peak

    scores: Dict[str, ProgramScore] = {}
    t_compile = 0.0
    for w in workloads:
        with obs_trace.span("explore.score", workload=w.name, hw=hw.name):
            opt, rec = compile_cached(w.build(), hw, cache=cache, workers=workers)
            t_compile += rec.compile_time_s
            score = score_pass_trace(rec.pass_trace, n_kernels=rec.n_kernels)
            # cross-check the trace-reported pressure against the scheduled
            # arena tags on the optimized program itself
            score.vmem_peak_bytes = max(score.vmem_peak_bytes, program_arena_peak(opt))
            scores[w.name] = score
    return scores, t_compile


def _aggregate(res: PointResult, scores: Mapping[str, ProgramScore]) -> None:
    res.scores = {w: s.to_json() for w, s in scores.items()}
    res.latency_s = sum(s.latency_s for s in scores.values())
    res.vmem_peak_bytes = max((s.vmem_peak_bytes for s in scores.values()), default=0)
    res.n_kernels = sum(s.n_kernels for s in scores.values())
    res.comm_bytes = sum(s.comm_bytes for s in scores.values())


def _score_point_task(space: SearchSpace, point: Dict[str, Any], index: int,
                      workload_spec: str, cache_dir: Optional[str]) -> Dict:
    """Process-pool task: score one point, JSON in / JSON out."""
    res = PointResult(index=index, config_name=space.point_name(point),
                      fingerprint="", point=dict(point))
    try:
        hw = space.apply(point)
        res.fingerprint = hw.fingerprint()
        cache = _cache.CompilationCache(disk_dir=cache_dir, use_disk=cache_dir is not None)
        scores, t = score_config(hw, get_workloads(workload_spec), cache=cache)
        _aggregate(res, scores)
        res.compile_time_s = t
    except Exception as e:  # a broken point must not kill the sweep
        res.error = f"{type(e).__name__}: {e}"
    return res.to_json()


def _run_points_parallel(space: SearchSpace, jobs: List[Tuple[int, Dict]],
                         workload_spec: str, cache_dir: Optional[str],
                         parallel: int) -> Optional[List[Dict]]:
    import concurrent.futures
    import multiprocessing

    try:
        # forkserver: children fork from a clean single-threaded server
        # process, never from this (torch-threaded) one — same rationale as
        # the parallel autotuner's pool
        try:
            ctx = multiprocessing.get_context("forkserver")
        except ValueError:
            ctx = multiprocessing.get_context("fork")
        with concurrent.futures.ProcessPoolExecutor(max_workers=parallel,
                                                    mp_context=ctx) as ex:
            futs = [ex.submit(_score_point_task, space, point, idx,
                              workload_spec, cache_dir)
                    for idx, point in jobs]
            return [f.result() for f in futs]
    except (OSError, ValueError, RuntimeError, ImportError):
        return None  # serial fallback — parallelism is never load-bearing


@dataclasses.dataclass
class SweepResult:
    space: SearchSpace
    workload_spec: str
    strategy: str
    baseline: PointResult
    points: List[PointResult]
    cache_stats: Dict[str, int]
    wall_time_s: float
    validation: Optional[Dict] = None
    measurement: Optional[Dict] = None  # measure-mode summary (tuning DB feed)

    def unique_points(self) -> List[PointResult]:
        return [p for p in self.points if p.dedup_of is None and not p.error]


def run_sweep(space: SearchSpace, workload_spec: str = "default", *,
              budget: int = 32, strategy: str = "grid", seed: int = 0,
              cache_dir: Optional[str] = None, parallel: int = 0,
              measure_top_k: int = 0, measure_backend: str = "cuda",
              measure_device: str = "cuda",
              measure: int = 0, tune_db=None) -> SweepResult:
    """Drive a full sweep.  ``cache_dir`` is the on-disk compilation-cache
    directory shared by all points/processes (None = in-memory only —
    sweeps never write the user's default ``~/.cache/stripe-repro``
    unless pointed there explicitly).  ``parallel`` > 1 fans unique
    points out over a process pool.  ``measure_top_k`` > 0 additionally
    runs the K best predicted points (plus the baseline) on the real
    ``measure_backend`` with tensors on ``measure_device`` and records the
    measured ranking.

    ``measure`` > 0 runs the **measure mode**: up to that many candidate
    tilings per workload (analytic best, sweep-point winners, scaled
    perturbations) are timed on ``measure_backend`` with tensors on
    ``measure_device`` and every measurement lands in ``tune_db`` (a
    :class:`~repro_torch.tune.TuningDB`; None opens one in ``cache_dir``)
    — later ``stripe_jit`` compiles of the same workload for the same
    device replay the measured winner.  With ``tune_db`` given, the top-K
    validation's measurements are recorded there too."""
    with obs_trace.span("explore.sweep", strategy=strategy, budget=budget,
                        workloads=workload_spec):
        return _run_sweep(space, workload_spec, budget=budget,
                          strategy=strategy, seed=seed, cache_dir=cache_dir,
                          parallel=parallel, measure_top_k=measure_top_k,
                          measure_backend=measure_backend, measure_device=measure_device,
                          measure=measure, tune_db=tune_db)


def _run_sweep(space: SearchSpace, workload_spec: str = "default", *,
               budget: int = 32, strategy: str = "grid", seed: int = 0,
               cache_dir: Optional[str] = None, parallel: int = 0,
               measure_top_k: int = 0, measure_backend: str = "cuda",
               measure_device: str = "cuda", measure: int = 0,
               tune_db=None) -> SweepResult:
    t_start = time.perf_counter()
    workloads = get_workloads(workload_spec)
    cache = _cache.CompilationCache(disk_dir=cache_dir, use_disk=cache_dir is not None)

    # ---- baseline: the stock base config, scored on the same corpus ----
    base_hw = space.base_config()
    baseline = PointResult(index=-1, config_name=base_hw.name,
                           fingerprint=base_hw.fingerprint(), point={})
    scores, t = score_config(base_hw, workloads, cache=cache)
    _aggregate(baseline, scores)
    baseline.compile_time_s = t

    # ---- enumerate points -------------------------------------------------
    if strategy == "grid":
        points = space.grid(budget)
    elif strategy == "random":
        points = space.random(budget, seed=seed)
    elif strategy == "hillclimb":
        # interactive strategy: scored inline (sequentially), then folded
        # into the same result pipeline below via the score memo
        memo: Dict[str, PointResult] = {}

        def hc_score(point: Dict[str, Any]) -> float:
            hw = space.apply(point)
            fp = hw.fingerprint()
            if fp not in memo:
                res = PointResult(index=len(memo), config_name=hw.name,
                                  fingerprint=fp, point=dict(point))
                try:
                    s, tc = score_config(hw, workloads, cache=cache)
                    _aggregate(res, s)
                    res.compile_time_s = tc
                except Exception as e:
                    res.error = f"{type(e).__name__}: {e}"
                memo[fp] = res
            hit = memo[fp]
            # errored points never win the climb (and the inf sentinel
            # stays out of the serialized result)
            return float("inf") if hit.error else hit.latency_s

        points = space.hillclimb(budget, hc_score, seed=seed)
    else:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         "expected grid | random | hillclimb")

    # ---- fingerprint dedupe ----------------------------------------------
    # seeded with the baseline: a swept point that IS the stock config
    # (the grid strategy always revisits it) dedupes to index -1
    results: List[PointResult] = []
    first_by_fp: Dict[str, int] = {baseline.fingerprint: -1}
    jobs: List[Tuple[int, Dict]] = []
    for i, point in enumerate(points):
        hw = space.apply(point)
        fp = hw.fingerprint()
        res = PointResult(index=i, config_name=hw.name, fingerprint=fp,
                          point=dict(point))
        if fp in first_by_fp:
            res.dedup_of = first_by_fp[fp]
        else:
            first_by_fp[fp] = i
            jobs.append((i, point))
        results.append(res)

    # ---- score unique points ---------------------------------------------
    done: Optional[List[Dict]] = None
    if strategy == "hillclimb":
        done = []
        for idx, point in jobs:
            fp = results[idx].fingerprint
            hit = memo.get(fp)
            if hit is not None:
                d = hit.to_json()
                d["index"] = idx
                done.append(d)
            else:  # budget-exhausted point the climber never scored
                done.append(_score_point_task(space, point, idx, workload_spec,
                                              cache_dir))
    elif parallel and parallel > 1 and len(jobs) > 1:
        done = _run_points_parallel(space, jobs, workload_spec, cache_dir,
                                    parallel)
    if done is None:
        done = []
        for idx, point in jobs:
            hw = space.apply(point)
            res = results[idx]
            try:
                s, tc = score_config(hw, workloads, cache=cache)
                _aggregate(res, s)
                res.compile_time_s = tc
            except Exception as e:
                res.error = f"{type(e).__name__}: {e}"
            done.append(res.to_json())

    for d in done:
        res = results[d["index"]]
        # copy only the scored fields: identity (index/point/fingerprint/
        # dedup_of) was fixed by the dedupe pass above
        for f in ("scores", "latency_s", "vmem_peak_bytes", "n_kernels",
                  "comm_bytes", "compile_time_s", "error"):
            setattr(res, f, d[f])
    # deduped points reference (and copy the scores of) their original
    # (-1 = the baseline itself)
    for res in results:
        if res.dedup_of is not None:
            orig = baseline if res.dedup_of == -1 else results[res.dedup_of]
            res.scores = orig.scores
            res.latency_s = orig.latency_s
            res.vmem_peak_bytes = orig.vmem_peak_bytes
            res.n_kernels = orig.n_kernels
            res.comm_bytes = orig.comm_bytes
            res.error = orig.error

    sweep = SweepResult(space=space, workload_spec=workload_spec,
                        strategy=strategy, baseline=baseline, points=results,
                        cache_stats=cache.stats.as_dict(),
                        wall_time_s=time.perf_counter() - t_start)
    if measure_top_k > 0:
        sweep.validation = validate_top_k(sweep, measure_top_k,
                                          backend=measure_backend, cache=cache,
                                          db=tune_db, device=measure_device)
    if measure > 0:
        if tune_db is None:
            from ..tune.db import TuningDB

            tune_db = TuningDB(dir=cache_dir)
        sweep.measurement = measure_candidates(sweep, db=tune_db,
                                               backend=measure_backend,
                                               device=measure_device,
                                               max_candidates=measure,
                                               cache=cache)
    sweep.wall_time_s = time.perf_counter() - t_start
    return sweep


# --------------------------------------------------------------------------
# Measured validation (cost model predicts, measurement validates)
# --------------------------------------------------------------------------
def _random_arrays(prog, seed: int = 0, device="cuda"):
    """The JAX package's draws (``np.random.RandomState(seed)``, in the same
    order), as tensors on ``device``: int buffers take integers in [-3, 3],
    float buffers standard normals, rounded from float32 for bf16 / f16."""
    import numpy as np
    import torch

    from ..core.lower_torch import torch_dtype

    rng = np.random.RandomState(seed)
    arrays = {}
    for name in prog.inputs:
        decl = prog.buffers[name]
        if decl.dtype.startswith("int"):
            a = torch.from_numpy(rng.randint(-3, 4, size=decl.shape).astype(decl.dtype))
        else:
            a = torch.from_numpy(rng.randn(*decl.shape).astype(np.float32))
        arrays[name] = a.to(device=device, dtype=torch_dtype(decl.dtype))
    return arrays


def _timed_thunk(compiled, arrays):
    import torch

    on_card = any(getattr(a, "is_cuda", False) for a in arrays.values())

    def thunk():
        compiled(arrays)
        if on_card:
            torch.cuda.synchronize()
    return thunk


def validate_top_k(sweep: SweepResult, k: int, backend: str = "cuda",
                   cache=None, rounds: int = DEFAULT_ROUNDS,
                   calls: int = DEFAULT_CALLS, db=None,
                   device: str = "cuda") -> Dict:
    """Measure the K best predicted points plus the baseline on a real
    backend; report predicted vs measured ranking.

    The default is ``backend="cuda"`` with tensors on the card: the JAX
    package measures its Pallas kernels, and the twin of that measurement
    is a measurement of this package's kernels, so every unit of every
    measured point runs the hand-written CUDA kernel that lowers it (the
    record's ``block_backends`` says which).  ``device="cpu"`` runs the
    kernels' plain versions instead (the tests do; that time says nothing
    about the card).

    Timing uses the min-of-interleaved-rounds estimator (all candidates
    compile and warm first, then alternate within each round — a noise
    burst inflates one round of everything instead of biasing whichever
    config ran last), with the round count recorded in the result.  Each
    entry also carries the per-workload ``block_backends`` of its compile.
    When ``db`` is a :class:`~repro_torch.tune.TuningDB`, every
    measurement is also recorded there, in the slot of ``device``
    (``interpret`` true for ``"cpu"``)."""
    workloads = get_workloads(sweep.workload_spec)
    ranked = sorted(sweep.unique_points(), key=lambda p: p.latency_s)[:k]
    entries = []
    thunks: Dict[Tuple[int, str], Any] = {}
    records: Dict[Tuple[int, str], Any] = {}
    for pos, res in enumerate([sweep.baseline] + ranked):
        entry = {"index": res.index, "config": res.config_name,
                 "predicted_latency_s": res.latency_s, "error": "",
                 "block_backends": {}}
        with obs_trace.span("explore.validate", config=res.config_name,
                            backend=backend) as sp:
            try:
                hw = sweep.space.base_config() if res.index < 0 else sweep.space.apply(res.point)
                for w in workloads:
                    compiled = stripe_jit(w.build(), hw, backend=backend,
                                          cache=cache)
                    arrays = _random_arrays(compiled.program.source
                                            or compiled.program, device=device)
                    thunks[(pos, w.name)] = _timed_thunk(compiled, arrays)
                    records[(pos, w.name)] = compiled.record
                    entry["block_backends"][w.name] = dict(compiled.record.block_backends)
            except Exception as e:
                entry["error"] = f"{type(e).__name__}: {e}"
                entry["measured_total_us"] = None  # JSON-safe; ranked last
                sp.set(error=entry["error"])
        entries.append(entry)

    measures = measure_interleaved(thunks, rounds=rounds, calls=calls)
    for pos, entry in enumerate(entries):
        if entry["error"]:
            continue
        per_wl = {w.name: measures[(pos, w.name)].min_s * 1e6
                  for w in workloads if (pos, w.name) in measures}
        if len(per_wl) < len(workloads):
            entry["error"] = "measurement dropped (thunk failed in warmup)"
            entry["measured_total_us"] = None
            continue
        entry["measured_us"] = per_wl
        entry["measured_total_us"] = sum(per_wl.values())
    if db is not None:
        for key, m in measures.items():
            rec = records.get(key)
            if rec is None or not rec.ir_fingerprint:
                continue
            db.record(rec.ir_fingerprint, rec.hw_fingerprint, backend, device == "cpu",
                      tilings=rec.tilings, measured_s=m.min_s,
                      predicted_s=score_pass_trace(rec.pass_trace).latency_s,
                      block_backends=rec.block_backends, rounds=m.rounds,
                      calls=m.calls, source="explore.validate",
                      workload=key[1])
    by_pred = sorted(entries, key=lambda e: e["predicted_latency_s"])
    by_meas = sorted(entries, key=lambda e: (e["measured_total_us"] is None,
                                             e["measured_total_us"] or 0.0))
    return {
        "top_k": k, "backend": backend, "device": device, "entries": entries,
        "rounds": rounds, "calls": calls,
        "estimator": "min-of-interleaved-rounds",
        "predicted_rank": [e["index"] for e in by_pred],
        "measured_rank": [e["index"] for e in by_meas],
    }


# --------------------------------------------------------------------------
# Measure mode: candidate tilings -> wall time -> tuning DB
# --------------------------------------------------------------------------
def _scale_tiling(tilings: Mapping[str, Mapping[str, int]],
                  factor: float) -> Dict[str, Dict[str, int]]:
    return {blk: {v: max(1, int(t * factor)) for v, t in tiles.items()}
            for blk, tiles in tilings.items()}


def _candidate_tilings(sweep: SweepResult, workload: Workload, base_tilings,
                       cache, max_candidates: int) -> List[Dict[str, Dict[str, int]]]:
    """Candidate tilings for one workload, analytic first: the base
    config's analytic choice, sweep-point winners' tilings remapped onto
    the base blocks (by block name — a point whose fusion decisions
    differ contributes only its matching groups), and global halve /
    double perturbations of the analytic tiles."""
    from ..tune.db import candidate_id as cid

    cands: List[Dict[str, Dict[str, int]]] = [dict(base_tilings)]
    seen = {cid(base_tilings)}

    def add(c):
        key = cid(c)
        if key not in seen and len(cands) < max_candidates:
            seen.add(key)
            cands.append(c)

    base_by_name = {k.split("#")[0]: k for k in base_tilings}
    for p in sorted(sweep.unique_points(), key=lambda r: r.latency_s):
        if len(cands) >= max_candidates:
            break
        try:
            hw = sweep.space.apply(p.point)
            _, rec = compile_cached(workload.build(), hw, cache=cache)
        except Exception:
            continue
        remapped = dict(base_tilings)
        hit = False
        for key, tiles in rec.tilings.items():
            bk = base_by_name.get(key.split("#")[0])
            if bk is not None and remapped[bk] != tiles:
                remapped[bk] = dict(tiles)
                hit = True
        if hit:
            add(remapped)
    for factor in (0.5, 2.0, 0.25):
        add(_scale_tiling(base_tilings, factor))
    return cands


def unit_plan(compiled) -> str:
    """A content id of what a compiled program launches: per unit in
    execution order, its backend and, for a kernel unit, each launch's
    plan (the kernel, its launch plan, and the output region).  The CUDA
    kernels take the tile as an input to the flattening, not as the
    launch shape, so two tilings launch different kernels only where the
    tiling changes the units (a ragged tile's remainder or constrained
    block): candidates with one ``unit_plan`` time the same launches."""
    from ..core.cache import stable_hash

    steps = getattr(compiled._fn, "steps", None)
    if steps is None:  # whole-program torch or reference lowering
        return stable_hash([compiled.record.backend, compiled.record.groups])[:16]
    sig = []
    for u, kind, obj in steps:
        launches = ([[fn.kernel, repr(fn.plan), list(fn.out_base), list(fn.out_clip)]
                     for fn in obj] if kind == "cuda" else [])
        sig.append([u.name, kind, launches])
    return stable_hash(sig)[:16]


def measure_candidates(sweep: SweepResult, *, db, backend: str = "cuda",
                       device: str = "cuda", max_candidates: int = 6,
                       rounds: int = 2, calls: int = 1, reject_factor: float = 5.0,
                       cache=None) -> Dict:
    """Measure-mode autotuning: wall-time candidate tilings per workload
    on the sweep's base config and record **every** measurement into the
    tuning DB (``db``); the measured winner becomes the entry's best,
    which later ``stripe_jit(..., tune=...)`` compiles replay.

    Candidates run on ``backend`` (``cuda``, the kernels) with tensors on
    ``device``: on ``"cuda"`` the card's time is recorded with
    ``interpret`` false; on ``"cpu"`` the kernels' plain versions run and
    the DB slot says so (``interpret`` true), so such an entry is never
    replayed for the card.  The analytic choice is always candidate 0, so
    the summary's ``improved`` flag is measured-winner vs analytic on
    identical harnesses.  Each workload also reports how many of its
    candidates launch distinct unit plans (``n_distinct_plans``,
    :func:`unit_plan`): candidates with one plan differ only by noise.

    A candidate whose single warm call runs slower than ``reject_factor``
    x the analytic candidate's is **early-rejected** — recorded in the DB
    from that one shot (``rounds=1``, honestly labeled) instead of
    burning full interleaved rounds on a certain loser.  That shot is
    each candidate's second call: the first absorbs what only a first
    call pays (a kernel module's load on the card), so no candidate is
    judged, or judges the others, by it."""
    base_hw = sweep.space.base_config()
    workloads = get_workloads(sweep.workload_spec)
    interpret = device == "cpu"
    summary: Dict[str, Any] = {"backend": backend, "device": device,
                               "interpret": interpret, "rounds": rounds,
                               "calls": calls, "workloads": {}}
    for w in workloads:
        with obs_trace.span("explore.measure", workload=w.name,
                            backend=backend):
            try:
                _, base_rec = compile_cached(w.build(), base_hw, cache=cache)
            except Exception as e:
                summary["workloads"][w.name] = {
                    "error": f"{type(e).__name__}: {e}"}
                continue
            cands = _candidate_tilings(sweep, w, base_rec.tilings, cache,
                                       max_candidates)
            thunks: Dict[int, Any] = {}
            meta: Dict[int, Any] = {}
            plans: Dict[int, str] = {}
            warm_s: Dict[int, float] = {}
            errors: List[str] = []
            for i, cand in enumerate(cands):
                try:
                    compiled = compile_with_tilings(
                        w.build(), base_hw, cand, backend=backend)
                    arrays = _random_arrays(compiled.program.source
                                            or compiled.program, device=device)
                    thunk = _timed_thunk(compiled, arrays)
                    thunk()  # first call: module loads, allocator warm-up
                    t0 = time.perf_counter()
                    thunk()
                    warm_s[i] = time.perf_counter() - t0
                    thunks[i] = thunk
                    meta[i] = compiled.record
                    plans[i] = unit_plan(compiled)
                except (KernelBuildError, KernelLaunchError):
                    raise  # a kernel that cannot build or launch is never skipped
                except Exception as e:
                    # an infeasible perturbation is just skipped
                    errors.append(f"candidate {i}: {type(e).__name__}: {e}")
            cut = (reject_factor * warm_s[0]
                   if 0 in warm_s and reject_factor > 0 else None)
            rejected = {i for i in thunks
                        if cut is not None and i != 0 and warm_s[i] > cut}
            measures = measure_interleaved(
                {i: thunks[i] for i in thunks if i not in rejected},
                rounds=rounds, calls=calls, warmup=0)
            wl: Dict[str, Any] = {"n_candidates": len(measures) + len(rejected),
                                  "n_rejected": len(rejected),
                                  "n_distinct_plans": len(set(plans.values())),
                                  "analytic_s": None, "best_s": None,
                                  "best_candidate": None, "improved": False,
                                  "best_same_plan_as_analytic": None}
            if errors:
                wl["skipped"] = errors
            timings = {i: (m.min_s, m.rounds, m.calls)
                       for i, m in measures.items()}
            for i in rejected:  # one-shot evidence: still worth keeping
                timings[i] = (warm_s[i], 1, 1)
            best_i = None
            for i, (min_s, n_rounds, n_calls) in sorted(timings.items()):
                rec = meta[i]
                predicted = score_pass_trace(rec.pass_trace).latency_s
                cid = db.record(
                    base_rec.ir_fingerprint, base_rec.hw_fingerprint,
                    backend, interpret, tilings=rec.tilings, measured_s=min_s,
                    predicted_s=predicted, rounds=n_rounds, calls=n_calls,
                    source=("explore.measure.rejected" if i in rejected
                            else "explore.measure"), workload=w.name)
                if i == 0:
                    wl["analytic_s"] = min_s
                if wl["best_s"] is None or min_s < wl["best_s"]:
                    wl["best_s"] = min_s
                    wl["best_candidate"] = cid
                    best_i = i
            if wl["analytic_s"] is not None and wl["best_s"] is not None:
                wl["improved"] = wl["best_s"] < wl["analytic_s"]
                wl["speedup_vs_analytic"] = (wl["analytic_s"] / wl["best_s"]
                                             if wl["best_s"] else None)
                # an "improved" winner that launches what the analytic
                # candidate launches won on noise, not on its tiling
                wl["best_same_plan_as_analytic"] = plans.get(best_i) == plans.get(0)
            summary["workloads"][w.name] = wl
    return summary
