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

The JAX package's measure mode (``measure_candidates``: candidate tilings
timed into the tuning DB) needs ``tune/db.py`` and ``stripe_jit(tune=)``,
which are not ported yet (ROADMAP A6): asking for it raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from ..core import cache as _cache
from ..core.cost import ProgramScore, score_pass_trace
from ..obs import trace as obs_trace
from ..core.driver import compile_cached, stripe_jit
from ..core.hwconfig import HardwareConfig
from ..tune.measure import DEFAULT_CALLS, DEFAULT_ROUNDS, measure_interleaved
from .space import SearchSpace
from .workloads import Workload, get_workloads

TUNE_DB_NOT_PORTED = ("the tuning DB (tune/db.py) and stripe_jit(tune=) are not yet "
                      "ported (ROADMAP A6)")


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

    ``measure`` > 0 (the measure mode) and ``tune_db`` need the tuning DB,
    which is not ported yet: they raise ``NotImplementedError``."""
    if measure > 0 or tune_db is not None:
        raise NotImplementedError(f"measure mode: {TUNE_DB_NOT_PORTED}")
    with obs_trace.span("explore.sweep", strategy=strategy, budget=budget,
                        workloads=workload_spec):
        return _run_sweep(space, workload_spec, budget=budget,
                          strategy=strategy, seed=seed, cache_dir=cache_dir,
                          parallel=parallel, measure_top_k=measure_top_k,
                          measure_backend=measure_backend, measure_device=measure_device)


def _run_sweep(space: SearchSpace, workload_spec: str = "default", *,
               budget: int = 32, strategy: str = "grid", seed: int = 0,
               cache_dir: Optional[str] = None, parallel: int = 0,
               measure_top_k: int = 0, measure_backend: str = "cuda",
               measure_device: str = "cuda") -> SweepResult:
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
                                          device=measure_device)
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
    ``db`` (a tuning DB) is not ported yet and raises."""
    if db is not None:
        raise NotImplementedError(f"validate_top_k(db=...): {TUNE_DB_NOT_PORTED}")
    workloads = get_workloads(sweep.workload_spec)
    ranked = sorted(sweep.unique_points(), key=lambda p: p.latency_s)[:k]
    entries = []
    thunks: Dict[Tuple[int, str], Any] = {}
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


def measure_candidates(sweep: SweepResult, **_kwargs) -> Dict:
    """The JAX package's measure mode (candidate tilings wall-timed into
    the tuning DB).  Not ported yet: raises ``NotImplementedError``."""
    raise NotImplementedError(f"measure_candidates: {TUNE_DB_NOT_PORTED}")
