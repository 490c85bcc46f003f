"""The unified compile driver: frontend -> passes -> lowering, cached.

``stripe_jit`` is the single entry point tying the pieces together behind
the two-level compilation cache (``cache.py``):

1. the input (a ``Program``, ``TileProgram``, Tile contraction string, or
   a callable producing one) is built into a Stripe ``Program``;
2. a content key is computed from the canonical IR, the hardware config
   fingerprint, the backend, and this package's tag (so the JAX package
   and this one never share an artifact);
3. **memory hit** — the live ``CompiledProgram`` is returned immediately;
   **disk hit** — the persisted tilings replay through the pass pipeline
   via a ``TilingOracle`` (no autotile search); **miss** — the full
   pipeline runs and both cache levels are populated;
4. the optimized program is lowered by the requested backend:
   ``cuda`` (one hand-written CUDA kernel launch per fusion group, with a
   per-unit fallback to torch for a unit no emitter takes), ``torch``
   (plain PyTorch, run eagerly), or ``reference`` (the exact numpy
   interpreter).

``tune=`` consults the measured tuning DB (``tune/db.py``) before the
analytic search.  The DB's ``interpret`` slot is the JAX package's: there
it means "ran in Pallas interpret mode", here "the kernels' plain versions
ran" (no tensor of the call on the card).  ``stripe_jit(device=)`` names
where the program's tensors will live and so which slot it replays.

``mesh=`` routes a compile through the multi-device path
(:func:`_stripe_jit_mesh`): the shard planner cuts the program into
shard-local segments, each compiled through this same single-device
pipeline, and ``mesh_lower.emit`` stitches them inside
``parallel.spmd.shard_map`` with the plan's explicit collectives.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels import contraction as _kernel
from ..obs import profile as obs_profile
from ..obs import trace as obs_trace
from ..reliability import faults
from . import cache as _cache
from .frontend import TileProgram, single_op_program
from .hwconfig import HardwareConfig
from .interp import execute_reference
from .ir import Block, Program, ir_fingerprint
from .lower_torch import lower_program_torch, synchronize
from .passes import PassManager, TilingOracle

DRIVER_VERSION = 1

BACKENDS = ("torch", "cuda", "reference")


@dataclasses.dataclass
class CompileRecord:
    """What happened during one ``stripe_jit`` call."""

    key: str
    backend: str  # backend actually used (may record a cuda->torch fallback)
    hw_name: str
    cache_hit: bool = False  # in-memory (same-process) hit
    disk_hit: bool = False  # tilings replayed from the on-disk store
    compile_time_s: float = 0.0
    tilings: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    pass_trace: List = dataclasses.field(default_factory=list)
    fallback_reason: str = ""
    # Per-group lowering: the semantic op-block names each fusion group
    # absorbed, and the kernel count — for the cuda backend the kernel
    # launches per call plus one per torch-fallback unit; for torch the
    # fusion-group (unit) count; the reference interpreter reports 0.
    n_kernels: int = 0
    groups: List[List[str]] = dataclasses.field(default_factory=list)
    # Per-block hybrid lowering (cuda backend): which backend each
    # lowering unit (fusion group / boundary-piece set, keyed by its
    # "+"-joined member names) actually took, and why the torch units fell
    # back.  Empty for whole-program backends.
    block_backends: Dict[str, str] = dataclasses.field(default_factory=dict)
    block_fallbacks: Dict[str, str] = dataclasses.field(default_factory=dict)
    # Compile-failure quarantine: True when this compile served the torch
    # fallback because the cuda lowering *crashed* (not a legality
    # fallback) now or within the backoff embargo; ``quarantine`` carries
    # the negative-cache entry (reason, fail_count, backoff_s, expired).
    quarantined: bool = False
    quarantine: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Kernel profiling (``stripe_jit(..., profile=True)``): per lowering
    # unit, the cost model's predicted latency and the best measured wall
    # time observed across calls (synchronizing the card per unit).
    profiled: bool = False
    ir_fingerprint: str = ""
    hw_fingerprint: str = ""
    predicted_latency_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    measured_latency_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    predicted_terms: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    # Where the tilings came from: "analytic" (the autotile search or a
    # plain disk replay of its choice), "tuned" (a measured-best entry
    # served by the tuning DB — ``tuned`` carries the entry's provenance:
    # candidate id, measured latency, measurement source/rounds/age), or
    # "replay" (caller-supplied tilings via ``compile_with_tilings``).
    decision_source: str = "analytic"
    tuned: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Multi-device provenance (``stripe_jit(..., mesh=)``): mesh shape /
    # axis / device count, the shard plan's split decisions, the emitted
    # collectives with their modelled bytes and overlap choices, and a
    # per-segment summary (each segment is its own cached single-device
    # compile).  ``{"fallback": reason, ...}`` when the partitioner found
    # no legal split and the program compiled single-device instead.
    mesh: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def fusion_decisions(self) -> List[Dict]:
        """Accepted/rejected merges recorded by the fusion pass."""
        for entry in self.pass_trace:
            if entry[0] == "fuse" and len(entry) > 2:
                return list(entry[2])
        return []

    def fallback_reasons(self) -> Dict[str, str]:
        """Every recorded cuda fallback: per-unit reasons from the hybrid
        lowering, plus the whole-program reason (key ``"<program>"``) when
        the backend fell back wholesale."""
        out = dict(self.block_fallbacks)
        if self.fallback_reason:
            out["<program>"] = self.fallback_reason
        return out

    def latency_residuals(self) -> List[Dict[str, Any]]:
        """Per-unit (predicted, measured) latency pairs of a profiled
        compile — empty until the compiled program has run."""
        return [{"block": u,
                 "predicted_s": self.predicted_latency_s.get(u),
                 "measured_s": m}
                for u, m in sorted(self.measured_latency_s.items())]


class CompiledProgram:
    """A compiled Stripe program: callable on a dict of input tensors,
    returning a dict of output tensors."""

    def __init__(self, program: Program, fn: Callable[[Mapping[str, Any]], Dict[str, Any]],
                 hw: HardwareConfig, record: CompileRecord):
        self.program = program
        self.hw = hw
        self.record = record
        self._fn = fn

    @property
    def outputs(self) -> List[str]:
        return list(self.program.outputs)

    def __call__(self, arrays: Mapping[str, Any]) -> Dict[str, Any]:
        return self._fn(arrays)


# --------------------------------------------------------------------------
# Input normalization
# --------------------------------------------------------------------------
def _as_program(fn_or_contraction, tensors=None, out=None, ranges=None, name="op") -> Program:
    obj = fn_or_contraction
    if callable(obj) and not isinstance(obj, (Program, TileProgram)):
        obj = obj()
    if isinstance(obj, TileProgram):
        obj = obj.build()
    if isinstance(obj, str):
        if tensors is None or out is None:
            raise ValueError("contraction-string input needs tensors= and out=")
        obj = single_op_program(obj, tensors, out=out, ranges=ranges, name=name)
    if not isinstance(obj, Program):
        raise TypeError(f"cannot compile {type(obj).__name__}; "
                        "expected Program, TileProgram, contraction str, or a callable producing one")
    return obj


def plain_versions_ran(arrays: Mapping[str, Any]) -> bool:
    """The port's ``interpret`` flag of one call: True when no tensor of
    the call lies on the card, so every kernel ran its plain version (the
    twin of the JAX package's Pallas interpret mode)."""
    return not any(isinstance(v, torch.Tensor) and v.is_cuda for v in arrays.values())


# --------------------------------------------------------------------------
# Lowering
# --------------------------------------------------------------------------
def _semantic_groups(opt: Program) -> Optional[List[List[str]]]:
    """Fusion groups of the optimized program as lists of *semantic*
    op-block names (from each block's ``members:`` tag), or None when the
    mapping does not cover the semantic program exactly (e.g. after
    transpose-pass block insertion the driver lowers per op)."""
    from .passes.fuse import members_of

    semantic = opt.source
    if semantic is None:
        return None
    sem_names = {s.name for s in semantic.entry.stmts if isinstance(s, Block)}
    groups: List[List[str]] = []
    seen: set = set()
    for s in opt.entry.stmts:
        if not isinstance(s, Block):
            continue
        g = [n for n in members_of(s) if n in sem_names and n not in seen]
        if g:
            groups.append(g)
            seen.update(g)
    if seen != sem_names:
        return None
    return groups


def _program_groups(opt: Program) -> List[List[str]]:
    """Fusion groups (semantic-op name lists) of an optimized program,
    falling back to one group per semantic op when the mapping is not
    exact — the dispatch-unit count without any backend lowering."""
    semantic = opt.source or opt
    return _semantic_groups(opt) or [
        [s.name] for s in semantic.entry.stmts if isinstance(s, Block)]


@dataclasses.dataclass
class _Lowered:
    """What one backend lowering produced, for the CompileRecord."""

    fn: Callable
    backend: str
    fallback: str = ""
    n_kernels: int = 0
    groups: List[List[str]] = dataclasses.field(default_factory=list)
    block_backends: Dict[str, str] = dataclasses.field(default_factory=dict)
    block_fallbacks: Dict[str, str] = dataclasses.field(default_factory=dict)
    quarantined: bool = False
    quarantine: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _lower(opt: Program, backend: str,
           hw: Optional[HardwareConfig] = None,
           quarantine: Optional[_cache.QuarantineStore] = None,
           key: str = "", profile: bool = False) -> _Lowered:
    """Lower the optimized program.  For the cuda backend, a *crash*
    during lowering (as opposed to a known-unsupported legality fallback)
    degrades to the torch path and negative-caches the key in
    ``quarantine`` with exponential backoff.  A kernel that cannot be
    built or launched is never such a crash: ``KernelBuildError`` and
    ``KernelLaunchError`` propagate, so a broken card or toolchain is never
    hidden behind the torch path."""
    semantic = opt.source or opt
    groups = _program_groups(opt)
    if backend == "reference":
        # the interpreter launches no kernels and ignores grouping
        fn = lambda arrays: execute_reference(  # noqa: E731
            semantic, {k: _numpy(v) for k, v in arrays.items()})
        return _Lowered(fn, backend, groups=groups)
    fallback = ""
    blk_backends: Dict[str, str] = {}
    blk_falls: Dict[str, str] = {}
    quarantined = False
    quar_info: Dict[str, Any] = {}
    if backend == "cuda":
        from .lower_cuda import UnsupportedCuda, lower_program_hybrid

        if quarantine is not None and quarantine.active(key):
            entry = quarantine.get(key)
            backend = "torch"
            fallback = f"quarantined: {entry.reason}"
            quarantined, quar_info = True, entry.as_dict()
        else:
            try:
                faults.check("compile.stripe_jit", key=key, backend="cuda")
                if torch.cuda.is_available():
                    # build at first use, here, so a broken toolchain fails
                    # the compile instead of the first launch
                    _kernel.load_library()
                # per-block hybrid: each fusion group / boundary-piece unit
                # lowers to a kernel or falls back to torch independently
                with obs_trace.span("lower.cuda", profile=profile):
                    fn = lower_program_hybrid(
                        opt, pipeline_depth=hw.pipeline_depth if hw is not None else 2,
                        profile=profile)
            except UnsupportedCuda as e:
                # legality fallback: deterministic and known, no quarantine
                backend, fallback = "torch", str(e)
            except (_kernel.KernelBuildError, _kernel.KernelLaunchError):
                raise
            except Exception as e:  # crash-class failure: quarantine the key
                backend = "torch"
                fallback = f"compile crashed: {e!r}"
                quarantined = True
                if quarantine is not None:
                    quar_info = quarantine.record_failure(key, repr(e)).as_dict()
            else:
                if quarantine is not None and quarantine.get(key) is not None:
                    # the embargo had lapsed and the retry succeeded
                    quarantine.clear(key)
                if fn.n_cuda > 0:
                    return _Lowered(fn, "cuda", "", fn.n_kernels, groups,
                                    dict(fn.block_backends), dict(fn.block_reasons))
                # every unit fell back: take the whole-program torch path
                # below, keeping the per-unit reasons on the record
                backend = "torch"
                fallback = "; ".join(f"{k}: {v}"
                                     for k, v in fn.block_reasons.items())
                blk_backends = dict(fn.block_backends)
                blk_falls = dict(fn.block_reasons)
    with obs_trace.span("lower.torch", profile=profile):
        fn = lower_program_torch(semantic, groups=groups, profile=profile)
    return _Lowered(fn, backend, fallback, fn.n_kernels, groups,
                    blk_backends, blk_falls, quarantined, quar_info)


def _attach_profiling(low: _Lowered, record: CompileRecord,
                      cache: _cache.CompilationCache,
                      tune_db=None, requested_backend: str = "") -> Callable:
    """Wrap a lowered callable so each call folds the lowering's per-unit
    wall times into ``record.measured_latency_s`` (best observation wins;
    the dict is shared with cache-hit records of the same artifact) and
    the first warm call appends (predicted, measured) rows to the residual
    JSONL under the cache dir — and, when a tuning DB is attached,
    records the program's measured latency under its compile identity, so
    profiled serving traffic *populates* the DB.  Both carry the call's
    ``interpret`` flag: whether the plain versions ran
    (``plain_versions_ran``).

    The first call on the card also builds each kernel plan's launch
    parameters on the host (they depend on the operands' alignment, known
    only at the call), which would be timed as the unit's latency: its
    unit times are dropped, and the rows come from the second call.  On
    the plain versions nothing is built, and the first call is warm."""
    inner = low.fn
    unit_times = getattr(inner, "unit_times", None)
    state = {"logged": False, "cold": unit_times is not None}

    def wrapper(arrays):
        t0 = time.perf_counter()
        out = inner(arrays)
        if state["cold"]:
            state["cold"] = False
            if not plain_versions_ran(arrays):
                unit_times.clear()
                return out
        if unit_times is not None:
            record.measured_latency_s.update(unit_times)
        else:
            # whole-program call (reference interpreter): one unit
            synchronize(out.values())
            dt = time.perf_counter() - t0
            prev = record.measured_latency_s.get("<program>")
            if prev is None or dt < prev:
                record.measured_latency_s["<program>"] = dt
        if not state["logged"] and record.measured_latency_s:
            state["logged"] = True
            interpret = plain_versions_ran(arrays)
            obs_profile.append_residuals(
                obs_profile.residual_rows(record, interpret),
                obs_profile.residual_log_path(cache), db=tune_db)
            if tune_db is not None and record.tilings and record.ir_fingerprint:
                try:
                    tune_db.record(
                        record.ir_fingerprint, record.hw_fingerprint,
                        requested_backend or record.backend, interpret,
                        tilings=record.tilings,
                        measured_s=sum(record.measured_latency_s.values()),
                        predicted_s=(sum(record.predicted_latency_s.values())
                                     or None),
                        block_backends=record.block_backends,
                        source="profile")
                except Exception:
                    pass  # measurement feedback must never fail a call
        return out

    return wrapper


# --------------------------------------------------------------------------
# Measured-feedback tuning support
# --------------------------------------------------------------------------
def _resolve_tune(tune, cache: _cache.CompilationCache):
    """Normalize the ``tune=`` argument: None/False disables, True opens
    the :class:`~repro_torch.tune.db.TuningDB` next to the cache's disk
    store (or the default cache dir), and a ``TuningDB`` instance is used
    as given."""
    if tune is None or tune is False:
        return None
    from ..tune.db import TuningDB

    if isinstance(tune, TuningDB):
        return tune
    return TuningDB(dir=cache.disk_dir)


def _calibration_fp(hw_fp: str) -> str:
    """The active calibration's cache-key component for this hardware
    fingerprint ("" when the cost model is uncalibrated)."""
    from ..tune import calibrate

    return calibrate.active_fingerprint(hw_fp) if calibrate.any_active() else ""


# --------------------------------------------------------------------------
# Driver entry points
# --------------------------------------------------------------------------
def compile_cached(prog: Program, hw: HardwareConfig,
                   cache: Optional[_cache.CompilationCache] = None,
                   workers: Optional[int] = None,
                   use_disk: bool = True) -> Tuple[Program, CompileRecord]:
    """Run the pass pipeline under the compilation cache; no lowering.

    The record still carries the fusion groups / kernel count and the
    full pass trace.  Returns a deep copy on memory hits so callers can
    mutate freely.
    """
    if cache is None:
        cache = _cache.get_default_cache()
    t0 = time.perf_counter()
    hw_fp = hw.fingerprint()
    ir_fp = ir_fingerprint(prog)
    key = _cache.content_key(
        "compile", DRIVER_VERSION, _cache.CACHE_VERSION, _cache.PORT_TAG,
        ir_fp, hw_fp, _calibration_fp(hw_fp),
    )
    hit = cache.get_memory(key)
    if isinstance(hit, tuple) and len(hit) == 2 and isinstance(hit[0], Program):
        prog0, rec0 = hit
        rec = dataclasses.replace(copy.deepcopy(rec0), cache_hit=True,
                                  disk_hit=False,
                                  compile_time_s=time.perf_counter() - t0)
        return copy.deepcopy(prog0), rec
    payload = cache.get_disk(key) if use_disk else None
    oracle = TilingOracle(known=(payload or {}).get("tilings"))
    pm = PassManager(hw, oracle=oracle, autotune_workers=workers)
    opt = pm.run(copy.deepcopy(prog))
    groups = _program_groups(opt)
    rec = CompileRecord(key=key, backend="", hw_name=hw.name,
                        disk_hit=payload is not None,
                        compile_time_s=time.perf_counter() - t0,
                        tilings=dict(oracle.chosen), pass_trace=list(pm.trace),
                        n_kernels=len(groups), groups=groups,
                        ir_fingerprint=ir_fp, hw_fingerprint=hw_fp)
    cache.put_memory(key, (opt, rec))
    if use_disk:
        cache.put_disk(key, {"tilings": oracle.chosen, "pass_trace": pm.trace,
                             "hw": hw.name, "compile_time_s": rec.compile_time_s,
                             "n_kernels": rec.n_kernels, "groups": groups})
    return copy.deepcopy(opt), rec


def stripe_jit(fn_or_contraction: Union[Program, TileProgram, str, Callable],
               hw: HardwareConfig, backend: str = "cuda", *,
               tensors: Optional[Mapping[str, Tuple]] = None,
               out: Optional[str] = None,
               ranges: Optional[Mapping[str, int]] = None,
               cache: Optional[_cache.CompilationCache] = None,
               workers: Optional[int] = None,
               use_disk: bool = True,
               profile: bool = False,
               tune: Union[None, bool, Any] = None,
               device: str = "cuda",
               mesh: Union[None, int, Tuple[int, ...], Any] = None) -> CompiledProgram:
    """Compile a tensor op end-to-end through the cached Stripe pipeline.

    ``backend="cuda"`` (the default: the kernel path) launches one
    hand-written CUDA kernel per fusion group for tensors on the card; for
    CPU tensors the kernel's plain PyTorch version runs instead.
    ``workers`` enables the parallel autotune search on cold compiles;
    ``cache`` defaults to the process-wide cache.  ``profile=True``
    wall-times each lowered unit per call: the record carries per-unit
    measured latencies next to the cost model's predictions, and the
    first warm call appends (predicted, measured) rows to ``residuals.jsonl``
    under the cache dir (``profile`` is part of the cache key).
    ``tune`` consults the measured-feedback tuning DB before the analytic
    autotile search: ``True`` opens the DB next to the cache's disk store,
    or pass a :class:`repro_torch.tune.TuningDB`.  A fresh-enough
    measured-best entry replays its tilings instead of searching —
    ``record.decision_source == "tuned"``; each unit's legality is decided
    afresh under them, and a unit that lands on another backend than the
    entry recorded is listed in ``record.tuned["backend_changed"]`` — and
    the entry's candidate id is folded into the cache key, so a better
    measurement automatically re-keys the artifact.  ``device`` (where the
    program's tensors will live: ``"cuda"`` or ``"cpu"``) picks the DB
    slot: entries measured on the plain versions (``interpret`` true) are
    replayed only for ``"cpu"``, entries measured on the card only for
    ``"cuda"``.  With ``profile=True`` the first warm call (see
    ``_attach_profiling``) also records its measurement back into the DB,
    under the slot of that call's tensors.
    ``mesh`` routes the compile through the multi-device path: a device
    count, a mesh shape tuple (both take the machine's first cards, and
    raise when there are too few), or a ``parallel.spmd.Mesh`` with
    explicit devices (``Mesh(["cuda:0"] * 4, ("x",))`` runs four ranks on
    one card) — the partitioner shards the program over the mesh, each
    shard-local segment compiles through this same single-device
    pipeline, and the segments are stitched inside ``shard_map`` with
    explicit collectives; the mesh's devices, not ``device``, then name
    where the segments' tensors live.  A mesh the partitioner cannot shard
    falls back to a single-device compile with ``record.mesh["fallback"]``
    carrying the reason.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r}; expected 'cuda' or 'cpu'")
    if cache is None:
        cache = _cache.get_default_cache()
    if mesh is None and getattr(hw, "mesh_devices", lambda: 1)() > 1:
        mesh = hw.mesh  # the config carries a mesh spec: compile for it
    if mesh is not None:
        from . import mesh_lower

        resolved = mesh_lower.resolve_mesh(mesh)
        if resolved is not None:
            return _stripe_jit_mesh(
                fn_or_contraction, hw, backend, resolved,
                tensors=tensors, out=out, ranges=ranges, cache=cache,
                workers=workers, use_disk=use_disk, profile=profile, tune=tune)
    interpret = device == "cpu"
    with obs_trace.span("compile.stripe_jit", backend=backend, hw=hw.name,
                        profile=profile) as csp:
        t0 = time.perf_counter()
        prog = _as_program(fn_or_contraction, tensors=tensors, out=out, ranges=ranges)
        ir_fp = ir_fingerprint(prog)
        hw_fp = hw.fingerprint()
        tune_db = _resolve_tune(tune, cache)
        tuned = None
        if tune_db is not None:
            # consulted *before* the memory probe: the tuned entry's
            # candidate id is part of the key, so a DB update naturally
            # misses the stale artifact and recompiles with the winner
            with obs_trace.span("tune.lookup", backend=backend) as sp:
                tuned = tune_db.lookup(ir_fp, hw_fp, backend, interpret)
                sp.set(hit=tuned is not None)
            if tuned is not None:
                cache.stats.tuned_hits += 1
            else:
                cache.stats.tuned_misses += 1
        key = _cache.content_key(
            "stripe_jit", DRIVER_VERSION, _cache.CACHE_VERSION, _cache.PORT_TAG,
            ir_fp, hw_fp, backend, bool(interpret), bool(profile),
            tuned.fingerprint if tuned is not None else "",
            _calibration_fp(hw_fp),
        )
        with obs_trace.span("cache.probe", level="memory") as sp:
            hit = cache.get_memory(key)
            sp.set(hit=hit is not None)
        if isinstance(hit, CompiledProgram):
            if hit.record.quarantined and not cache.quarantine.active(key):
                # the cached artifact is a quarantine fallback and the backoff
                # embargo has lapsed: drop through and re-attempt the real
                # backend (success clears the entry, failure doubles backoff)
                hit = None
            else:
                # fresh record per call: never mutate the cached one (the cold
                # caller holds it), and report this call's lookup time
                rec = dataclasses.replace(hit.record, cache_hit=True, disk_hit=False,
                                          compile_time_s=time.perf_counter() - t0)
                if rec.quarantined:
                    entry = cache.quarantine.get(key)
                    rec.quarantine = entry.as_dict() if entry is not None else dict(rec.quarantine)
                csp.set(cache="memory", backend_used=rec.backend)
                return CompiledProgram(hit.program, hit._fn, hit.hw, rec)

        with obs_trace.span("cache.probe", level="disk") as sp:
            payload = cache.get_disk(key) if use_disk else None
            sp.set(hit=payload is not None)
        # the tuned entry's tilings take precedence over the disk replay
        # (the disk payload under a tuned key holds the same tilings)
        known = (tuned.tilings if tuned is not None
                 else (payload or {}).get("tilings"))
        oracle = TilingOracle(known=known)
        pm = PassManager(hw, oracle=oracle, autotune_workers=workers)
        opt = pm.run(copy.deepcopy(prog))
        low = _lower(opt, backend, hw, quarantine=cache.quarantine, key=key,
                     profile=profile)
        record = CompileRecord(
            key=key, backend=low.backend, hw_name=hw.name,
            cache_hit=False, disk_hit=payload is not None,
            compile_time_s=time.perf_counter() - t0,
            tilings=dict(oracle.chosen), pass_trace=list(pm.trace),
            fallback_reason=low.fallback, n_kernels=low.n_kernels,
            groups=low.groups,
            block_backends=low.block_backends, block_fallbacks=low.block_fallbacks,
            quarantined=low.quarantined, quarantine=low.quarantine,
            profiled=bool(profile), ir_fingerprint=ir_fp, hw_fingerprint=hw_fp,
            decision_source="tuned" if tuned is not None else "analytic",
            tuned=({"candidate_id": tuned.candidate_id,
                    "measured_s": tuned.measured_s,
                    "predicted_s": tuned.predicted_s,
                    "source": tuned.source, "rounds": tuned.rounds,
                    "age_s": max(time.time() - tuned.ts, 0.0),
                    "n_candidates": tuned.n_candidates,
                    # units the fresh lowering put on another backend than
                    # the entry recorded: legality is decided afresh under
                    # the replayed tilings, never replayed from the entry
                    "backend_changed": {
                        u: {"entry": b, "now": low.block_backends.get(u, low.backend)}
                        for u, b in tuned.block_backends.items()
                        if b != low.block_backends.get(u, low.backend)}}
                   if tuned is not None else {}),
        )
        if record.tuned.get("backend_changed"):
            csp.set(tuned_backend_changed=sorted(record.tuned["backend_changed"]))
        fn = low.fn
        if profile:
            record.predicted_terms = obs_profile.predicted_unit_terms(
                opt, record.pass_trace)
            record.predicted_latency_s = {
                u: t["latency_s"] for u, t in record.predicted_terms.items()}
            fn = _attach_profiling(low, record, cache, tune_db=tune_db,
                                   requested_backend=backend)
        compiled = CompiledProgram(opt, fn, hw, record)
        cache.put_memory(key, compiled)
        if use_disk:
            cache.put_disk(key, {
                "tilings": oracle.chosen, "pass_trace": pm.trace,
                "hw": hw.name, "backend": low.backend,
                "compile_time_s": record.compile_time_s,
                "n_kernels": low.n_kernels, "groups": low.groups,
                "block_backends": low.block_backends,
                "block_fallbacks": low.block_fallbacks,
                "decision_source": record.decision_source,
            })
        csp.set(cache="disk" if record.disk_hit else "miss",
                backend_used=low.backend, decision=record.decision_source)
        return compiled


def _single_device_hw(hw: HardwareConfig) -> HardwareConfig:
    """The per-shard view of a meshed config: same machine model, no
    mesh (so segment compiles never re-enter the mesh path) and no
    partition pass (segments are already shard-local)."""
    if not getattr(hw, "mesh", ()) and not any(
            name == "partition" for name, _ in hw.passes):
        return hw
    return dataclasses.replace(
        hw, mesh=(),
        passes=tuple((n, p) for n, p in hw.passes if n != "partition"))


def _stripe_jit_mesh(fn_or_contraction, hw: HardwareConfig, backend: str,
                     resolved, *, tensors=None, out=None, ranges=None,
                     cache: Optional[_cache.CompilationCache] = None,
                     workers: Optional[int] = None, use_disk: bool = True,
                     profile: bool = False,
                     tune: Union[None, bool, Any] = None) -> CompiledProgram:
    """The multi-device compile path behind ``stripe_jit(..., mesh=)``.

    The shard planner picks one split per block (output, reduction,
    halo, or ring-overlap — by modelled cost) and cuts the program into
    shard-local *segments*; each segment compiles through the ordinary
    cached single-device ``stripe_jit`` (per-block hybrid cuda/torch
    composer, tuning DB, quarantine — everything), and
    :func:`~repro_torch.core.mesh_lower.emit` stitches the compiled
    segments inside ``shard_map`` with the plan's explicit collectives.
    A program the planner cannot shard falls back to the single-device
    compile, recording the reason in ``record.mesh["fallback"]``.
    """
    from .mesh_lower import emit
    from .shardplan import UnsupportedMesh, plan_program

    mesh, axis, shape = resolved
    n = mesh.size
    hw_inner = _single_device_hw(hw)
    # where the segments' tensors live picks the tuning DB's slot
    device = "cuda" if any(d.type == "cuda" for d in mesh.flat_devices()) else "cpu"
    interpret = device == "cpu"
    with obs_trace.span("compile.stripe_jit_mesh", backend=backend,
                        hw=hw.name, mesh="x".join(map(str, shape))) as csp:
        t0 = time.perf_counter()
        prog = _as_program(fn_or_contraction, tensors=tensors, out=out,
                           ranges=ranges)
        try:
            faults.check("compile.stripe_jit_mesh", backend=backend, n=n)
            plan = plan_program(prog, n, hw, shape)
        except Exception as e:
            if not isinstance(e, UnsupportedMesh):
                # planner crash / injected fault: degrade, don't fail
                e = UnsupportedMesh(f"mesh planning crashed: {e!r}")
            compiled = stripe_jit(prog, hw_inner, backend, cache=cache,
                                  workers=workers, use_disk=use_disk,
                                  profile=profile, tune=tune, device=device)
            rec = dataclasses.replace(
                compiled.record,
                mesh={"fallback": str(e), "shape": list(shape),
                      "axis": axis, "n_devices": n})
            csp.set(fallback=str(e)[:200])
            return CompiledProgram(compiled.program, compiled._fn,
                                   compiled.hw, rec)

        ir_fp = ir_fingerprint(prog)
        hw_fp = hw.fingerprint()
        tune_db = _resolve_tune(tune, cache)
        key = _cache.content_key(
            "stripe_jit_mesh", DRIVER_VERSION, _cache.CACHE_VERSION, _cache.PORT_TAG,
            ir_fp, hw_fp, backend, bool(interpret), bool(profile),
            list(shape), axis, n, [str(d) for d in mesh.flat_devices()],
            _calibration_fp(hw_fp),
        )
        # the outer memory cache is bypassed under tuning: segment keys
        # fold in their tuned candidate ids, so a DB update must be able
        # to re-stitch fresh segment artifacts
        if tune_db is None:
            with obs_trace.span("cache.probe", level="memory") as sp:
                hit = cache.get_memory(key)
                sp.set(hit=hit is not None)
            if isinstance(hit, CompiledProgram):
                rec = dataclasses.replace(
                    hit.record, cache_hit=True, disk_hit=False,
                    compile_time_s=time.perf_counter() - t0)
                csp.set(cache="memory", backend_used=rec.backend)
                return CompiledProgram(hit.program, hit._fn, hit.hw, rec)

        segments = plan.build_segments(prog)
        compiled_segs = [
            stripe_jit(seg.program, hw_inner, backend, cache=cache,
                       workers=workers, use_disk=use_disk, profile=False,
                       tune=tune, device=device)
            for seg in segments]
        fn = emit(prog, plan, segments, compiled_segs, mesh, axis)

        # merge segment provenance into the whole-program record
        pass_trace: List = []
        block_backends: Dict[str, str] = {}
        block_fallbacks: Dict[str, str] = {}
        tilings: Dict[str, Dict[str, int]] = {}
        groups: List[List[str]] = []
        n_kernels = 0
        backend_used = "reference"
        seg_summaries = []
        for seg, c in zip(segments, compiled_segs):
            r = c.record
            pass_trace.extend(r.pass_trace)
            block_backends.update(r.block_backends)
            block_fallbacks.update(r.block_fallbacks)
            tilings.update(r.tilings)
            groups.extend(r.groups)
            n_kernels += r.n_kernels
            if r.backend == "cuda" or (r.backend == "torch"
                                       and backend_used != "cuda"):
                backend_used = r.backend
            # the segment's kernel launches a call: its units on cuda
            n_cuda = (r.n_kernels - sum(1 for b in r.block_backends.values() if b != "cuda")
                      if r.backend == "cuda" else 0)
            seg_summaries.append({
                "name": seg.program.entry.name, "key": r.key,
                "backend": r.backend, "n_kernels": r.n_kernels, "n_cuda": n_cuda,
                "cache_hit": r.cache_hit, "disk_hit": r.disk_hit,
                "decision_source": r.decision_source,
            })
        pass_trace.append(("partition", {"mesh": list(shape), "axis": axis},
                           plan.report(scale_compute=False)))
        mesh_info = {
            "shape": list(shape), "axis": axis, "n_devices": n,
            "seed": plan.seed, "splits": plan.splits(),
            "collectives": [c.to_json() for c in plan.collectives],
            "collective_bytes": plan.collective_bytes(),
            "comm_s": plan.comm_s, "compute_s": plan.compute_s,
            "overlapped": [c.buffer for c in plan.collectives if c.overlap],
            "segments": seg_summaries,
        }
        record = CompileRecord(
            key=key, backend=backend_used, hw_name=hw.name,
            cache_hit=False, disk_hit=False,
            compile_time_s=time.perf_counter() - t0,
            tilings=tilings, pass_trace=pass_trace,
            n_kernels=n_kernels, groups=groups,
            block_backends=block_backends, block_fallbacks=block_fallbacks,
            profiled=bool(profile), ir_fingerprint=ir_fp,
            hw_fingerprint=hw_fp,
            decision_source=("tuned" if any(
                s["decision_source"] == "tuned" for s in seg_summaries)
                else "analytic"),
            mesh=mesh_info,
        )
        if profile:
            record.predicted_latency_s = {"<program>": plan.cost_s}
            fn = _attach_profiling(
                _Lowered(fn, backend_used), record, cache,
                tune_db=tune_db, requested_backend=backend)
        compiled = CompiledProgram(prog, fn, hw, record)
        if tune_db is None:
            cache.put_memory(key, compiled)
        if use_disk:
            cache.put_disk(key, {
                "mesh": mesh_info, "tilings": tilings,
                "hw": hw.name, "backend": backend_used,
                "compile_time_s": record.compile_time_s,
                "n_kernels": n_kernels, "groups": groups,
                "segments": seg_summaries,
            })
        csp.set(cache="miss", backend_used=backend_used,
                n_segments=len(segments),
                collective_bytes=mesh_info["collective_bytes"])
        return compiled


def compile_with_tilings(fn_or_contraction: Union[Program, TileProgram, str, Callable],
                         hw: HardwareConfig,
                         tilings: Mapping[str, Mapping[str, int]],
                         backend: str = "cuda", *,
                         tensors: Optional[Mapping[str, Tuple]] = None,
                         out: Optional[str] = None,
                         ranges: Optional[Mapping[str, int]] = None) -> CompiledProgram:
    """Compile with a **fixed tiling assignment** — no cache, no search.

    ``tilings`` uses the tiling-oracle key form (``"<block>#<fp16>"`` ->
    {var: tile}); blocks absent from it fall back to the analytic search.
    This is the explore measure-mode's candidate-replay entry: a sweep
    candidate's tilings are forced through the pass pipeline on the
    *base* config so the only thing that differs between measured
    candidates is the tiling (and the backend), never the model."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    t0 = time.perf_counter()
    prog = _as_program(fn_or_contraction, tensors=tensors, out=out, ranges=ranges)
    ir_fp = ir_fingerprint(prog)
    oracle = TilingOracle(known=tilings)
    pm = PassManager(hw, oracle=oracle)
    opt = pm.run(copy.deepcopy(prog))
    low = _lower(opt, backend, hw, quarantine=None, key="")
    record = CompileRecord(
        key="", backend=low.backend, hw_name=hw.name,
        compile_time_s=time.perf_counter() - t0,
        tilings=dict(oracle.chosen), pass_trace=list(pm.trace),
        fallback_reason=low.fallback, n_kernels=low.n_kernels,
        groups=low.groups,
        block_backends=low.block_backends, block_fallbacks=low.block_fallbacks,
        ir_fingerprint=ir_fp, hw_fingerprint=hw.fingerprint(), decision_source="replay",
    )
    return CompiledProgram(opt, low.fn, hw, record)
