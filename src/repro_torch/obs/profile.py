"""Kernel profiling support: cost-model residual logging.

``stripe_jit(..., profile=True)`` wall-times every lowered unit (a
fusion group's CUDA kernels, a torch fallback group, or the whole
program for the reference interpreter) on dispatch and attaches the
measurements to the :class:`~repro_torch.core.driver.CompileRecord` next to
the cost model's predicted per-unit latencies.  On the first warm profiled
dispatch (on the card, the second: ``driver._attach_profiling``) the
(predicted, measured) pairs are appended — one JSON object
per line — to a **residual log** under the compilation-cache directory:

    {"ir_fingerprint": ..., "hw_fingerprint": ..., "block": "a+b",
     "predicted_s": 1.2e-5, "measured_s": 3.4e-5, "backend": "cuda",
     "interpret": false, "hw": "h100", "key": ..., "ts": ...}

``interpret`` is true when the kernels' plain versions ran (no tensor of
the call on the card), the twin of the JAX package's Pallas interpret
mode: such a row times the host, never the card.

This file is the feed for the measured-feedback tuning database: rows are keyed by IR fingerprint x hardware
fingerprint, exactly the identity the compilation cache already uses, so
accumulated (predicted, measured) pairs can calibrate the roofline /
pipeline model coefficients per hardware config.

Helpers here are import-light (no jax, no core imports at module level)
so ``repro_torch.obs`` stays dependency-free.
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

RESIDUAL_LOG_NAME = "residuals.jsonl"

# Rotation: the log is compacted once it exceeds this many rows (the
# newest half is kept; older rows fold into the tuning DB's running
# residual summaries, so long-run bias statistics survive rotation).
ENV_RESIDUAL_CAP = "STRIPE_RESIDUAL_CAP"
DEFAULT_RESIDUAL_CAP = 20_000

_write_lock = threading.Lock()


def residual_cap() -> int:
    """The configured rotation cap (rows); <= 0 disables rotation."""
    try:
        return int(os.environ.get(ENV_RESIDUAL_CAP, DEFAULT_RESIDUAL_CAP))
    except ValueError:
        return DEFAULT_RESIDUAL_CAP


def residual_log_path(cache=None) -> Path:
    """Where profiled compiles append residual rows: the cache's disk
    directory when it has one, else the process default cache dir."""
    from ..core.cache import default_cache_dir

    disk_dir = getattr(cache, "disk_dir", None)
    base = Path(disk_dir) if disk_dir is not None else default_cache_dir()
    return base / RESIDUAL_LOG_NAME


def append_residuals(rows: List[Dict[str, Any]], path=None,
                     cap: Optional[int] = None, db=None) -> Optional[Path]:
    """Append rows to the residual JSONL (atomic at line granularity:
    one ``write`` of the whole batch under a process-wide lock).  I/O
    failures are swallowed — profiling must never fail the dispatch.

    Growth is bounded: past ``cap`` rows (``$STRIPE_RESIDUAL_CAP``,
    default 20k; <= 0 disables) the log rotates — the newest ``cap // 2``
    rows are kept and the older ones fold into the tuning DB next to the
    log (``db`` overrides which DB; None opens ``tuning_db.json`` in the
    log's directory), so ``python -m repro_torch.obs residuals`` still
    reports the full history via the DB's running summaries."""
    if not rows:
        return None
    p = Path(path) if path is not None else residual_log_path()
    data = "".join(json.dumps(r, sort_keys=True) + "\n" for r in rows)
    limit = residual_cap() if cap is None else int(cap)
    try:
        with _write_lock:
            p.parent.mkdir(parents=True, exist_ok=True)
            with open(p, "a") as f:
                f.write(data)
            if limit > 0:
                _rotate_locked(p, limit, db)
    except OSError:
        return None
    return p


def _rotate_locked(p: Path, cap: int, db=None) -> None:
    """Compact the log in place once it exceeds ``cap`` rows (caller
    holds the write lock).  Never raises."""
    try:
        with open(p) as f:
            lines = [ln for ln in f if ln.strip()]
    except OSError:
        return
    if len(lines) <= cap:
        return
    keep = lines[-max(cap // 2, 1):]
    fold = lines[: len(lines) - len(keep)]
    try:
        if db is None:
            from ..tune.db import TuningDB

            db = TuningDB(dir=p.parent)
        folded_rows = []
        for ln in fold:
            try:
                folded_rows.append(json.loads(ln))
            except ValueError:
                continue
        db.fold_residuals(folded_rows)
    except Exception:
        # compaction must never fail profiling; the rows are still
        # dropped below so the log stays bounded either way
        pass
    try:
        import tempfile

        fd, tmp = tempfile.mkstemp(dir=str(p.parent), suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            f.writelines(keep)
        os.replace(tmp, p)
    except OSError:
        pass


def read_residuals(path=None) -> List[Dict[str, Any]]:
    """Load the residual log (skipping unparseable lines, e.g. a torn
    final line after a crash)."""
    p = Path(path) if path is not None else residual_log_path()
    rows: List[Dict[str, Any]] = []
    try:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        return []
    return rows


def summarize_residuals(rows: List[Dict[str, Any]],
                        folded: Optional[List[Dict[str, Any]]] = None) -> Dict[str, Any]:
    """Aggregate residual rows: count, per-backend counts, and the
    geometric-mean ratio measured/predicted where both are present (the
    cost model's systematic bias on this hardware).

    ``folded`` takes the tuning DB's running residual summaries (rows
    rotated out of the log by :func:`append_residuals`); their pair
    counts and summed log ratios merge into the live rows' statistics so
    the reported bias covers the full history, not just the log tail."""
    import math

    n = len(rows)
    backends: Dict[str, int] = {}
    log_sum = 0.0
    pairs = 0
    for r in rows:
        backends[str(r.get("backend"))] = backends.get(str(r.get("backend")), 0) + 1
        p, m = r.get("predicted_s"), r.get("measured_s")
        if p and m and p > 0 and m > 0:
            log_sum += math.log(m / p)
            pairs += 1
    folded_rows = 0
    folded_pairs = 0
    for s in folded or []:
        folded_rows += int(s.get("rows", 0))
        fp = int(s.get("pairs", 0))
        folded_pairs += fp
        log_sum += float(s.get("sum_log_ratio", 0.0))
        b = str(s.get("backend"))
        backends[b] = backends.get(b, 0) + int(s.get("rows", 0))
    total_pairs = pairs + folded_pairs
    gmean = math.exp(log_sum / total_pairs) if total_pairs else None
    return {
        "rows": n + folded_rows,
        "live_rows": n,
        "folded_rows": folded_rows,
        "by_backend": dict(sorted(backends.items())),
        "pairs_with_prediction": total_pairs,
        "measured_over_predicted_gmean": gmean,
    }


_TERM_KEYS = ("latency_s", "t_mem", "t_compute", "t_mem_raw", "t_compute_raw")


def predicted_unit_terms(opt_program, pass_trace) -> Dict[str, Dict[str, Any]]:
    """Per-lowering-unit predicted cost terms from the pass trace.

    The autotile pass reports one analytic record per optimized block
    (``latency_s`` = the pipelined roofline estimate, plus the raw and
    calibrated roofline terms).  Lowering units are keyed by their
    "+"-joined *semantic* member names (the hybrid composer's unit
    naming), so each autotile record is attributed to the unit whose
    member set covers the record's block; records that match no unit
    (e.g. blocks the later passes restructure) keep their own block
    name.  Terms are summed per unit; ``calibrated`` is true when any
    contributing record was scored with an active calibration."""
    from ..core.ir import Block
    from ..core.passes.fuse import members_of

    units: List[tuple] = []  # (unit_name, member set)
    seen = set()
    for s in opt_program.entry.stmts:
        if not isinstance(s, Block):
            continue
        members = members_of(s)
        key = tuple(members)
        if key not in seen:
            seen.add(key)
            units.append(("+".join(members), set(members)))

    entries: List[Dict[str, Any]] = []
    for entry in pass_trace:
        if entry and entry[0] == "autotile" and len(entry) > 2:
            entries = [e for e in entry[2] if isinstance(e, dict) and "block" in e]
            break

    terms: Dict[str, Dict[str, Any]] = {}
    for e in entries:
        bases = {p.split(".")[0] for p in str(e["block"]).split("+")}
        uname = str(e["block"])
        for name, members in units:
            if bases & members:
                uname = name
                break
        t = terms.setdefault(uname, {k: 0.0 for k in _TERM_KEYS})
        for k in _TERM_KEYS:
            t[k] += float(e.get(k, 0.0) or 0.0)
        t["calibrated"] = bool(t.get("calibrated")) or bool(e.get("calibrated"))
    return terms


def predicted_unit_latencies(opt_program, pass_trace) -> Dict[str, float]:
    """Per-lowering-unit predicted latency from the pass trace (the
    ``latency_s`` slice of :func:`predicted_unit_terms`)."""
    return {u: t["latency_s"]
            for u, t in predicted_unit_terms(opt_program, pass_trace).items()}


def residual_rows(record, interpret: bool) -> List[Dict[str, Any]]:
    """Build residual-log rows from a profiled CompileRecord's
    (predicted, measured) per-unit latencies."""
    rows = []
    terms = getattr(record, "predicted_terms", None) or {}
    for unit, measured in sorted(record.measured_latency_s.items()):
        t = terms.get(unit) or {}
        rows.append({
            "ir_fingerprint": record.ir_fingerprint,
            "hw_fingerprint": record.hw_fingerprint,
            "hw": record.hw_name,
            "key": record.key,
            "block": unit,
            "backend": record.block_backends.get(unit, record.backend),
            "interpret": bool(interpret),
            "predicted_s": record.predicted_latency_s.get(unit),
            "measured_s": measured,
            # raw roofline terms feed the calibration fit; the flag marks
            # rows whose prediction already had a calibration applied
            "t_mem_raw": t.get("t_mem_raw"),
            "t_compute_raw": t.get("t_compute_raw"),
            "calibrated": bool(t.get("calibrated")),
            "ts": time.time(),
            "pid": os.getpid(),
        })
    return rows
