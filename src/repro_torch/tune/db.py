"""The measured-feedback tuning database.

A persistent store layered over the compilation cache's disk directory,
keyed by **IR fingerprint x hardware fingerprint x backend x
interpret-mode** — exactly the identity ``stripe_jit`` compiles under —
recording *measured* latencies for candidate tilings (and per-unit
backend choices) so the driver can replay the measured winner instead of
trusting the analytic cost model.  Following Tensor Comprehensions'
autotuner cache: every measurement ever taken is kept (deduped by
candidate content), and the best survives as the entry's ``best``.

One JSON file (``tuning_db.json``) holds the whole database:

    {"version": 1,
     "entries": {<key>: {"ir_fingerprint": ..., "hw_fingerprint": ...,
                         "backend": "cuda", "interpret": false,
                         "workload": "mm_bias_gelu", "updated_ts": ...,
                         "candidates": {<cid>: {"tilings": {...},
                                                "block_backends": {...},
                                                "measured_s": 1.2e-3,
                                                "predicted_s": 8.0e-6,
                                                "rounds": 4, "calls": 2,
                                                "source": "explore.measure",
                                                "ts": ...}},
                         "best": <cid>}},
     "residual_summaries": {<skey>: {"hw_fingerprint": ..., "backend": ...,
                                     "interpret": ..., "rows": n,
                                     "pairs": k, "sum_log_ratio": x}}}

``interpret`` is true for a measurement of the kernels' plain versions
(every tensor of the timed calls on the CPU) and false for one taken on
the card, so a CPU timing is never replayed for the card.  The schema,
``entry_key`` and ``candidate_id`` are the JAX package's, byte for byte:
either package reads the other's database.

``residual_summaries`` receives rows compacted out of the profiling
residual log (``obs.profile.append_residuals`` rotation), so the
combined measured/predicted bias survives log rotation.

Durability: writes go through read-merge-write under an ``fcntl.flock``
file lock (cross-process) plus a thread lock (in-process), published
atomically via tempfile + ``os.replace``.  The write path honors the
``cache.disk_write_torn`` fault site exactly like ``cache.put_disk``, so
the fault-injection tests can force a torn final file; the read side
recovers a corrupt database by moving it aside and starting empty —
a broken DB must never fail a compile.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

from ..core.cache import content_key, default_cache_dir, stable_hash
from ..reliability import faults

DB_VERSION = 1
DB_NAME = "tuning_db.json"

try:
    import fcntl
except ImportError:  # non-POSIX: atomic replace alone is the guarantee
    fcntl = None


def entry_key(ir_fingerprint: str, hw_fingerprint: str, backend: str,
              interpret: bool) -> str:
    """The DB key of one (program, hardware, backend, interpret) point."""
    return content_key("tune-entry", ir_fingerprint, hw_fingerprint,
                       str(backend), bool(interpret))


def candidate_id(tilings: Mapping[str, Mapping[str, int]],
                 block_backends: Optional[Mapping[str, str]] = None) -> str:
    """Content id of one candidate: the tiling assignment plus any
    per-unit backend overrides.  Doubles as the tuned-artifact cache-key
    component — a better measurement changes the id, which re-keys (and
    therefore recompiles) the tuned artifact."""
    return stable_hash([
        {k: dict(v) for k, v in sorted(tilings.items())},
        dict(sorted((block_backends or {}).items())),
    ])[:16]


@dataclasses.dataclass
class TunedEntry:
    """The measured-best candidate ``TuningDB.lookup`` serves back."""

    tilings: Dict[str, Dict[str, int]]
    block_backends: Dict[str, str]
    measured_s: float
    predicted_s: Optional[float]
    source: str
    rounds: int
    ts: float
    workload: str
    candidate_id: str
    n_candidates: int = 1

    @property
    def fingerprint(self) -> str:
        """What the driver folds into the compile cache key."""
        return self.candidate_id

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class TuningDB:
    """The persistent tuning database (one JSON file, see module doc).

    ``dir`` defaults to the process cache directory
    (``$STRIPE_CACHE_DIR`` or ``~/.cache/stripe-repro``) so the DB lives
    next to the disk compilation cache it feeds.  ``max_age_s`` bounds
    candidate freshness: ``lookup`` ignores measurements older than it
    (None = measurements never expire).
    """

    def __init__(self, dir: Optional[os.PathLike] = None, name: str = DB_NAME,
                 max_age_s: Optional[float] = None):
        self.dir = Path(dir) if dir is not None else default_cache_dir()
        self.path = self.dir / name
        self.max_age_s = max_age_s
        self.recovered = 0      # corrupt-file recoveries observed by loads
        self.write_errors = 0   # swallowed write failures (incl. injected)
        self._lock = threading.Lock()

    # ----------------------------------------------------------------- io
    @contextlib.contextmanager
    def _file_lock(self):
        """Cross-process exclusive lock for read-merge-write cycles.
        Lock-file failures degrade to lockless atomic-replace (last
        writer wins) — durability hiccups never break recording."""
        if fcntl is None:
            yield
            return
        lock_path = self.path.with_suffix(".lock")
        try:
            lock_path.parent.mkdir(parents=True, exist_ok=True)
            f = open(lock_path, "w")
        except OSError:
            yield
            return
        try:
            fcntl.flock(f, fcntl.LOCK_EX)
            yield
        finally:
            try:
                fcntl.flock(f, fcntl.LOCK_UN)
            finally:
                f.close()

    def _empty(self) -> Dict[str, Any]:
        return {"version": DB_VERSION, "entries": {}, "residual_summaries": {}}

    def load(self) -> Dict[str, Any]:
        """The whole database document; a corrupt or torn file is moved
        aside (``<name>.corrupt``) and replaced by an empty DB — the
        reader recovers, never raises."""
        try:
            raw = self.path.read_text()
        except OSError:
            return self._empty()
        try:
            doc = json.loads(raw)
            if not isinstance(doc, dict) or "entries" not in doc:
                raise ValueError("not a tuning DB document")
        except ValueError:
            self.recovered += 1
            try:
                os.replace(self.path, self.path.with_suffix(".corrupt"))
            except OSError:
                pass
            return self._empty()
        if doc.get("version") != DB_VERSION:
            # incompatible schema: start fresh (the next write replaces it)
            return self._empty()
        doc.setdefault("entries", {})
        doc.setdefault("residual_summaries", {})
        return doc

    def _store(self, doc: Dict[str, Any]) -> bool:
        try:
            data = json.dumps(doc, sort_keys=True)
        except (TypeError, ValueError):
            self.write_errors += 1
            return False
        if faults.fires("cache.disk_write_torn", key=str(self.path)):
            # same torn-write semantics as cache.put_disk: a truncated
            # document lands at the final path; load() must recover it
            try:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                self.path.write_text(data[: max(1, len(data) // 2)])
            except OSError:
                pass
            self.write_errors += 1
            return False
        try:
            faults.check("cache.disk_write", key=str(self.path))
            self.path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=str(self.path.parent), suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(data)
                os.replace(tmp, self.path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except (faults.InjectedFault, OSError):
            self.write_errors += 1
            return False
        return True

    # ------------------------------------------------------------- record
    def record(self, ir_fingerprint: str, hw_fingerprint: str, backend: str,
               interpret: bool, *, tilings: Mapping[str, Mapping[str, int]],
               measured_s: float, predicted_s: Optional[float] = None,
               block_backends: Optional[Mapping[str, str]] = None,
               rounds: int = 1, calls: int = 1, source: str = "",
               workload: str = "") -> str:
        """Record one measurement; returns the candidate id.  Re-measuring
        a known candidate keeps the *minimum* (the noise-robust
        estimator, matching the interleaved-rounds harness)."""
        key = entry_key(ir_fingerprint, hw_fingerprint, backend, interpret)
        cid = candidate_id(tilings, block_backends)
        cand = {
            "tilings": {k: {v: int(t) for v, t in tv.items()}
                        for k, tv in tilings.items()},
            "block_backends": dict(block_backends or {}),
            "measured_s": float(measured_s),
            "predicted_s": (float(predicted_s) if predicted_s is not None
                            else None),
            "rounds": int(rounds), "calls": int(calls),
            "source": str(source), "ts": time.time(),
        }
        with self._lock, self._file_lock():
            doc = self.load()
            entry = doc["entries"].setdefault(key, {
                "ir_fingerprint": ir_fingerprint,
                "hw_fingerprint": hw_fingerprint,
                "backend": str(backend), "interpret": bool(interpret),
                "workload": str(workload), "candidates": {}, "best": None,
            })
            if workload and not entry.get("workload"):
                entry["workload"] = str(workload)
            prev = entry["candidates"].get(cid)
            if prev is not None and prev.get("measured_s", float("inf")) <= cand["measured_s"]:
                prev["ts"] = cand["ts"]  # refresh, keep the better minimum
                prev["rounds"] = max(int(prev.get("rounds", 1)), cand["rounds"])
            else:
                entry["candidates"][cid] = cand
            entry["best"] = min(
                entry["candidates"],
                key=lambda c: entry["candidates"][c].get("measured_s", float("inf")))
            entry["updated_ts"] = time.time()
            self._store(doc)
        return cid

    # ------------------------------------------------------------- lookup
    def lookup(self, ir_fingerprint: str, hw_fingerprint: str, backend: str,
               interpret: bool,
               max_age_s: Optional[float] = None) -> Optional[TunedEntry]:
        """The measured-best fresh candidate for one compile identity, or
        None (no entry, or everything staler than the freshness bound)."""
        age_cap = max_age_s if max_age_s is not None else self.max_age_s
        key = entry_key(ir_fingerprint, hw_fingerprint, backend, interpret)
        entry = self.load()["entries"].get(key)
        if not entry:
            return None
        now = time.time()
        fresh = {cid: c for cid, c in entry.get("candidates", {}).items()
                 if isinstance(c, dict) and c.get("measured_s") is not None
                 and (age_cap is None or now - float(c.get("ts", 0)) <= age_cap)}
        if not fresh:
            return None
        cid = min(fresh, key=lambda c: float(fresh[c]["measured_s"]))
        c = fresh[cid]
        return TunedEntry(
            tilings={k: {v: int(t) for v, t in tv.items()}
                     for k, tv in c.get("tilings", {}).items()},
            block_backends=dict(c.get("block_backends", {})),
            measured_s=float(c["measured_s"]),
            predicted_s=c.get("predicted_s"),
            source=str(c.get("source", "")), rounds=int(c.get("rounds", 1)),
            ts=float(c.get("ts", 0.0)), workload=str(entry.get("workload", "")),
            candidate_id=cid, n_candidates=len(entry.get("candidates", {})))

    def entries(self) -> Dict[str, Dict[str, Any]]:
        return dict(self.load()["entries"])

    def __len__(self) -> int:
        return len(self.load()["entries"])

    # -------------------------------------------- residual-log compaction
    def fold_residuals(self, rows: List[Dict[str, Any]]) -> int:
        """Fold rotated-out residual rows into per-(hw, backend,
        interpret) running summaries, so the combined bias statistics
        survive log rotation.  Returns the number of rows folded."""
        import math

        if not rows:
            return 0
        agg: Dict[str, Dict[str, Any]] = {}
        for r in rows:
            if not isinstance(r, dict):
                continue
            hw_fp = str(r.get("hw_fingerprint", ""))
            backend = str(r.get("backend", ""))
            interp = bool(r.get("interpret", False))
            skey = content_key("residual-summary", hw_fp, backend, interp)
            s = agg.setdefault(skey, {
                "hw_fingerprint": hw_fp, "backend": backend,
                "interpret": interp, "rows": 0, "pairs": 0,
                "sum_log_ratio": 0.0,
            })
            s["rows"] += 1
            p, m = r.get("predicted_s"), r.get("measured_s")
            if p and m and p > 0 and m > 0:
                s["pairs"] += 1
                s["sum_log_ratio"] += math.log(m / p)
        folded = sum(s["rows"] for s in agg.values())
        with self._lock, self._file_lock():
            doc = self.load()
            sums = doc["residual_summaries"]
            for skey, s in agg.items():
                prev = sums.get(skey)
                if prev is not None:
                    s["rows"] += int(prev.get("rows", 0))
                    s["pairs"] += int(prev.get("pairs", 0))
                    s["sum_log_ratio"] += float(prev.get("sum_log_ratio", 0.0))
                sums[skey] = s
            self._store(doc)
        return folded

    def residual_summaries(self) -> List[Dict[str, Any]]:
        return list(self.load()["residual_summaries"].values())
