"""Two-level compilation cache.

Stripe's pitch is that *compilation* is the unit of reuse, which only
works if compiling is cheap enough for the serving hot path.  Following
Tensor Comprehensions' compilation-cache design, this module provides:

* an **in-memory LRU** holding live compiled artifacts (optimized
  programs, lowered callables) keyed by a content hash, and
* an **on-disk store** (``$STRIPE_CACHE_DIR`` or ``~/.cache/stripe-repro``)
  persisting the JSON-serializable part of a compile — chosen tilings and
  the pass trace — across processes, so a warm process skips the autotile
  search entirely.

Keys are content hashes (sha256 over a canonical JSON form), never object
identities, so equal programs hash equal across processes.  Disk entries
are versioned and self-identifying; corrupt or stale entries are deleted
and treated as misses.  All levels expose hit/miss/evict statistics.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Callable, Dict, Optional

from ..obs import metrics as obs_metrics
from ..reliability import faults

# v2: tiling-oracle entries are keyed by block name + group fingerprint
# (fusion-group tilings replay as a unit); v1 name-keyed payloads are
# invalidated wholesale by the version bump.
# v3: pass traces carry the memory-planner arenas (arena/arena_bump,
# wavefront levels) and pipelined per-block latencies — pre-planner
# payloads would score on the legacy model, so they are invalidated.
# v4: the roofline model charges halo materialization/refetch traffic
# (TileCost.halo_bytes), so tilings chosen for halo-windowed blocks
# under v3 can differ; payloads also carry per-unit hybrid backends.
# v5: measured-feedback autotuning — compile keys additionally fold in
# the tuned-entry candidate id and the active cost-model calibration
# fingerprint (tuned/calibrated artifacts must never collide with
# analytic ones), and payloads record the decision source.
CACHE_VERSION = 5

# Compile keys of this package carry this tag next to CACHE_VERSION and
# the driver version, so it never shares an artifact with the JAX package
# under one STRIPE_CACHE_DIR (same IR, different lowering).
PORT_TAG = "repro_torch"

ENV_CACHE_DIR = "STRIPE_CACHE_DIR"
ENV_CACHE_DISABLE = "STRIPE_CACHE_DISABLE"


# --------------------------------------------------------------------------
# Content hashing
# --------------------------------------------------------------------------
def stable_json(obj: Any) -> str:
    """Deterministic JSON: sorted keys, no whitespace, tuples as lists.
    Non-JSON values fall back to ``str()`` (hashing, not round-tripping)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"), default=str)


def stable_hash(obj: Any) -> str:
    return hashlib.sha256(stable_json(obj).encode()).hexdigest()


def content_key(*parts: Any) -> str:
    """Cache key from heterogeneous parts (fingerprints, params, names)."""
    return stable_hash(list(parts))


def default_cache_dir() -> Path:
    env = os.environ.get(ENV_CACHE_DIR)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "stripe-repro"


# --------------------------------------------------------------------------
# Stats
# --------------------------------------------------------------------------
class CacheStats:
    """Cache hit/miss/eviction statistics, backed by an
    :class:`repro_torch.obs.metrics.Registry`.

    Keeps the original dataclass-of-ints surface (``stats.hits += 1``,
    ``as_dict()``) so every existing call site and test works unchanged,
    while each field is a ``cache.<field>`` counter series in a
    per-instance registry (``stats.registry.snapshot()``).  Increments
    are additionally mirrored into the process-default registry, so a
    global ``obs.metrics.snapshot()`` sees cumulative cache traffic
    across every cache in the process.
    """

    FIELDS = (
        "hits", "misses", "evictions", "puts",
        "disk_hits", "disk_misses", "disk_errors", "disk_puts",
        # negative-cache (quarantine) traffic: failures recorded, lookups
        # served degraded because an embargo was active, embargo expiries
        # (retry allowed again), and successful recoveries
        "quarantined", "quarantine_hits", "quarantine_expiries",
        "quarantine_clears",
        # measured-feedback tuning DB consultations by the driver: a hit
        # replays a measured-best tiling (decision source "tuned"), a
        # miss falls through to the analytic autotile search
        "tuned_hits", "tuned_misses",
    )

    def __init__(self, registry: Optional["obs_metrics.Registry"] = None, **initial):
        reg = registry if registry is not None else obs_metrics.Registry()
        object.__setattr__(self, "registry", reg)
        object.__setattr__(self, "_counters",
                           {f: reg.counter(f"cache.{f}") for f in self.FIELDS})
        for k, v in initial.items():
            setattr(self, k, v)

    def __getattr__(self, name):
        counters = self.__dict__.get("_counters") or {}
        if name in counters:
            return int(counters[name].value)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        counters = self.__dict__.get("_counters")
        if counters is not None and name in counters:
            delta = int(value) - int(counters[name].value)
            counters[name].set(int(value))
            if delta:
                obs_metrics.counter(f"cache.{name}").inc(delta)
            return
        object.__setattr__(self, name, value)

    def as_dict(self) -> Dict[str, int]:
        return {f: int(self._counters[f].value) for f in self.FIELDS}

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v}" for k, v in self.as_dict().items())
        return f"CacheStats({inner})"


# --------------------------------------------------------------------------
# Compile-failure quarantine (negative cache with exponential backoff)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class QuarantineEntry:
    """One quarantined compile key: why it failed, how often, and until
    when re-attempts are embargoed (``time.monotonic`` deadline)."""

    key: str
    reason: str
    fail_count: int
    backoff_s: float
    until: float
    expired: bool = False  # the embargo lapsed; a retry is permitted

    def as_dict(self) -> Dict[str, Any]:
        return {"key": self.key, "reason": self.reason,
                "fail_count": self.fail_count,
                "backoff_s": round(self.backoff_s, 4),
                "expired": self.expired}


class QuarantineStore:
    """Negative cache over compile keys: a (program, config) point whose
    compile crashed is embargoed with exponential backoff so the serving
    hot path does not re-attempt it every step; while embargoed, lookups
    take the degraded (jnp fallback) path.  Expiry permits exactly one
    retry: success clears the entry, failure doubles the backoff."""

    def __init__(self, base_backoff_s: float = 0.5, max_backoff_s: float = 30.0,
                 stats: Optional[CacheStats] = None):
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.stats = stats if stats is not None else CacheStats()
        self._entries: Dict[str, QuarantineEntry] = {}

    def record_failure(self, key: str, reason: str) -> QuarantineEntry:
        prev = self._entries.get(key)
        backoff = (min(prev.backoff_s * 2.0, self.max_backoff_s)
                   if prev is not None else self.base_backoff_s)
        entry = QuarantineEntry(
            key=key, reason=str(reason)[:500],
            fail_count=(prev.fail_count + 1 if prev is not None else 1),
            backoff_s=backoff, until=time.monotonic() + backoff)
        self._entries[key] = entry
        self.stats.quarantined += 1
        return entry

    def active(self, key: str) -> bool:
        """True while the embargo holds.  The first observation after the
        deadline counts as an expiry (a retry is now permitted) and
        returns False — the entry stays, so a failed retry doubles the
        backoff instead of starting over."""
        entry = self._entries.get(key)
        if entry is None:
            return False
        if time.monotonic() < entry.until:
            self.stats.quarantine_hits += 1
            return True
        if not entry.expired:
            entry.expired = True
            self.stats.quarantine_expiries += 1
        return False

    def get(self, key: str) -> Optional[QuarantineEntry]:
        return self._entries.get(key)

    def clear(self, key: str) -> bool:
        if key in self._entries:
            del self._entries[key]
            self.stats.quarantine_clears += 1
            return True
        return False

    def entries(self) -> Dict[str, QuarantineEntry]:
        return dict(self._entries)


# --------------------------------------------------------------------------
# The cache
# --------------------------------------------------------------------------
class CompilationCache:
    """In-memory LRU of live objects + on-disk JSON artifact store.

    The two levels hold different things: memory holds whatever the caller
    puts (typically a ``CompiledProgram``); disk holds only the JSON
    ``payload`` passed to :meth:`put` (typically tilings + pass trace).
    ``get`` consults memory first, then disk, and reports which level hit
    by type: a disk hit returns the payload dict, a memory hit the live
    object.
    """

    def __init__(self, capacity: int = 128, disk_dir: Optional[os.PathLike] = None,
                 use_disk: bool = True):
        self.capacity = int(capacity)
        self.stats = CacheStats()
        self._mem: "OrderedDict[str, Any]" = OrderedDict()
        if os.environ.get(ENV_CACHE_DISABLE):
            use_disk = False
        self.disk_dir: Optional[Path] = None
        if use_disk:
            self.disk_dir = Path(disk_dir) if disk_dir is not None else default_cache_dir()
        # negative cache for crashed compiles (driver + serving engine);
        # shares this cache's stats so quarantine traffic shows up in
        # cache_stats() next to hit/miss counts
        self.quarantine = QuarantineStore(stats=self.stats)

    # ------------------------------------------------------------- memory
    def get_memory(self, key: str) -> Any:
        if key in self._mem:
            self._mem.move_to_end(key)
            self.stats.hits += 1
            return self._mem[key]
        self.stats.misses += 1
        return None

    def put_memory(self, key: str, value: Any) -> None:
        self._mem[key] = value
        self._mem.move_to_end(key)
        self.stats.puts += 1
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)
            self.stats.evictions += 1

    # --------------------------------------------------------------- disk
    def _path(self, key: str) -> Optional[Path]:
        if self.disk_dir is None:
            return None
        return self.disk_dir / f"{key}.json"

    def get_disk(self, key: str) -> Optional[Dict[str, Any]]:
        path = self._path(key)
        if path is None:
            return None
        try:
            faults.check("cache.disk_read", key=key)
            raw = path.read_text()
        except faults.InjectedFault:
            # injected I/O failure: degrade to a miss, never propagate
            self.stats.disk_errors += 1
            return None
        except OSError:
            self.stats.disk_misses += 1
            return None
        try:
            entry = json.loads(raw)
            if not isinstance(entry, dict):
                raise ValueError("entry is not an object")
            if entry.get("version") != CACHE_VERSION or entry.get("key") != key:
                raise ValueError("stale or mismatched entry")
            payload = entry["payload"]
        except (ValueError, KeyError, TypeError):
            # corrupt/stale on-disk entry: delete it, treat as a miss
            self.stats.disk_errors += 1
            try:
                path.unlink()
            except OSError:
                pass
            return None
        self.stats.disk_hits += 1
        return payload

    def put_disk(self, key: str, payload: Dict[str, Any]) -> None:
        path = self._path(key)
        if path is None:
            return
        entry = {"version": CACHE_VERSION, "key": key, "payload": payload}
        try:
            data = json.dumps(entry, sort_keys=True)
        except (TypeError, ValueError):
            self.stats.disk_errors += 1
            return
        if faults.fires("cache.disk_write_torn", key=key):
            # simulate the torn write a non-atomic writer (or a crash mid
            # flush) would leave: a truncated entry at the final path.  The
            # read side must recover it as a miss (corrupt-entry deletion).
            try:
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(data[: max(1, len(data) // 2)])
            except OSError:
                pass
            self.stats.disk_errors += 1
            return
        try:
            faults.check("cache.disk_write", key=key)
            path.parent.mkdir(parents=True, exist_ok=True)
            # atomic publish: write the full entry to a temp file in the
            # same directory, then os.replace() — no reader ever sees a
            # half-written entry, regardless of where the writer dies
            fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(data)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except faults.InjectedFault:
            # injected write failure: the entry is simply lost (next read
            # is a miss); the caller never sees the error
            self.stats.disk_errors += 1
            return
        except OSError:
            self.stats.disk_errors += 1
            return
        self.stats.disk_puts += 1

    # ----------------------------------------------------------- combined
    def get(self, key: str) -> Any:
        """Memory first, then disk.  A memory hit returns the live object;
        a disk hit returns the JSON payload dict."""
        val = self.get_memory(key)
        if val is not None:
            return val
        return self.get_disk(key)

    def put(self, key: str, value: Any, payload: Optional[Dict[str, Any]] = None) -> None:
        self.put_memory(key, value)
        if payload is not None:
            self.put_disk(key, payload)

    def clear(self, memory: bool = True, disk: bool = False) -> None:
        if memory:
            self._mem.clear()
        if disk and self.disk_dir is not None and self.disk_dir.exists():
            for p in self.disk_dir.glob("*.json"):
                try:
                    p.unlink()
                except OSError:
                    pass

    def __len__(self) -> int:
        return len(self._mem)


# --------------------------------------------------------------------------
# Process-wide default cache
# --------------------------------------------------------------------------
_DEFAULT: Optional[CompilationCache] = None


def get_default_cache() -> CompilationCache:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = CompilationCache()
    return _DEFAULT


def set_default_cache(cache: Optional[CompilationCache]) -> None:
    global _DEFAULT
    _DEFAULT = cache


def memoize(kind: str, parts: Any, compute: Callable[[], Any],
            cache: Optional[CompilationCache] = None) -> Any:
    """Memoize a JSON-serializable decision (e.g. a kernel block-size
    choice) through both cache levels, keyed by content."""
    c = cache if cache is not None else get_default_cache()
    key = content_key("memo", kind, parts)
    hit = c.get(key)
    if isinstance(hit, dict) and "value" in hit:
        return hit["value"]
    value = compute()
    c.put(key, {"value": value}, payload={"value": value})
    return value
