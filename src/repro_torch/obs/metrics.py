"""Metrics registry: labeled counters, gauges and histograms.

One :class:`Registry` holds a set of named series; a series is identified
by its metric name plus a sorted label set (``counter("serve.events",
event="finish")``), Prometheus-style.  Metric objects are created on
first use and cached, so hot paths hold a reference and pay one lock +
integer add per update.

``snapshot()`` renders the whole registry as a deterministic (sorted,
JSON-able) dict — the shape the CI artifact and the back-compat shims
(``CacheStats``, ``ServingEngine.metrics()``) read.

A process-wide default registry backs the module-level helpers
(``metrics.counter(...)``); subsystems that need isolated series (one
serving engine, one compilation cache) instantiate their own Registry.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def series_key(name: str, labels: Dict[str, Any]) -> str:
    """Printable series identity: ``name{k=v,...}`` with sorted labels."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic (by convention) cumulative count; ``set()`` exists for
    back-compat shims that assign totals directly."""

    __slots__ = ("_v", "_lock")

    def __init__(self, value: float = 0):
        self._v = value
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._v += n

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    @property
    def value(self):
        return self._v


class Gauge:
    """A point-in-time value (queue depth, free pages)."""

    __slots__ = ("_v", "_lock")

    def __init__(self, value: float = 0):
        self._v = value
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v


# log-scale histogram: bucket i covers (BASE**(i-1), BASE**i] seconds
# (or any unit), anchored so sub-microsecond observations land in bucket 0
_BASE = 2.0
_ANCHOR = 1e-6


class Histogram:
    """Log-scale histogram (base-2 buckets anchored at 1e-6): tracks
    count / sum / min / max exactly and percentiles to bucket resolution."""

    __slots__ = ("_lock", "count", "sum", "min", "max", "_buckets")

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: Dict[int, int] = {}

    @staticmethod
    def _bucket(v: float) -> int:
        if v <= _ANCHOR:
            return 0
        return max(0, int(math.ceil(math.log(v / _ANCHOR, _BASE))))

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            b = self._bucket(v)
            self._buckets[b] = self._buckets.get(b, 0) + 1

    @staticmethod
    def _quantile(buckets: Dict[int, int], count: int, hi: float, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile (0..1)."""
        if count == 0:
            return 0.0
        target = q * count
        seen = 0
        for b in sorted(buckets):
            seen += buckets[b]
            if seen >= target:
                return _ANCHOR * _BASE ** b
        return hi

    def percentile(self, q: float) -> float:
        with self._lock:
            return self._quantile(self._buckets, self.count, self.max, q)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            if self.count == 0:
                return {"count": 0, "sum": 0.0, "mean": 0.0,
                        "min": 0.0, "max": 0.0, "p50": 0.0, "p99": 0.0}
            return {
                "count": self.count,
                "sum": self.sum,
                "mean": self.sum / self.count,
                "min": self.min,
                "max": self.max,
                "p50": self._quantile(self._buckets, self.count, self.max, 0.50),
                "p99": self._quantile(self._buckets, self.count, self.max, 0.99),
            }


class Registry:
    """A named set of metric series; see module docstring."""

    def __init__(self):
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, LabelKey], Any] = {}

    def _get(self, name: str, labels: Dict[str, Any], cls):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        m = self._series.get(key)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {series_key(name, labels)} already registered "
                    f"as {type(m).__name__}, not {cls.__name__}")
            return m
        with self._lock:
            m = self._series.get(key)
            if m is None:
                m = self._series[key] = cls()
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {series_key(name, labels)} already registered "
                    f"as {type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, labels, Gauge)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(name, labels, Histogram)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Deterministic JSON-able dump: ``{"counters": {series: value},
        "gauges": {...}, "histograms": {series: {count, sum, ...}}}``
        with series keys sorted."""
        with self._lock:
            items = list(self._series.items())
        out: Dict[str, Dict[str, Any]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        for (name, labels), m in items:
            key = series_key(name, dict(labels))
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = m.snapshot()
        return {kind: dict(sorted(d.items())) for kind, d in out.items()}

    def reset(self) -> None:
        with self._lock:
            self._series.clear()


# --------------------------------------------------------------------------
# Process-wide default registry + module-level API
# --------------------------------------------------------------------------
_default = Registry()


def get_registry() -> Registry:
    return _default


def set_registry(reg: Optional[Registry]) -> None:
    global _default
    _default = reg if reg is not None else Registry()


def counter(name: str, **labels) -> Counter:
    return _default.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _default.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return _default.histogram(name, **labels)


def snapshot() -> Dict[str, Dict[str, Any]]:
    return _default.snapshot()


def reset() -> None:
    _default.reset()
