"""Structured tracing: zero-dependency spans exporting to Chrome trace JSON.

A *span* is a named wall-clock interval with attributes, recorded into a
process-wide bounded ring buffer.  Spans nest per thread (the tracer
keeps a thread-local stack, so each record knows its parent and depth)
and are cheap enough for serving hot paths: when tracing is disabled
(the default), ``span()`` returns a shared no-op context manager and the
cost is one attribute read; when enabled, finishing a span is one lock
acquisition and a deque append.

The buffer exports to Chrome trace-event JSON (``ph: "X"`` complete
events on the ``traceEvents`` array) loadable in Perfetto / DevTools via
:func:`export_chrome_trace`, and ``python -m repro_torch.obs summarize`` turns
a trace file into a per-phase wall-time table.

Usage::

    from repro_torch import obs

    obs.enable_tracing()
    with obs.trace.span("pass.fuse", program="mlp"):
        ...
    obs.export_chrome_trace("trace.json")

Cross-thread intervals that cannot be expressed as a ``with`` block on
one thread (e.g. a request's queue wait, stamped at submit on the feeder
thread and closed at admission on the serving thread) are recorded
retroactively with :func:`span_at`, passing explicit
``time.perf_counter()`` endpoints.

Enable at import time with ``STRIPE_TRACE=1`` in the environment.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

ENV_TRACE = "STRIPE_TRACE"

#: default ring-buffer capacity (finished spans retained); beyond it the
#: oldest spans are dropped and counted in ``Tracer.dropped``
DEFAULT_CAPACITY = 200_000


class SpanRecord:
    """One finished span: name, start time and duration (seconds on the
    ``time.perf_counter`` clock), recording thread, parent span name and
    nesting depth, plus free-form attributes."""

    __slots__ = ("name", "ts", "dur", "tid", "thread", "parent", "depth",
                 "attrs", "phase")

    def __init__(self, name: str, ts: float, dur: float, tid: int,
                 thread: str, parent: str = "", depth: int = 0,
                 attrs: Optional[Dict[str, Any]] = None, phase: str = "X"):
        self.name = name
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.thread = thread
        self.parent = parent
        self.depth = depth
        self.attrs = attrs or {}
        self.phase = phase  # "X" complete span | "i" instant

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "ts": self.ts, "dur": self.dur,
                "tid": self.tid, "thread": self.thread, "parent": self.parent,
                "depth": self.depth, "attrs": dict(self.attrs),
                "phase": self.phase}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"SpanRecord({self.name!r}, dur={self.dur * 1e3:.3f}ms, "
                f"depth={self.depth}, attrs={self.attrs})")


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL = _NullSpan()


class _Span:
    """A live span (context manager).  ``set(**attrs)`` attaches
    attributes discovered mid-span (e.g. which cache level hit)."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_parent", "_depth")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "_Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self._parent = stack[-1] if stack else ""
        self._depth = len(stack)
        stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        stack = self._tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._record(SpanRecord(
            self.name, self._t0, dur, threading.get_ident(),
            threading.current_thread().name, self._parent, self._depth,
            self.attrs))
        return False


class Tracer:
    """Process-wide span recorder: a bounded ring buffer of finished
    spans, thread-safe, with Chrome trace-event export."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: Optional[bool] = None):
        self.enabled = (bool(os.environ.get(ENV_TRACE))
                        if enabled is None else enabled)
        self.capacity = int(capacity)
        self.dropped = 0
        self._lock = threading.Lock()
        self._spans: "deque[SpanRecord]" = deque(maxlen=self.capacity)
        self._local = threading.local()
        self.epoch = time.perf_counter()

    # ------------------------------------------------------------- control
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0
            self.epoch = time.perf_counter()

    # ----------------------------------------------------------- recording
    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(rec)

    def span(self, name: str, **attrs):
        """Context manager timing a block as one span.  No-op (and
        allocation-free) while tracing is disabled."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, attrs)

    def span_at(self, name: str, start_s: float, end_s: float, **attrs) -> None:
        """Record a span with explicit ``time.perf_counter`` endpoints —
        for intervals that start and end on different threads (a
        request's queue wait) or are reconstructed after the fact."""
        if not self.enabled:
            return
        self._record(SpanRecord(
            name, start_s, max(0.0, end_s - start_s), threading.get_ident(),
            threading.current_thread().name, "", 0, attrs))

    def instant(self, name: str, **attrs) -> None:
        """Record a zero-duration marker event."""
        if not self.enabled:
            return
        stack = self._stack()
        self._record(SpanRecord(
            name, time.perf_counter(), 0.0, threading.get_ident(),
            threading.current_thread().name, stack[-1] if stack else "",
            len(stack), attrs, phase="i"))

    # -------------------------------------------------------------- export
    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event representation (``traceEvents`` +
        metadata), timestamps in microseconds relative to the tracer
        epoch — loadable in Perfetto / ``chrome://tracing``."""
        spans = self.spans()
        # origin: the tracer epoch, or the earliest span when a retroactive
        # span_at() predates it — Perfetto rejects negative timestamps
        origin = self.epoch
        if spans:
            origin = min(origin, min(s.ts for s in spans))
        # stable small tids per thread, in first-seen order
        tid_map: Dict[int, int] = {}
        names: Dict[int, str] = {}
        events: List[Dict[str, Any]] = []
        for s in spans:
            tid = tid_map.setdefault(s.tid, len(tid_map) + 1)
            names.setdefault(tid, s.thread)
            ev = {
                "name": s.name,
                "cat": s.name.split(".", 1)[0],
                "ph": s.phase,
                "ts": round((s.ts - origin) * 1e6, 3),
                "pid": os.getpid(),
                "tid": tid,
                "args": _json_safe(s.attrs),
            }
            if s.phase == "X":
                ev["dur"] = round(s.dur * 1e6, 3)
            else:
                ev["s"] = "t"  # instant scoped to its thread
            events.append(ev)
        meta = [{"name": "thread_name", "ph": "M", "pid": os.getpid(),
                 "tid": tid, "args": {"name": name}}
                for tid, name in sorted(names.items())]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"tool": "repro_torch.obs", "dropped_spans": self.dropped}}

    def export_chrome_trace(self, path) -> str:
        data = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(data, f)
        return str(path)


def _json_safe(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = str(v)
    return out


# --------------------------------------------------------------------------
# Process-wide default tracer + module-level API
# --------------------------------------------------------------------------
_default = Tracer()


def get_tracer() -> Tracer:
    return _default


def set_tracer(tracer: Tracer) -> None:
    global _default
    _default = tracer


def span(name: str, **attrs):
    return _default.span(name, **attrs)


def span_at(name: str, start_s: float, end_s: float, **attrs) -> None:
    _default.span_at(name, start_s, end_s, **attrs)


def instant(name: str, **attrs) -> None:
    _default.instant(name, **attrs)


def enable() -> None:
    _default.enable()


def disable() -> None:
    _default.disable()


def enabled() -> bool:
    return _default.enabled


def clear() -> None:
    _default.clear()


def spans() -> List[SpanRecord]:
    return _default.spans()


def export_chrome_trace(path) -> str:
    return _default.export_chrome_trace(path)


# --------------------------------------------------------------------------
# Trace-file analysis (the `python -m repro_torch.obs summarize` backend)
# --------------------------------------------------------------------------
def load_chrome_trace(path) -> List[Dict[str, Any]]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") in ("X", "i")]


def summarize_events(events: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Aggregate complete events per span name: count, total/mean/max
    wall ms — sorted by total time descending."""
    agg: Dict[str, Dict[str, float]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        a = agg.setdefault(e["name"], {"count": 0, "total_us": 0.0, "max_us": 0.0})
        a["count"] += 1
        a["total_us"] += float(e.get("dur", 0.0))
        a["max_us"] = max(a["max_us"], float(e.get("dur", 0.0)))
    rows = []
    for name, a in agg.items():
        rows.append({
            "name": name, "count": int(a["count"]),
            "total_ms": a["total_us"] / 1e3,
            "mean_ms": a["total_us"] / 1e3 / max(a["count"], 1),
            "max_ms": a["max_us"] / 1e3,
        })
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def request_breakdown(events: Iterable[Dict[str, Any]]) -> Dict[int, Dict[str, float]]:
    """Per-request serving phase breakdown from ``serve.*`` spans:
    ``{uid: {queue_s, prefill_s, decode_s, total_s}}``.  ``decode_s`` is
    the remainder of the request's lifetime after queueing and prefill
    (the batched decode steps are shared across slots, so per-request
    decode time is attributed by residual, not by step)."""
    per_uid: Dict[int, Dict[str, float]] = {}
    for e in events:
        uid = (e.get("args") or {}).get("uid")
        if uid is None or e.get("ph") != "X":
            continue
        rec = per_uid.setdefault(int(uid), {})
        dur_s = float(e.get("dur", 0.0)) / 1e6
        if e["name"] == "serve.queue":
            rec["queue_s"] = rec.get("queue_s", 0.0) + dur_s
        elif e["name"] == "serve.prefill":
            rec["prefill_s"] = rec.get("prefill_s", 0.0) + dur_s
        elif e["name"] == "serve.request":
            rec["total_s"] = dur_s
    for rec in per_uid.values():
        rec.setdefault("queue_s", 0.0)
        rec.setdefault("prefill_s", 0.0)
        rec.setdefault("total_s", rec["queue_s"] + rec["prefill_s"])
        rec["decode_s"] = max(
            0.0, rec["total_s"] - rec["queue_s"] - rec["prefill_s"])
    return per_uid
