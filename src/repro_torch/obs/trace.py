"""Structured tracing: spans exporting to Chrome trace JSON, on the host's
clock and, where asked, on the device's.

A *span* is a named wall-clock interval with attributes, recorded into a
process-wide bounded ring buffer.  Spans nest per thread (the tracer
keeps a thread-local stack, so each record knows its parent and depth)
and are cheap enough for serving hot paths: when tracing is disabled
(the default) and no profiler records, ``span()`` returns a shared no-op
context manager and the cost is two attribute reads; when enabled,
finishing a span is one lock acquisition and a deque append.

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

Device time.  ``span(name, device=True)`` also records a pair of CUDA
events on the current stream at the span's two ends, while tracing is on
and CUDA is initialised.  The record's ``device_dur`` is the stream's
elapsed time between them, in seconds: the device work the span
enqueued, and any time the stream sat idle in between (waiting for the
host to launch), so it sits beside the host ``dur`` rather than inside
it.  It is ``None`` off the card.  The events come from a small pool:
a pair goes back to it once its time is read, which happens when the
spans are read (:func:`spans`, export), or earlier, without waiting,
when the pool runs dry and the oldest pairs have completed.  An
attribute may be a 0-d tensor (a count kept on the device); it is
turned into a number with ``.item()`` when the spans are read, so the
hot path never waits for the device.

The profiler mirror.  While a ``torch.profiler`` is recording, every
``span()`` also opens a ``torch.profiler.record_function`` of the same
name, whether or not tracing is on, so the program's spans sit in the
profiler's trace on the profiler's clock, around the kernels they
launched.  Load the exported profiler trace (``prof.export_chrome_trace``)
in Perfetto and read the program's spans (category ``user_annotation``)
over the kernel rows: a kernel's launch lies inside the span that caused
it.  ``span_at`` and ``instant`` are not mirrored.  With tracing and the
profiler both off, ``span()`` returns the shared no-op after two
attribute reads.

Enable at import time with ``STRIPE_TRACE=1`` in the environment.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.autograd.profiler as _profiler

ENV_TRACE = "STRIPE_TRACE"

#: default ring-buffer capacity (finished spans retained); beyond it the
#: oldest spans are dropped and counted in ``Tracer.dropped``
DEFAULT_CAPACITY = 200_000

#: CUDA events kept for reuse by device-timed spans
EVENT_POOL = 64


class SpanRecord:
    """One finished span: name, start time and duration (seconds on the
    ``time.perf_counter`` clock), recording thread, parent span name and
    nesting depth, plus free-form attributes.  ``device_dur`` is the
    stream's elapsed seconds between the span's two ends for a span
    opened with ``device=True`` on the card, else ``None``."""

    __slots__ = ("name", "ts", "dur", "tid", "thread", "parent", "depth",
                 "attrs", "phase", "device_dur", "_events")

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
        self.device_dur: Optional[float] = None
        self._events = None  # the (start, end) CUDA events until read

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "ts": self.ts, "dur": self.dur,
                "tid": self.tid, "thread": self.thread, "parent": self.parent,
                "depth": self.depth, "attrs": dict(self.attrs),
                "phase": self.phase, "device_dur": self.device_dur}

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


class _Mirror:
    """A span that only the profiler sees (tracing off, profiler on)."""

    __slots__ = ("_rf",)

    def __init__(self, name: str):
        self._rf = _profiler.record_function(name)

    def __enter__(self) -> "_Mirror":
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._rf.__exit__(*exc)
        return False

    def set(self, **attrs) -> "_Mirror":
        return self


class _Span:
    """A live span (context manager).  ``set(**attrs)`` attaches
    attributes discovered mid-span (e.g. which cache level hit)."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_parent", "_depth",
                 "_device", "_events", "_rf")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any],
                 device: bool = False):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._device = device

    def set(self, **attrs) -> "_Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        stack = self._tracer._stack()
        self._parent = stack[-1] if stack else ""
        self._depth = len(stack)
        stack.append(self.name)
        self._events = None
        if self._device:
            self._events = (self._tracer._event(), self._tracer._event())
            self._events[0].record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        if self._events is not None:
            self._events[1].record()
        stack = self._tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        rec = SpanRecord(
            self.name, self._t0, dur, threading.get_ident(),
            threading.current_thread().name, self._parent, self._depth,
            self.attrs)
        rec._events = self._events
        self._tracer._record(rec)
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
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
        # records whose device time or tensor attributes are still unread,
        # in the order they finished; spare CUDA events
        self._timed: "deque[SpanRecord]" = deque()
        self._tensors: List[SpanRecord] = []
        self._pool: List[Any] = []
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
            self._timed.clear()
            self._tensors.clear()
            self.dropped = 0
            self.epoch = time.perf_counter()

    # ----------------------------------------------------------- recording
    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, rec: SpanRecord) -> None:
        tensors = any(isinstance(v, torch.Tensor) for v in rec.attrs.values())
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(rec)
            if rec._events is not None:
                self._timed.append(rec)
            if tensors:
                self._tensors.append(rec)

    def _event(self):
        """A timing CUDA event: a spare one, else one freed from the
        oldest spans whose events have completed (read without waiting),
        else a new one."""
        with self._lock:
            if not self._pool:
                while self._timed:
                    rec = self._timed[0]
                    if not (rec._events[0].query() and rec._events[1].query()):
                        break
                    self._timed.popleft()
                    self._pool.extend(_read_device(rec))
            if self._pool:
                return self._pool.pop()
        return torch.cuda.Event(enable_timing=True)

    def _resolve(self) -> None:
        """Read the device time and the tensor attributes of every span
        recorded so far (waits for the device)."""
        with self._lock:
            timed, self._timed = self._timed, deque()
            tensors, self._tensors = self._tensors, []
        spare = []
        for rec in timed:
            rec._events[1].synchronize()
            spare.extend(_read_device(rec))
        for rec in tensors:
            for k, v in rec.attrs.items():
                if isinstance(v, torch.Tensor):
                    rec.attrs[k] = v.item()
        with self._lock:
            self._pool.extend(spare[: max(0, EVENT_POOL - len(self._pool))])

    def span(self, name: str, device: bool = False, **attrs):
        """Context manager timing a block as one span; with ``device``
        also on the device's clock (``SpanRecord.device_dur``).  While
        tracing is disabled it is the shared no-op, or, while a
        ``torch.profiler`` records, only a ``record_function`` of the
        same name."""
        if not self.enabled:
            if not _profiler._is_profiler_enabled:
                return _NULL
            return _Mirror(name)
        return _Span(self, name, attrs, device and torch.cuda.is_initialized())

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
        """The retained spans, oldest first, with their device times and
        tensor attributes read."""
        self._resolve()
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
            if s.device_dur is not None:
                ev["args"]["device_dur_us"] = round(s.device_dur * 1e6, 3)
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


def _read_device(rec: SpanRecord):
    """Set ``rec.device_dur`` from its completed events; returns them."""
    start, end = rec._events
    rec._events = None
    rec.device_dur = start.elapsed_time(end) / 1e3
    return start, end


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


def span(name: str, device: bool = False, **attrs):
    return _default.span(name, device, **attrs)


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
