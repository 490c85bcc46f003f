"""repro_torch.obs — unified observability: tracing, metrics, kernel profiling.

Three coordinated pieces:

- :mod:`repro_torch.obs.trace` — structured spans recorded into a bounded ring
  buffer, exported as Chrome trace-event JSON (Perfetto-loadable); timed on
  the device where asked, and mirrored into a recording ``torch.profiler``.
- :mod:`repro_torch.obs.metrics` — labeled counters / gauges / histograms with
  a deterministic snapshot; backs ``cache_stats()`` and the serving
  engine's ``metrics()`` via shims.
- :mod:`repro_torch.obs.profile` — cost-model residual logging: profiled
  compiles append (predicted_s, measured_s) rows per lowered unit to a
  JSONL file under the cache dir.

``python -m repro_torch.obs summarize trace.json`` renders a per-phase
wall-time table and per-request serving breakdown from a trace file.
"""
from __future__ import annotations

from . import metrics, profile, trace
from .metrics import Registry, get_registry, snapshot as metrics_snapshot
from .profile import (append_residuals, read_residuals, residual_log_path,
                      summarize_residuals)
from .trace import (Tracer, clear as clear_trace, disable as disable_tracing,
                    enable as enable_tracing, enabled as tracing_enabled,
                    export_chrome_trace, get_tracer, instant, span, span_at,
                    spans)

__all__ = [
    "trace", "metrics", "profile",
    "span", "span_at", "instant", "spans",
    "enable_tracing", "disable_tracing", "tracing_enabled", "clear_trace",
    "export_chrome_trace", "get_tracer", "Tracer",
    "Registry", "get_registry", "metrics_snapshot",
    "residual_log_path", "append_residuals", "read_residuals",
    "summarize_residuals",
]
