"""Design-space exploration — the paper's closing claim made executable.

Because the :class:`~repro_torch.core.hwconfig.HardwareConfig` is the only
hardware-specific artifact in the compiler, sweeping memory hierarchies,
stencils, and pass parameterizations never touches an operation or a
pass.  This subsystem turns that property into an engine:

* :mod:`repro_torch.explore.space`     — declarative search spaces over
  config fields and pass parameters (grid / random / hillclimb
  enumeration), with ``h100-sweep`` around the H100;
* :mod:`repro_torch.explore.workloads` — the scenario corpus every point
  is scored on (matmul chains, attention, MoE FFN, the paper's conv);
* :mod:`repro_torch.explore.runner`    — the sweep driver: compile through
  the cached pipeline, dedupe by config fingerprint, score with the
  analytic cost model, optionally validate the top-K by measurement on
  the card (the ``cuda`` backend's kernels), and the measure mode
  (``measure_candidates``: candidate tilings timed into the tuning DB);
* :mod:`repro_torch.explore.report`    — Pareto-frontier extraction
  (predicted latency x arena pressure x kernels launched), JSON +
  markdown.

``mesh-sweep`` is not ported yet and raises ``NotImplementedError``
(ROADMAP A9).

CLI::

    python -m repro_torch.explore --space h100-sweep --workloads default --budget 8
"""
from .report import build_report, dominating_baseline, pareto_front, to_markdown, write_report
from .runner import (PointResult, SweepResult, measure_candidates, run_sweep,
                     score_config, validate_top_k)
from .space import Axis, SearchSpace, apply_axis, get_space, BUILTIN_SPACES
from .workloads import CORPORA, Workload, get_workloads

__all__ = [
    "Axis", "SearchSpace", "apply_axis", "get_space", "BUILTIN_SPACES",
    "Workload", "get_workloads", "CORPORA",
    "PointResult", "SweepResult", "run_sweep", "score_config", "validate_top_k",
    "measure_candidates",
    "pareto_front", "dominating_baseline", "build_report", "to_markdown",
    "write_report",
]
