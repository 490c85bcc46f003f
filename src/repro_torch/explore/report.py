"""Pareto-frontier extraction and report emission.

A sweep point is scored on four minimization axes — predicted corpus
latency, peak VMEM arena pressure, kernels launched, per-device
communication bytes (zero off-mesh) — and the report
extracts the non-dominated set, compares every point against the stock
baseline per workload, and emits both machine-readable JSON and a
markdown table (the CLI prints the latter).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .runner import PointResult, SweepResult

PARETO_AXES = ("latency_s", "vmem_peak_bytes", "n_kernels", "comm_bytes")


def _axes(p: PointResult) -> Tuple[float, ...]:
    return tuple(float(getattr(p, a)) for a in PARETO_AXES)


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True iff ``a`` is no worse than ``b`` on every axis and strictly
    better on at least one (all axes minimized)."""
    return all(x <= y for x, y in zip(a, b)) and any(x < y for x, y in zip(a, b))


def pareto_front(points: Sequence[PointResult]) -> List[int]:
    """Indices (``PointResult.index``) of the non-dominated set."""
    front = []
    for p in points:
        if p.error or p.dedup_of is not None:
            continue
        pa = _axes(p)
        if not any(dominates(_axes(q), pa) for q in points
                   if q is not p and not q.error and q.dedup_of is None):
            front.append(p.index)
    return front


def dominating_baseline(sweep: SweepResult) -> Dict[str, List[int]]:
    """Per workload: sweep points strictly better than the stock baseline
    on predicted latency — the design-exploration headline ("what
    hardware change would make this workload faster")."""
    out: Dict[str, List[int]] = {}
    for w in sweep.baseline.scores:
        base = sweep.baseline.workload_latency(w)
        better = [p.index for p in sweep.unique_points()
                  if w in p.scores and p.workload_latency(w) < base]
        out[w] = sorted(better, key=lambda i: sweep.points[i].workload_latency(w))
    return out


def build_report(sweep: SweepResult) -> Dict:
    """The full JSON report document."""
    front = pareto_front(sweep.points)
    dom = dominating_baseline(sweep)
    n_dedup = sum(1 for p in sweep.points if p.dedup_of is not None)
    n_err = sum(1 for p in sweep.points if p.error)
    return {
        "space": sweep.space.name,
        "base_config": sweep.space.base,
        "axes": [{"path": a.path, "values": list(a.values), "default": a.default}
                 for a in sweep.space.axes],
        "strategy": sweep.strategy,
        "workloads": list(sweep.baseline.scores),
        "n_points": len(sweep.points),
        "n_unique": len(sweep.points) - n_dedup,
        "n_deduped": n_dedup,
        "n_errors": n_err,
        "wall_time_s": round(sweep.wall_time_s, 3),
        "cache_stats": sweep.cache_stats,
        "baseline": sweep.baseline.to_json(),
        "points": [p.to_json() for p in sweep.points],
        "pareto_front": front,
        "dominating_baseline": dom,
        "validation": sweep.validation,
        "measurement": sweep.measurement,
    }


def _fmt_lat(s: float) -> str:
    return f"{s * 1e6:.2f}"


def to_markdown(sweep: SweepResult, max_rows: int = 24) -> str:
    """Human-readable report: the Pareto table (best predicted latency
    first), baseline row marked, plus the dominance and validation
    summaries."""
    front = set(pareto_front(sweep.points))
    dom = dominating_baseline(sweep)
    lines = [
        f"# Design-space exploration: `{sweep.space.name}` "
        f"(base `{sweep.space.base}`, strategy {sweep.strategy})",
        "",
        f"{len(sweep.points)} points "
        f"({len(sweep.points) - sum(1 for p in sweep.points if p.dedup_of is not None)} unique, "
        f"{sum(1 for p in sweep.points if p.dedup_of is not None)} deduped by fingerprint) "
        f"x {len(sweep.baseline.scores)} workloads; "
        f"wall {sweep.wall_time_s:.1f}s.",
        "",
        "| rank | config | pred latency (us) | VMEM peak (B) | kernels | comm (B) | Pareto |",
        "|---:|---|---:|---:|---:|---:|:---:|",
    ]
    rows: List[PointResult] = sorted(sweep.unique_points(), key=lambda p: p.latency_s)
    table = [(sweep.baseline, True)] + [(p, False) for p in rows[:max_rows]]
    table.sort(key=lambda t: t[0].latency_s)
    for rank, (p, is_base) in enumerate(table):
        name = f"**{p.config_name} (baseline)**" if is_base else p.config_name
        lines.append(
            f"| {rank} | {name} | {_fmt_lat(p.latency_s)} | "
            f"{p.vmem_peak_bytes} | {p.n_kernels} | "
            f"{int(getattr(p, 'comm_bytes', 0) or 0)} | "
            f"{'x' if (not is_base and p.index in front) else ''} |")
    lines.append("")
    lines.append("## Baseline dominance (predicted latency, per workload)")
    lines.append("")
    for w, idxs in dom.items():
        base_us = _fmt_lat(sweep.baseline.workload_latency(w))
        if not idxs:
            lines.append(f"- `{w}`: baseline ({base_us} us) undominated")
        else:
            best = sweep.points[idxs[0]]
            lines.append(
                f"- `{w}`: {len(idxs)} config(s) beat baseline "
                f"({base_us} us); best `{best.config_name}` at "
                f"{_fmt_lat(best.workload_latency(w))} us")
    if sweep.validation:
        v = sweep.validation
        lines.append("")
        lines.append(f"## Measured validation (top-{v['top_k']}, "
                     f"backend `{v['backend']}`)")
        lines.append("")
        lines.append("| config | predicted (us) | measured (us/call) |")
        lines.append("|---|---:|---:|")
        for e in v["entries"]:
            meas = ("err: " + e["error"]) if e["error"] else f"{e['measured_total_us']:.1f}"
            lines.append(f"| {e['config']} | {_fmt_lat(e['predicted_latency_s'])} | {meas} |")
        lines.append("")
        lines.append(f"predicted rank: {v['predicted_rank']}  |  "
                     f"measured rank: {v['measured_rank']} "
                     f"(-1 = baseline)"
                     + (f"  |  {v['rounds']} interleaved rounds"
                        if v.get("rounds") else ""))
    if sweep.measurement:
        m = sweep.measurement
        lines.append("")
        lines.append(f"## Measured autotuning ({m['backend']}"
                     f"{', interpret' if m.get('interpret') else ''}; "
                     f"min of {m['rounds']} interleaved rounds)")
        lines.append("")
        lines.append("| workload | candidates | distinct plans | analytic (s/call) | "
                     "measured best (s/call) | speedup | winner |")
        lines.append("|---|---:|---:|---:|---:|---:|---|")
        for w, wl in m["workloads"].items():
            if wl.get("error"):
                lines.append(f"| `{w}` | - | - | - | - | - | err: {wl['error']} |")
                continue
            # the measured winner is *promoted*: its candidate id is the
            # tuning-DB best, which stripe_jit(tune=...) replays
            speed = wl.get("speedup_vs_analytic")
            lines.append(
                f"| `{w}` | {wl['n_candidates']} | {wl['n_distinct_plans']} | "
                f"{wl['analytic_s']:.4g} | {wl['best_s']:.4g} | "
                f"{speed:.2f}x | `{wl['best_candidate']}`"
                f"{' (analytic held)' if not wl['improved'] else ''} |")
        lines.append("")
        lines.append("every measurement above is recorded in the tuning DB; "
                     "`stripe_jit(..., tune=...)` replays each winner.  Candidates "
                     "of one plan launch the same kernels: between them the "
                     "winner is noise.")
    lines.append("")
    return "\n".join(lines)


def write_report(sweep: SweepResult, out_dir: str) -> Tuple[Path, Path]:
    """Emit ``explore_report.json`` + ``explore_report.md`` under
    ``out_dir``; returns both paths."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    jpath = out / "explore_report.json"
    mpath = out / "explore_report.md"
    jpath.write_text(json.dumps(build_report(sweep), indent=2, default=str))
    mpath.write_text(to_markdown(sweep))
    return jpath, mpath
