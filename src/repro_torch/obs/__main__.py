"""CLI: summarize observability artifacts.

    python -m repro_torch.obs summarize trace.json   # per-phase wall time + serving breakdown
    python -m repro_torch.obs residuals [path]       # cost-model residual log summary
"""
from __future__ import annotations

import argparse
import json
import sys

from . import profile, trace


def _fmt_table(rows, cols, headers):
    widths = [max(len(h), max((len(f"{r[c]}") for r in rows), default=0))
              for c, h in zip(cols, headers)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    lines.append("  ".join("-" * w for w in widths))
    for r in rows:
        lines.append("  ".join(f"{r[c]}".ljust(w) for c, w in zip(cols, widths)))
    return "\n".join(lines)


def cmd_summarize(args) -> int:
    events = trace.load_chrome_trace(args.path)
    rows = trace.summarize_events(events)
    if not rows:
        print(f"{args.path}: no complete span events")
        return 1
    total_ms = sum(r["total_ms"] for r in rows)
    print(f"# {args.path}: {sum(r['count'] for r in rows)} spans, "
          f"{len(rows)} phases, {total_ms:.1f} ms total span time\n")
    table = [{
        "phase": r["name"], "count": r["count"],
        "total_ms": f"{r['total_ms']:.3f}",
        "mean_ms": f"{r['mean_ms']:.3f}",
        "max_ms": f"{r['max_ms']:.3f}",
        "share": f"{100.0 * r['total_ms'] / total_ms:.1f}%",
    } for r in rows[: args.top]]
    print(_fmt_table(table, ["phase", "count", "total_ms", "mean_ms",
                             "max_ms", "share"],
                     ["phase", "count", "total ms", "mean ms", "max ms", "%"]))

    breakdown = trace.request_breakdown(events)
    if breakdown:
        n = len(breakdown)
        mean = lambda k: sum(b[k] for b in breakdown.values()) / n
        print(f"\n# serving: {n} requests "
              f"(mean queue {mean('queue_s') * 1e3:.2f} ms | "
              f"prefill {mean('prefill_s') * 1e3:.2f} ms | "
              f"decode {mean('decode_s') * 1e3:.2f} ms | "
              f"total {mean('total_s') * 1e3:.2f} ms)")
        if args.requests:
            req_rows = [{
                "uid": uid,
                "queue_ms": f"{b['queue_s'] * 1e3:.2f}",
                "prefill_ms": f"{b['prefill_s'] * 1e3:.2f}",
                "decode_ms": f"{b['decode_s'] * 1e3:.2f}",
                "total_ms": f"{b['total_s'] * 1e3:.2f}",
            } for uid, b in sorted(breakdown.items())[: args.top]]
            print(_fmt_table(req_rows,
                             ["uid", "queue_ms", "prefill_ms", "decode_ms",
                              "total_ms"],
                             ["uid", "queue ms", "prefill ms", "decode ms",
                              "total ms"]))
    return 0


def cmd_residuals(args) -> int:
    rows = profile.read_residuals(args.path)
    # rows rotated out of the log live on as running summaries in the
    # tuning DB next to it — merge them so the bias covers full history
    path = profile.residual_log_path() if args.path is None else profile.Path(args.path)
    folded = []
    try:
        from ..tune.db import TuningDB

        folded = TuningDB(dir=path.parent).residual_summaries()
    except Exception:
        pass
    summary = profile.summarize_residuals(rows, folded=folded)
    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
        return 0
    print(f"# {path}: {summary['rows']} residual rows "
          f"({summary['live_rows']} live, {summary['folded_rows']} folded "
          f"into the tuning DB; "
          f"{summary['pairs_with_prediction']} with predictions)")
    for backend, n in summary["by_backend"].items():
        print(f"  backend {backend}: {n}")
    g = summary["measured_over_predicted_gmean"]
    if g is not None:
        print(f"  measured/predicted geometric mean: {g:.3f}x")
    return 0 if rows or folded else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize", help="per-phase wall time from a Chrome trace")
    p.add_argument("path")
    p.add_argument("--top", type=int, default=30, help="max rows per table")
    p.add_argument("--requests", action="store_true",
                   help="also print the per-request breakdown table")
    p.set_defaults(fn=cmd_summarize)

    p = sub.add_parser("residuals", help="summarize the cost-model residual log")
    p.add_argument("path", nargs="?", default=None)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_residuals)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
