"""``python -m repro_torch.explore`` — run a design-space sweep and report
Pareto frontiers, measuring the top-K points on the card.

Example::

    python -m repro_torch.explore --space h100-sweep --workloads default \
        --budget 8 --strategy grid --top-k 3 --out explore_out

``--top-k`` measures through the ``cuda`` backend on the card by default
(``--device cpu`` runs the kernels' plain versions instead, which says
nothing about the card's time).  ``--measure N`` (the measure mode)
times up to N candidate tilings per workload on the same backend and
device and records every measurement in the tuning DB under
``--tune-db`` (default: the compilation-cache dir), in the slot of
``--device``.  The ``mesh-sweep`` space is not ported yet and exits with
an error.  Prints the markdown report and writes ``explore_report.json`` +
``explore_report.md`` under ``--out``.  The sweep's compilation cache
lives under ``--cache-dir`` (default ``<out>/cache``; honors
``$STRIPE_CACHE_DIR`` only when passed explicitly) so exploration never
pollutes the user's ``~/.cache/stripe-repro``.
"""
from __future__ import annotations

import argparse
import sys

from .report import to_markdown, write_report
from .runner import run_sweep
from .space import BUILTIN_SPACES, NOT_PORTED, _fmt, get_space
from .workloads import CORPORA


def _space_epilog() -> str:
    """--help epilog enumerating every built-in space's axes (so the
    sweepable knobs — including the device-mesh shapes of `mesh-sweep` —
    are discoverable without reading the source)."""
    lines = ["built-in spaces and their axes:"]
    for name in sorted(BUILTIN_SPACES):
        sp = BUILTIN_SPACES[name]()
        lines.append(f"  {name} (base {sp.base}):")
        for a in sp.axes:
            vals = ", ".join(_fmt(v) for v in a.values)
            lines.append(f"    {a.path} = {{{vals}}} (default {_fmt(a.default)})")
    for name, why in sorted(NOT_PORTED.items()):
        lines.append(f"  {name}: {why}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.explore",
        description=__doc__.splitlines()[0],
        epilog=_space_epilog(),
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--space", default="h100-sweep",
                    help=f"built-in search space: {sorted(BUILTIN_SPACES)}")
    ap.add_argument("--workloads", default="default",
                    help=f"corpus name {sorted(CORPORA)} or comma-separated workloads")
    ap.add_argument("--budget", type=int, default=32,
                    help="max sweep points to enumerate (default 32)")
    ap.add_argument("--strategy", default="grid",
                    choices=("grid", "random", "hillclimb"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top-k", type=int, default=3, dest="top_k",
                    help="validate the K best predicted points by real "
                         "measurement (0 disables)")
    ap.add_argument("--backend", default="cuda",
                    help="measurement backend for --top-k and --measure (default cuda)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where --top-k and --measure run: cuda (the card, default) "
                         "or cpu (the kernels' plain versions)")
    ap.add_argument("--parallel", type=int, default=0,
                    help="process-pool width for scoring unique points "
                         "(0/1 = serial)")
    ap.add_argument("--measure", type=int, default=0,
                    help="measure mode: wall-time up to N candidate tilings "
                         "per workload and record every measurement in the "
                         "tuning DB (0 disables)")
    ap.add_argument("--tune-db", default=None, dest="tune_db",
                    help="tuning-DB directory for --measure "
                         "(default: the compilation-cache dir)")
    ap.add_argument("--out", default="explore_out",
                    help="output directory for the JSON/markdown report")
    ap.add_argument("--cache-dir", default=None,
                    help="compilation-cache directory (default <out>/cache)")
    args = ap.parse_args(argv)

    try:
        space = get_space(args.space)
    except (KeyError, NotImplementedError) as e:
        ap.error(str(e))
    cache_dir = args.cache_dir or f"{args.out}/cache"

    tune_db = None
    if args.measure > 0:
        from ..tune.db import TuningDB

        tune_db = TuningDB(dir=args.tune_db or cache_dir)

    sweep = run_sweep(
        space, args.workloads, budget=args.budget, strategy=args.strategy,
        seed=args.seed, cache_dir=cache_dir, parallel=args.parallel,
        measure_top_k=args.top_k, measure_backend=args.backend,
        measure_device=args.device, measure=args.measure, tune_db=tune_db)
    jpath, mpath = write_report(sweep, args.out)
    print(to_markdown(sweep))
    print(f"wrote {jpath} and {mpath}")
    n_err = sum(1 for p in sweep.points if p.error)
    if n_err:
        print(f"warning: {n_err} point(s) failed to score", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
