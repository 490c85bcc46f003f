#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: one cell, one run.

    python bench/run.py --workload chatglm3-6b.chat --seed 7 --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: whether the
served tokens were correct against the plain reference, the requests
attempted and failed in the window, the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics (``--trace 1``), and the device.
Every number compared for ``correct`` is printed beside its limit, last
on standard error and last in the line (``checks``).  Needs one NVIDIA
card per chip the cell asks for; exits non-zero, printing no result,
without them, without the port's sources, or if a module of JAX or of the
JAX package is loaded.  Caches of the program's builds go under
``build/`` in this checkout; ``cold_start`` in the line says whether the
stripe compilation cache there was empty when the run began (the first
run in a checkout, which compiles).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    cache = ROOT / "build" / "bench"
    cold = not any((cache / "stripe").glob("*"))
    os.environ["STRIPE_CACHE_DIR"] = str(cache / "stripe")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from bench import guard, harness, spec

    cell = spec.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} NVIDIA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"bench: loaded at start: {', '.join(loaded)}", file=sys.stderr)
        return 3
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except guard.ForbiddenImport as e:
        print(f"bench: {e}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result.update(cold_start=cold, checks=checks)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
