#!/usr/bin/env python3
"""The readings that a cell's correctness limit is set from, on the card.

    python3 bench/control.py --workload chatglm3-6b.chat --seconds 30 --seeds 11 12 13

For each seed, in one process, one run of the cell as ``run.py`` makes it
(the same load, the same sample of served requests; ``--seconds`` only
needs to finish the sample), and on the same prompts and served tokens
the control: the plain reference computed through float8 products put
in the program's place.  Prints one JSON line a seed: every number of
``bench/check.py``, the program's and the control's (``control.*``),
whether the program reads correct, and whether the control, judged by
the cell's own limits, does (``control_correct``, which has to be
false).  With ``--detail DIR`` each seed's per-token readings go to
``DIR/<cell>.<seed>.json``.  Exits 1 where the control of any seed reads
correct.  The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--detail", type=Path, default=None)
    args = ap.parse_args()
    cache = ROOT / "build" / "bench"
    os.environ["STRIPE_CACHE_DIR"] = str(cache / "stripe")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("control: needs an NVIDIA card", file=sys.stderr)
        return 2
    control_passed = []
    for seed in args.seeds:
        detail = {} if args.detail else None
        r = harness.run_cell(args.workload, seed, args.seconds, False, control=True,
                             detail=detail)
        if args.detail:
            args.detail.mkdir(parents=True, exist_ok=True)
            (args.detail / f"{args.workload}.{seed}.json").write_text(json.dumps(detail))
        if r["control_correct"]:
            control_passed.append(seed)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "control_correct": r["control_correct"],
                          "numbers": {k: c["value"] for k, c in r["checks"].items()},
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "memory_peak_bytes": r["device"]["memory_peak_bytes"]}), flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    if control_passed:
        print(f"control: reads correct under the cell's limits on seeds {control_passed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
