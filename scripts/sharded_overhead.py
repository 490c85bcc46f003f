#!/usr/bin/env python3
"""Where a call of the sharded step (``parallel/sharded.py``) spends its
host time, on one NVIDIA card with its ranks emulated on it: what
``chip_smoke.py`` phase 15 does not record.

    python3 scripts/sharded_overhead.py

The ranks are host threads that meet at every collective; a thread that
wakes from a collective's barrier may wait for Python's GIL up to the
interpreter's switch interval (``sys.getswitchinterval()``, 5 ms by
default) while the other ranks run Python.  For each switch interval in
``--intervals`` (in turns, ``--reps`` times each): the host clock of a
``shard_map`` of ``--collectives`` ``psum``\\ s of a small tensor on 4 ranks
(one collective's cost, less the empty call's), and of one
``sharded_decode_step`` of llama3-8b at full width, ``--layers`` deep,
bf16, oplib on ``cuda``, on ``(1, 4)`` against the single-device
``Model.decode_step`` (the logits held within chip_smoke's LOGIT_RTOL).
One JSON line, with the card's name and power limit.  Exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _host_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--collectives", type=int, default=64)
    ap.add_argument("--intervals", type=float, nargs="+", default=[0.005, 1e-4, 1e-5])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("sharded_overhead: needs an NVIDIA card")
    import chip_smoke
    from repro_torch import api
    from repro_torch.core import oplib
    from repro_torch.kernels import _build
    from repro_torch.parallel import sharded, spmd
    from repro_torch.parallel.spmd import P

    _build.build_all()
    card = chip_smoke._card_line()
    mesh = chip_smoke._card_mesh(chip_smoke.SHARD_SERVE_MESH)
    small = torch.ones(1024, device="cuda")

    def psums(x):
        for _ in range(args.collectives):
            x = spmd.psum(x, "model")
        return x

    empty = spmd.shard_map(lambda x: x, mesh, P(), P())
    chain = spmd.shard_map(psums, mesh, P(), P())
    cfg = dataclasses.replace(api.configs.get("llama3-8b"), n_layers=args.layers)
    model = api.build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(chip_smoke.SEED))
    placed = sharded.place_params(mesh, params)
    batch = api.make_batch(cfg, "prefill", chip_smoke.MODEL_BATCH, chip_smoke.MODEL_PROMPT,
                           seed=chip_smoke.SEED, device="cuda")
    max_len = chip_smoke.MODEL_PROMPT + 2 * args.reps * len(args.intervals) + 8
    max_len += -max_len % 4
    old_backend, old_interval = oplib.get_backend(), sys.getswitchinterval()
    oplib.set_backend("cuda")
    rows = {str(i): {"empty_ms": [], "psums_ms": [], "decode_ms": []} for i in args.intervals}
    try:
        cache = model.init_cache(chip_smoke.MODEL_BATCH, max_len)
        scache = sharded.init_cache(model, mesh, chip_smoke.MODEL_BATCH, max_len)
        logits, cache = model.prefill(params, batch, cache)
        slog, scache = sharded.sharded_prefill(model, mesh, placed, batch, scache)
        tok = logits[:, -1:, :cfg.vocab].argmax(-1).to(torch.int32)
        single, held = [], []
        for rep in range(args.reps):
            for interval in (args.intervals if rep % 2 == 0 else args.intervals[::-1]):
                sys.setswitchinterval(interval)
                row = rows[str(interval)]
                row["empty_ms"].append(_host_ms(torch, lambda: empty(small)))
                row["psums_ms"].append(_host_ms(torch, lambda: chain(small)))
                out = {}
                row["decode_ms"].append(_host_ms(torch, lambda: out.setdefault(
                    "s", sharded.sharded_decode_step(model, mesh, placed, scache, tok))))
                slog, scache = out["s"]
                sys.setswitchinterval(old_interval)
                t0 = time.perf_counter()
                logits, cache = model.decode_step(params, cache, tok)
                torch.cuda.synchronize()
                single.append((time.perf_counter() - t0) * 1e3)
                held.append(chip_smoke._row_held(slog, logits, cfg.vocab))
                tok = logits[:, -1:, :cfg.vocab].argmax(-1).to(torch.int32)
    finally:
        sys.setswitchinterval(old_interval)
        oplib.set_backend(old_backend)
    if max(held) > chip_smoke.LOGIT_RTOL:
        sys.exit(f"sharded_overhead: logits part from one device: {held}")
    out = {"card": card, "mesh": list(chip_smoke.SHARD_SERVE_MESH), "layers": args.layers,
           "collectives": args.collectives, "single_decode_ms_median": statistics.median(single),
           "held_max": max(held), "by_interval_s": {}}
    for key, row in rows.items():
        med = {k: statistics.median(v) for k, v in row.items()}
        med["per_collective_ms"] = (med["psums_ms"] - med["empty_ms"]) / args.collectives
        out["by_interval_s"][key] = med
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
