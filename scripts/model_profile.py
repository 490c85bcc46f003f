#!/usr/bin/env python3
"""Where a call of a model's own forward spends its time, on one NVIDIA card.

    python3 scripts/model_profile.py              # llama3-8b, 32 layers, one JSON line per call
    python3 scripts/model_profile.py --layers 4
    python3 scripts/model_profile.py --max-len 8192   # a long KV cache
    python3 scripts/model_profile.py --model qwen3-moe-30b-a3b --prompt 100 --max-len 128
    python3 scripts/model_profile.py --model zamba2-2.7b --prompt 100 --max-len 128

``chip_smoke.py``'s phases 10-12 without their checks: random bf16
weights from a seeded generator (``--model``, at full width, its full
depth unless ``--layers``), ``Model.prefill`` on 4 prompts of
``--prompt`` tokens (64 by default; 100 is phase 11's longest) and
``Model.decode_step`` at batch 4, with ``oplib`` on ``cuda`` (every
projection one launch of the contraction kernel) and on ``torch``, or on
``torch`` alone for a ``relu2`` MLP (``chip_smoke.oplib_backends``,
ROADMAP C9).  Each
call runs once untimed, then under ``torch.profiler`` (CPU and CUDA
activities): the line gives the call's host-clock time (with
``torch.cuda.synchronize()``), the card's busy time (the union of its
kernels' intervals), the idle share between them, the number of kernel
launches, and the device time by kernel group: the contraction kernel,
other matrix products (cuBLAS: the LM head, and a MoE layer's experts),
and the rest (norms, RoPE, masks, softmax, copies, the MoE dispatch's
scatters), with the 8 kernels that take most of it.  Every
``oplib.linear`` call of the model (its projections) runs inside a
``torch.profiler.record_function`` range, which the profiler also shows
on the card as the span of the kernels launched inside it, so the line
also gives the device time of the kernels inside those spans, by the
same groups (``projection_device_ms_by_group``): on ``torch`` the
projections' cuBLAS time, apart from a MoE layer's experts and the LM
head, which are ``einsum``s outside ``oplib``.  The KV cache
holds ``--max-len`` rows (default 72, phase 10's), of which the decode
step reads every one (its mask covers the rest).  The host
time is taken under the profiler, which adds to it.  Exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


# the kernels of csrc/contraction.cu, and the name parts of cuBLAS's
CONTRACTION = ("contraction_kernel", "finish_kernel", "skinny_kernel", "ffma_kernel",
               "wgmma_kernel", "pack_kernel")
LIBRARY = ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas")
# the record_function range around every projection, and the modules
# whose ``linear`` is wrapped in it
PROJECTION = "oplib.linear"
LINEAR_MODULES = ("core", "attention", "moe", "ssm", "xlstm")


def wrap_projections(torch):
    """Run every ``linear`` of the model's layers inside a
    ``PROJECTION`` range (the modules' own name, patched)."""
    import importlib

    from repro_torch.nn import core

    real = core.linear

    def linear(*a, **kw):
        with torch.profiler.record_function(PROJECTION):
            return real(*a, **kw)

    for name in LINEAR_MODULES:
        mod = importlib.import_module(f"repro_torch.nn.{name}")
        if getattr(mod, "linear", None) is real:
            mod.linear = linear


def _projection_ms(spans, kernels) -> dict:
    """Device time of the kernels that run inside a ``PROJECTION`` range's
    span on the card (``spans``: sorted, disjoint (start, end)), by
    group."""
    import bisect

    starts = [a for a, _b in spans]
    out: dict = {}
    for e in kernels:
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.end <= spans[i][1]:
            g = _group(e.name)
            out[g] = out.get(g, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return out


def _group(name: str) -> str:
    n = name.lower()
    if any(k in n for k in CONTRACTION):
        return "contraction"
    if any(k in n for k in LIBRARY):
        return "matmul_library"
    return "other"


def _busy_ms(events) -> float:
    """Length of the union of the kernels' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def profile_call(torch, fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA") and e.time_range.end]
    # a record_function range also shows on the card, as the span of the
    # kernels launched inside it: not a kernel
    kernels = [e for e in on_card if e.name != PROJECTION]
    spans = sorted((e.time_range.start, e.time_range.end) for e in on_card
                   if e.name == PROJECTION)
    by_group: dict = {}
    by_name: dict = {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        g = _group(e.name)
        by_group[g] = by_group.get(g, 0.0) + ms
        name = e.name.split("(")[0][:60]
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + ms)
    busy = _busy_ms(kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"host_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall), "kernels": len(kernels),
            "device_ms_by_group": by_group,
            "projection_device_ms_by_group": _projection_ms(spans, kernels),
            "top_kernels": [{"name": k, "launches": n, "ms": t} for k, (n, t) in top]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="llama3-8b", help="a config of the registry")
    ap.add_argument("--layers", type=int, default=None, help="depth (default: the model's)")
    ap.add_argument("--prompt", type=int, default=64, help="prompt tokens of each of 4 rows")
    ap.add_argument("--max-len", type=int, default=72, help="KV cache rows")
    args = ap.parse_args()
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        sys.exit("model_profile: needs an NVIDIA card")
    import chip_smoke
    from repro_torch import api
    from repro_torch.core import oplib

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    wrap_projections(torch)
    cfg = api.configs.get(args.model)
    cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers)
    model = api.build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = api.make_batch(cfg, "prefill", 4, args.prompt, seed=0)
    for backend in chip_smoke.oplib_backends(cfg):
        oplib.set_backend(backend)
        logits, cache = model.prefill(params, batch, model.init_cache(4, args.max_len))
        tok = logits[:, -1:].argmax(-1).int()
        # decode_step donates the cache: every call writes the same row
        # again (a recurrent state steps on)
        calls = {"prefill": lambda: model.prefill(params, batch,
                                                  model.init_cache(4, args.max_len)),
                 "decode_step": lambda: model.decode_step(params, cache, tok)}
        for name, fn in calls.items():
            row = {"call": name, "model": cfg.name, "backend": backend,
                   "layers": cfg.n_layers, "prompt": args.prompt, "max_len": args.max_len,
                   "card": card, **profile_call(torch, fn)}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
