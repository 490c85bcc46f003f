"""One run of one cell: set-up, the measured window, the traced slice,
the check against the plain reference, and the result line.

Set-up: the configuration's model from its file, the weights from the
seed on the device (``bench/weights.py``), the cell's driver, its warm-up
of the shapes the window reaches, and its start (every client sends; one
loop step serves them).  The window then runs driver steps until
``seconds`` have passed and closes at the end of the step that passes
them, so it holds whole steps (for the wave engine, whole waves).  With
``trace`` the program's ``obs.trace`` spans are on through the window,
and after it ``torch.profiler`` records ``SLICE_S`` more seconds of
steps: the traced slice, from which the device metrics come.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from bench import check, devtrace, guard, spec, stats, traffic, weights, work
from bench.served import Served

# seconds of steps profiled after the window of a --trace 1 run
SLICE_S = 8.0


def since_process_start() -> float:
    """Seconds since this process started (its start in /proc, on the
    boot clock)."""
    fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    arch: Dict[str, Any]
    mix: Dict[str, Any]
    counters: Tuple[Dict[str, float], Dict[str, float]]
    spans: List[Any]                     # the program's obs.trace spans in the window
    served: List[Served]
    waves: List[Any]                     # the wave driver's waves in the window
    trace: Optional[devtrace.Trace]      # the traced slice's device trace
    slice_s: float = 0.0                 # its length, host clock
    slice_flops: float = 0.0             # the model FLOPs served in it
    products: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)


def arch_config(cfg: Dict[str, Any]):
    """The port's ``ArchConfig`` for a configuration file's sizes."""
    from repro_torch.configs.base import ArchConfig, MoECfg

    names = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    if cfg.get("moe"):
        kw["moe"] = MoECfg(**cfg["moe"])
    return ArchConfig(**kw)


def _in(t: float, window: Tuple[float, float]) -> bool:
    return window[0] <= t <= window[1]


def end_to_end(name: str, served: List[Served], progress: Tuple[Dict[int, int], Dict[int, int]],
               window: Tuple[float, float], setup_s: float) -> Optional[float]:
    t0, t1 = window
    if name == "setup_s":
        return setup_s
    if name == "output_tokens_per_s":
        before, after = progress
        return stats.rate(sum(n - before.get(i, 0) for i, n in after.items()), t0, t1)
    if name == "prompt_tokens_per_s":
        return stats.rate(sum(s.plen for s in served if s.first and _in(s.first, window)), t0, t1)
    if name == "ttft_p95_ms":
        v = stats.p95([(s.first - s.submit) * 1e3 for s in served
                       if s.first and _in(s.first, window)])
        return v
    if name == "tpot_p95_ms":
        # requests served wholly in the window: one whose first token came
        # in set-up waited there for the set-up's other admissions
        return stats.p95([(s.finish - s.first) * 1e3 / (len(s.tokens) - 1) for s in served
                          if s.first and _in(s.first, window) and s.finish
                          and _in(s.finish, window) and len(s.tokens) > 1])
    raise KeyError(f"no end-to-end metric {name!r}")


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             overrides: Optional[Dict[str, Dict[str, Any]]] = None, control: bool = False,
             detail: Optional[Dict[str, list]] = None) -> Dict[str, Any]:
    """Run the cell once; returns the result line's object.
    ``overrides`` replaces the cell's ``config``, ``traffic`` or
    ``limits`` (the CPU tests run tiny sizes); ``control`` also reads
    the control's numbers on the same requests and judges them by the
    same limits (``control_correct``); ``detail`` receives each checked
    token's readings (``check.read``)."""
    import torch

    from repro_torch import api
    from repro_torch.obs import trace as obs_trace

    cell = spec.resolve(cell_name)
    for k, v in (overrides or {}).items():
        setattr(cell, k, v)
    arch, mix = cell.config, cell.traffic
    on_card = torch.device(device).type == "cuda"
    model = api.build_model(arch_config(arch))
    params = weights.make(model, seed, device)
    drv = spec.driver(mix["engine"]).Driver(
        api, model, params, arch, mix, traffic.requests(mix, arch["vocab"], seed), device, trace)
    if hasattr(drv, "warm"):
        drv.warm(api)
    drv.start()
    if on_card:
        torch.cuda.synchronize()
    if trace:
        obs_trace.clear()
        obs_trace.enable()

    # ---------------------------------------------------------- window
    t0 = time.perf_counter()
    setup_s = since_process_start()
    c0, p0 = drv.counters(), drv.progress()
    while True:
        drv.step()
        t1 = time.perf_counter()
        if t1 - t0 >= seconds:
            break
    window = (t0, t1)
    c1, p1 = drv.counters(), drv.progress()
    spans = [s for s in obs_trace.spans() if t0 <= s.ts <= t1] if trace else []
    obs_trace.disable()
    if c1.get("compiles", 0) != c0.get("compiles", 0):
        print(f"note: {c1['compiles'] - c0['compiles']} compiles inside the window",
              file=sys.stderr)
    served = drv.requests()
    ctx = Context(arch, mix, (c0, c1), spans, served,
                  [w for w in getattr(drv, "waves", []) if t0 <= w.start and w.end <= t1], None)

    # ----------------------------------------------------- traced slice
    trace_path = None
    if trace and on_card:
        trace_path = _profile_slice(drv, ctx, torch)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    rng = traffic.rng_for(seed, "check")
    jobs = drv.jobs(rng, int(mix["check_tokens"]), t0, t1)
    drv.close()
    del drv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    result: Dict[str, Any] = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
                              "device": _device(torch, on_card, memory_peak)}
    done = [s for s in served if s.finish and _in(s.finish, window)]
    result["attempted"] = len(done)
    result["failed"] = sum(1 for s in done if s.status != "ok")
    if trace:
        if trace_path is not None:
            ctx.trace = devtrace.Trace.load(trace_path)
            os.unlink(trace_path)
            busy = ctx.trace.busy_us() / 1e6
            result["device"].update(busy_s=busy, window_s=ctx.slice_s)
            result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                                   "idle_gaps": ctx.trace.idle_gaps()}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"]).read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = end_to_end(m["name"], served, (p0, p1), window, setup_s)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}

    # ------------------------------------------------------ correctness
    reading = check.read(spec.reference(arch["reference"]), params, arch, jobs, device,
                         control=control, detail=detail,
                         over=cell.limits.get("error_share", {}).get("over"))
    checks = {name: {"value": reading[name], "limit": float(lim["limit"])}
              for name, lim in cell.limits.items()}
    checks["tokens_checked"] = {"value": reading["tokens_checked"], "limit": 1}

    def within(prefix: str) -> bool:
        return all(reading[prefix + n] <= c["limit"] for n, c in checks.items()
                   if n != "tokens_checked")

    result["correct"] = bool(within("") and reading["tokens_checked"] >= 1
                             and result["attempted"] > 0 and result["failed"] == 0)
    if control:
        # the control in the program's place, judged by the same limits
        result["control_correct"] = bool(within("control.") and reading["tokens_checked"] >= 1)
        checks.update({n: {"value": v, "limit": None} for n, v in reading.items()
                       if n not in checks})
    loaded = guard.forbidden_loaded()
    if loaded:
        raise guard.ForbiddenImport(loaded)
    result["checks"] = checks
    return result


def _device(torch, on_card: bool, memory_peak: int) -> Dict[str, Any]:
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(memory_peak)}


def _profile_slice(drv, ctx: Context, torch) -> str:
    """``SLICE_S`` seconds of whole steps under ``torch.profiler``; fills
    the context's slice length, FLOPs and products, and returns the
    Chrome trace's path (in ``TMPDIR``)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize()
    before = drv.progress()
    drv.recording = True
    with torch.profiler.record_function("bench.slice"):
        s0 = time.perf_counter()
        while True:
            drv.step()
            torch.cuda.synchronize()
            s1 = time.perf_counter()
            if s1 - s0 >= SLICE_S:
                break
    drv.recording = False
    prof.stop()
    after = drv.progress()
    ctx.slice_s = s1 - s0
    ctx.products = list(drv.products)
    plen = {s.index: s.plen for s in drv.requests()}
    ctx.slice_flops = sum(work.served_flops(ctx.arch, plen[i], before.get(i, 0), n)
                          for i, n in after.items() if n > before.get(i, 0))
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    prof.export_chrome_trace(path)
    print(f"note: traced slice {ctx.slice_s:.1f} s, trace file {os.path.getsize(path) / 2**20:.0f} MiB",
          file=sys.stderr)
    return path
