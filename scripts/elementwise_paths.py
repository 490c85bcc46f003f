#!/usr/bin/env python3
"""Time the elementwise kernel's paths on one NVIDIA card.

    python3 scripts/elementwise_paths.py        # one JSON line per case

For each of the 4 elementwise units of the exploration corpus compiled
under ``h100`` without the fusion pass (mm_bias_gelu's bias_gelu,
ffn_relu2's bias and relu2, moe_ffn's gate: the units of
``chip_smoke.py``'s phase 4), on seeded random inputs, it holds the vec
path and the general loop (``path="general"``) against the plain version
with ``chip_smoke.py``'s tolerances, then times the two in turns (CUDA
events, median of 21, L2 flushed before every launch: ``chip_smoke.py``'s
timer) and reads each kernel's device time from a ``torch.profiler``
trace of 10 back-to-back calls.  Beside them: an empty kernel's launch
timed the same way (the floor no unit can beat), ``torch.add`` on
ffn_relu2/bias's operands (the same function as one PyTorch call, a
yardstick of a vectorized elementwise kernel the port never calls), and
``ptxas -v``'s registers, stack frame and spill bytes of every
instantiation of both paths' kernels.  Exits non-zero without a card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

REPS = 21
UNITS = (("mm_bias_gelu", "bias_gelu"), ("ffn_relu2", "bias"), ("ffn_relu2", "relu2"),
         ("moe_ffn", "gate"))


def device_ms(torch, fn, n=10):
    """Device time per call of each kernel fn launches, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and e.count and not e.key.startswith(("cuda", "aten", "Memcpy", "Memset")):
            out[e.key.split("(")[0][:60]] = t / 1e3 / n
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("elementwise_paths: needs an NVIDIA card")
    from repro_torch.core import cache as stripe_cache
    from repro_torch.core.driver import stripe_jit
    from repro_torch.core.hwconfig import get_config
    from repro_torch.core.lower_torch import torch_dtype
    from repro_torch.explore.workloads import get_workloads
    from repro_torch.kernels import elementwise as EW

    import chip_smoke

    card = chip_smoke._card_line()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    timer = chip_smoke._Timer(torch, REPS)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    hw = get_config("h100").without_pass("fuse")
    corpus = {w.name: w for w in get_workloads("all")}
    total = {"ms": 0.0, "general_ms": 0.0}
    for prog_name, unit_name in UNITS:
        c = stripe_jit(corpus[prog_name].build(), hw, "cuda",
                       cache=stripe_cache.CompilationCache(use_disk=False), use_disk=False)
        (fn,) = [fn for unit, _kind, fns in c._fn.steps if unit.name == unit_name for fn in fns]
        bufs = c.program.buffers
        ins = [torch.randn(bufs[s.buf].shape, generator=gen, device="cuda")
               .to(torch_dtype(str(bufs[s.buf].dtype))) for s in fn.plan.ins]
        view = EW.vec_view(fn.plan, ins, fn.out_clip)
        what = f"{prog_name}/{unit_name}"
        if view is None:
            raise AssertionError(f"{what} refused by the vec view: "
                                 f"{EW.refusal(fn.plan, ins, fn.out_clip)}")

        def vec():
            return EW.elementwise(fn.plan, ins, fn.out_clip)

        def general():
            return EW.elementwise(fn.plan, ins, fn.out_clip, path="general")

        want = EW.elementwise_plain(fn.plan, ins, fn.out_clip)
        err = chip_smoke._close(torch, vec(), want, f"{what} vec")
        chip_smoke._close(torch, general(), want, f"{what} general")
        ms, general_ms = timer.turns(vec, general)
        total["ms"] += ms
        total["general_ms"] += general_ms
        nbytes = sum(t.numel() * t.element_size() for t in ins) + want.numel() * want.element_size()
        row = {"unit": what, "out_ext": list(fn.plan.out_ext), "vectors": view.n_vec,
               "blocks": view.blocks(), "ms": ms, "general_ms": general_ms,
               "bound_ms": nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
               "max_abs_err": err, "device_ms": device_ms(torch, vec),
               "general_device_ms": device_ms(torch, general), "card": card}
        if what == "ffn_relu2/bias":
            x, b = ins
            chip_smoke._close(torch, torch.add(x, b), want, "torch.add")
            row["torch_add_ms"] = timer(lambda: torch.add(x, b))
            row["torch_add_device_ms"] = device_ms(torch, lambda: torch.add(x, b))
        print(json.dumps(row), flush=True)
    print(json.dumps({"sum_ms": total["ms"], "sum_general_ms": total["general_ms"],
                      "ratio": total["ms"] / total["general_ms"],
                      "empty_kernel_ms": timer(lambda: EW.empty_launch(dev)),
                      "empty_kernel_device_ms": device_ms(torch, lambda: EW.empty_launch(dev)),
                      "card": card}), flush=True)
    print(json.dumps({"ptxas": EW.resource_usage()}), flush=True)


if __name__ == "__main__":
    main()
