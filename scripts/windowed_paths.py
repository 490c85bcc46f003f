#!/usr/bin/env python3
"""Time the windowed kernel's paths, and flash attention's, on one NVIDIA
card.

    python3 scripts/windowed_paths.py            # one JSON line per case

For each unit of ResNet-50's conv2_x 3x3 layer (He et al. 2016, Table 1:
NHWC, batch 8, 56x56, 64 -> 64 channels, pad 1) compiled under ``h100``,
in float32, bf16 and int8, it times (CUDA events, median of 15, L2
flushed before every launch) the unit's ``igemm`` path in turns with the
general loop (``path="general"``), and reads each kernel's device time
from a ``torch.profiler`` trace of 20 back-to-back launches (the igemm
kernel and, for int8, the filter's pack pass, apart).  Then llama3-8b's
bf16 prefill attention (B 1, Hq 32, Hkv 8, D 128, S 4096, causal) on the
wgmma kernel in turns with the CUDA-core kernel, beside
``scaled_dot_product_attention``.  Every case is held against the plain
version first, with ``chip_smoke.py``'s tolerances (the flash call also
to ``kernel.wgmma_bound``, element by element); the timer is
``chip_smoke.py``'s.  Exits non-zero without a card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

REPS = 15


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("windowed_paths: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import cache as stripe_cache
    from repro_torch.core.driver import stripe_jit
    from repro_torch.core.hwconfig import get_config
    from repro_torch.explore.runner import _random_arrays
    from repro_torch.explore.workloads import resnet50_conv2_3x3
    from repro_torch.kernels import windowed as WK
    from repro_torch.kernels.flash_attention import kernel as FA

    import chip_smoke

    card = chip_smoke._card_line()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    timer = chip_smoke._Timer(torch, REPS)

    def device_ms(fn, n=20):
        """Device time per launch of each kernel fn launches, by name."""
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

    for dt in ("float32", "bfloat16", "int8"):
        c = stripe_jit(resnet50_conv2_3x3(8, dt), get_config("h100"), "cuda",
                       cache=stripe_cache.CompilationCache(use_disk=False), use_disk=False)
        env = _random_arrays(c.program.source, seed=0, device="cuda")
        for unit, _kind, fns in c._fn.steps:
            for fn in fns:
                ins = [env[i.buf] for i in fn.plan.ins]
                view = WK.conv_view(fn.plan, WK.input_alignment(ins))

                def igemm():
                    return WK.windowed(fn.plan, ins, fn.out_clip)

                def general():
                    return WK.windowed(fn.plan, ins, fn.out_clip, path="general")

                chip_smoke._close(torch, igemm(), fn.plain(env),
                                  f"windowed {dt} {fn.plan.out_ext}")
                ms, general_ms = timer.turns(igemm, general)
                print(json.dumps({
                    "case": f"resnet50_conv2_3x3 b8 {dt}", "unit": list(fn.plan.out_ext),
                    "M": view.M, "N": view.N, "K": view.K, "ctas": view.blocks(),
                    "b_load": view.b_load, "ms": ms, "general_ms": general_ms,
                    "device_ms": device_ms(igemm), "card": card}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, 32, 4096, 128, generator=gen, device="cuda").bfloat16()
    k = torch.randn(1, 8, 4096, 128, generator=gen, device="cuda").bfloat16()
    v = torch.randn(1, 8, 4096, 128, generator=gen, device="cuda").bfloat16()
    what = "flash llama3-8b prefill bf16 S4096 causal"
    got = FA.flash_attention(q, k, v, causal=True)
    want = FA.flash_attention_plain(q, k, v, causal=True)
    err = chip_smoke._close(torch, got, want, what)
    check = chip_smoke._flash_check(torch, FA, what, "wgmma", got, want, q, k, v, True)
    ms, cores_ms = timer.turns(
        lambda: FA.flash_attention(q, k, v, causal=True),
        lambda: FA.flash_attention(q, k, v, causal=True, path="cuda_cores"))
    sdpa_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    print(json.dumps({"case": what, "path": FA.path_of(q.dtype, 128),
                      "ms": ms, "cuda_cores_ms": cores_ms, "sdpa_ms": sdpa_ms,
                      "max_abs_err": err, **check,
                      "device_ms": device_ms(lambda: FA.flash_attention(q, k, v, causal=True),
                                             n=5),
                      "card": card}), flush=True)


if __name__ == "__main__":
    main()
