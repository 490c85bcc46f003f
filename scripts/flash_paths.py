#!/usr/bin/env python3
"""Time flash attention's float32 paths on one NVIDIA card.

    python3 scripts/flash_paths.py          # one JSON line per case

For the float32 calls of ``chip_smoke.py``'s phase 8, llama3-8b's prefill
attention (B 1, Hq 32, Hkv 8, D 128) at S 2048 causal and full and at
Sq 512 < Sk 2048 causal, blocks left to the autotiler, it times (CUDA
events, median of 15, L2 flushed before every launch, ``chip_smoke.py``'s
timer) the ``tf32x3`` path in turns with the ``cuda_cores`` kernel on the
same inputs, and SDPA beside them (the backend PyTorch picks, and its
memory-efficient backend on kv expanded to Hq heads); and it reads each
kernel's device time from a ``torch.profiler`` trace of 10 back-to-back
calls: the split copies of k and v and the main kernel apart.  Each call
is held against the plain version first (``chip_smoke.py``'s float32
tolerance, and element by element to ``kernel.flash_tf32x3_bound``), and
so is the ``cuda_cores`` kernel's.  Exits non-zero without a card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

REPS = 15


def device_ms(torch, fn, n=10) -> dict:
    """Device time per call of each kernel ``fn`` launches, by name."""
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
        sys.exit("flash_paths: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.flash_attention import kernel as FA

    import chip_smoke

    card = chip_smoke._card_line()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    timer = chip_smoke._Timer(torch, REPS)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    b, hq, hkv, d = chip_smoke.LLAMA_ATTN
    for sq, sk, causal, dt in chip_smoke.FLASH_CASES:
        if dt != "float32":
            continue
        q = torch.randn(b, hq, sq, d, generator=gen, device="cuda")
        k = torch.randn(b, hkv, sk, d, generator=gen, device="cuda")
        v = torch.randn(b, hkv, sk, d, generator=gen, device="cuda")
        what = f"flash llama3-8b B{b} Hq{hq} Hkv{hkv} Sq{sq} Sk{sk} D{d} float32 " + \
            ("causal" if causal else "full")
        path = FA.path_of(q.dtype, d)
        got = FA.flash_attention(q, k, v, causal=causal)
        want = FA.flash_attention_plain(q, k, v, causal=causal)
        err = chip_smoke._close(torch, got, want, what)
        check = chip_smoke._flash_check(torch, FA, what, path, got, want, q, k, v, causal)
        cores = FA.flash_attention(q, k, v, causal=causal, path="cuda_cores")
        cores_err = chip_smoke._close(torch, cores, want, f"{what} (cuda_cores)")
        ms, cores_ms = timer.turns(
            lambda: FA.flash_attention(q, k, v, causal=causal),
            lambda: FA.flash_attention(q, k, v, causal=causal, path="cuda_cores"))
        lib, backend = chip_smoke._sdpa(torch, q, k, v, causal)
        print(json.dumps({
            "case": what, "path": path, "ms": ms, "cuda_cores_ms": cores_ms,
            "max_abs_err": err, "cuda_cores_max_abs_err": cores_err, **check,
            "library_ms": chip_smoke._time_library(timer, lib, what), "library": backend,
            "library_efficient_ms": chip_smoke._time_library(
                timer, chip_smoke._sdpa_efficient(torch, q, k, v, causal), f"{what} (efficient)"),
            "device_ms": device_ms(torch, lambda: FA.flash_attention(q, k, v, causal=causal)),
            "cuda_cores_device_ms": device_ms(
                torch, lambda: FA.flash_attention(q, k, v, causal=causal, path="cuda_cores"), n=3),
            "card": card}), flush=True)


if __name__ == "__main__":
    main()
