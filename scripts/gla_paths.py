#!/usr/bin/env python3
"""Time the chunked GLA kernel's paths on one NVIDIA card.

    python3 scripts/gla_paths.py            # one JSON line per case

For the calls of ``chip_smoke.py``'s phase 8, xlstm-125m's mLSTM (B 8, H
4, S 2048, Dk = Dv = 384, forget-gate bias 3, normalized, q scaled by
Dk^-1/2) and zamba2-2.7b's Mamba2 SSD (B 2, H 80, S 4096, P = N = 64, A
= -(1..16), unnormalized), each in bf16 and in float32 on the same
values, at the chunk the autotiler picks, it times (CUDA events, median
of 15, L2 flushed before every launch, ``chip_smoke.py``'s timer) the
path the call takes (``wgmma`` for bf16, ``tf32x3`` for float32) in turns
with the ``cuda_cores`` kernel on the same inputs, and reads each
kernel's device time from a ``torch.profiler`` trace of 10 back-to-back
calls: the state and output kernels apart, and on tf32x3 the transposed
split copy of v.  Each call is held against the plain version first
(``chip_smoke.py``'s tolerance of its type, and element by element to its
path's bound), and so is the ``cuda_cores`` kernel's.  Exits non-zero without a card.
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
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("gla_paths: needs an NVIDIA card")
    from repro_torch.kernels.mlstm_chunk import kernel as GLA
    from repro_torch.nn.scan_ops import chunked_gla_torch

    import chip_smoke

    card = chip_smoke._card_line()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    timer = chip_smoke._Timer(torch, REPS)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    xb, xh, xs, xd = chip_smoke.XLSTM
    q, k, v = (randn(xb, xh, xs, xd).bfloat16() for _ in range(3))
    f_gate, i_gate = 3.0 + randn(xb, xh, xs), randn(xb, xh, xs)
    sb, sh, ss, sp = chip_smoke.ZAMBA2_SSD
    x, bm, cm = (randn(sb, sh, ss, sp).bfloat16() for _ in range(3))
    dt = F.softplus(randn(sb, sh, ss))
    a = -torch.linspace(1.0, 16.0, sh, device="cuda")
    cases = []
    for ty in (torch.bfloat16, torch.float32):
        name = str(ty).replace("torch.", "")
        cases += [
            (f"mlstm xlstm-125m B{xb} H{xh} S{xs} Dk=Dv={xd} {name}",
             (q.to(ty), k.to(ty), v.to(ty), F.logsigmoid(f_gate),
              torch.exp(torch.clamp(i_gate, max=8.0))),
             {"normalize": True, "scale": xd ** -0.5}, (xb, xh, xs, xd, xd)),
            (f"ssd zamba2-2.7b B{sb} H{sh} S{ss} P=N={sp} {name}",
             (cm.to(ty), bm.to(ty), x.to(ty), dt * a[None, :, None], dt),
             {"normalize": False, "scale": 1.0}, (sb, sh, ss, sp, sp)),
        ]
    for what, ins, kw, dims in cases:
        chunk = GLA.choose_chunk(dims[2], dims[3], dims[4])
        path = GLA.path_of(ins[0].dtype, dims[3], dims[4], chunk)
        got = GLA.chunked_gla(*ins, chunk=chunk, **kw)
        want = chunked_gla_torch(*ins, chunk=chunk, **kw)
        err = chip_smoke._close(torch, got, want, what)
        check = chip_smoke._gla_check(torch, GLA, what, path, got, want, ins, chunk, kw)
        cores = GLA.chunked_gla(*ins, chunk=chunk, **kw, path="cuda_cores")
        cores_err = chip_smoke._close(torch, cores, want, f"{what} (cuda_cores)")
        ms, cores_ms = timer.turns(
            lambda: GLA.chunked_gla(*ins, chunk=chunk, **kw),
            lambda: GLA.chunked_gla(*ins, chunk=chunk, **kw, path="cuda_cores"))
        print(json.dumps({
            "case": f"{what} chunk {chunk}", "path": path, "ms": ms, "cuda_cores_ms": cores_ms,
            "max_abs_err": err, "cuda_cores_max_abs_err": cores_err, **check,
            "device_ms": device_ms(torch, lambda: GLA.chunked_gla(*ins, chunk=chunk, **kw)),
            "cuda_cores_device_ms": device_ms(
                torch, lambda: GLA.chunked_gla(*ins, chunk=chunk, **kw, path="cuda_cores"), n=3),
            "card": card}), flush=True)


if __name__ == "__main__":
    main()
