#!/usr/bin/env python3
"""Time the contraction kernel's paths on one NVIDIA card.

    python3 scripts/contraction_paths.py            # one JSON line per case

For llama3-8b's projection shapes at decode (4 rows) and prefill (128
rows), the stripe_matmul product, the corpus' ``ffn_relu2/mm2`` shape
and the 1024-cube bf16 and int8 matmuls, it times (CUDA events, median
of 15, L2 flushed before every launch):

* the GEMM view's path with the split of K the binding chooses
  (``kernels.contraction._splits``: fewest waves per unit of work),
* the same path with the split rule of the first design (a fixed target
  of 4 CTAs a streaming multiprocessor on the skinny path and 2 on the
  tiled one, at least 256 of K a split there),
* the general loop (``path="general"``) and ``torch.matmul``,
* at 4 rows, where the weight's bytes bound the product, one
  ``torch.sum`` over B: a read of the same bytes under the same timer,

and, for the cubes, the same product with B stored [n, k], which TMA reads
in place in both types, against B stored [k, n] (read in place and
transposed by wgmma in bf16, packed K-major in int8).  Every case is held
against the plain version first, with ``chip_smoke.py``'s tolerances; the
timer is ``chip_smoke.py``'s.  Exits non-zero without a card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# (rows, N, K) of float32 products: llama3-8b decode and prefill
# projections (q/o, k/v, gate/up, down), stripe_matmul's timed case and
# the corpus' ffn_relu2 mm2 shape
UNITS = [(4, 4096, 4096), (4, 1024, 4096), (4, 14336, 4096), (4, 4096, 14336),
         (128, 4096, 4096), (128, 1024, 4096), (128, 14336, 4096), (128, 4096, 14336),
         (256, 384, 512), (512, 64, 1024)]
REPS = 15


def first_splits(K, tiles, bk, slots, kmin, kmax, part_cost):
    """The split rule of the first design: a fixed CTA target."""
    from repro_torch.kernels import contraction as C

    skinny = kmax is not None
    target = (4 if skinny else 2) * C.SM_COUNT
    kmin = kmin if skinny else 256
    s = min(max(1, -(-target // tiles)), max(1, K // kmin))
    if skinny:
        s = max(s, -(-K // kmax))
    ks = -(-(-(-K // s)) // bk) * bk
    return -(-K // ks), ks


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("contraction_paths: needs an NVIDIA card", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import cache as C
    from repro_torch.core.driver import stripe_jit
    from repro_torch.core.frontend import TileProgram
    from repro_torch.core.hwconfig import get_config
    from repro_torch.kernels import contraction as K

    import chip_smoke

    timeit = chip_smoke._Timer(torch, REPS)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def unit(m, n, k, dtype="float32", b_kmajor=False):
        tp = TileProgram(f"mm_{m}x{n}x{k}")
        tp.input("A", (m, k), dtype)
        tp.input("B", (n, k) if b_kmajor else (k, n), dtype)
        tp.output("O", (m, n), "int32" if dtype == "int8" else dtype)
        tp.op("O[i, j] += A[i, c] * " + ("B[j, c]" if b_kmajor else "B[c, j]"), name="mm")
        c = stripe_jit(tp.build(), get_config("h100"), "cuda",
                       cache=C.CompilationCache(use_disk=False), use_disk=False)
        (fn,) = [f for _u, _k, fns in c._fn.steps for f in fns]
        shapes = {"A": (m, k), "B": (n, k) if b_kmajor else (k, n)}
        if dtype == "int8":
            env = {b: torch.randint(-3, 4, s, generator=gen, device="cuda").to(torch.int8)
                   for b, s in shapes.items()}
        else:
            env = {b: torch.randn(s, generator=gen, device="cuda").to(getattr(torch, dtype))
                   for b, s in shapes.items()}
        return fn, env

    def held(fn, env, what):
        return chip_smoke._close(torch, fn(env), fn.plain(env), what)

    print(f"card: {chip_smoke._card_line()}", flush=True)
    chosen = K._splits
    for m, n, k in UNITS:
        fn, env = unit(m, n, k)
        row = {"case": f"{m}x{n}x{k} float32", "path": K.plan_path(fn.plan)}
        for rule, splits in (("view", chosen), ("first", first_splits)):
            K._splits = splits
            fn.plan._cparams.clear()
            view = K.gemm_view(fn.plan)
            row[rule] = {"splits": view.splits, "blocks": view.blocks(),
                         "max_abs_err": held(fn, env, row["case"]), "ms": timeit(lambda: fn(env))}
        K._splits = chosen
        fn.plan._cparams.clear()
        row["general_ms"] = timeit(lambda: K.contraction(fn.plan, [env["A"], env["B"]], [],
                                                         path="general"))
        row["library_ms"] = timeit(lambda: torch.matmul(env["A"], env["B"]))
        if m <= K.SKINNY_ROWS:
            row["read_b_ms"] = timeit(lambda: env["B"].sum())
        print(json.dumps(row), flush=True)
    for dtype in ("bfloat16", "int8"):
        for b_kmajor in (False, True):
            fn, env = unit(1024, 1024, 1024, dtype, b_kmajor)
            view = K.gemm_view(fn.plan)
            what = f"1024^3 {dtype}, B stored {'[n, k]' if b_kmajor else '[k, n]'}"
            print(json.dumps({"case": what, "loads": [view.a.load, view.b.load],
                              "max_abs_err": held(fn, env, what),
                              "ms": timeit(lambda: fn(env))}), flush=True)


if __name__ == "__main__":
    main()
