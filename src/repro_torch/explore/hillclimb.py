"""The roofline hillclimb narrative (formerly ``benchmarks/
stripe_hillclimb.py``) — the paper's technique applied to itself: the
Stripe autotiler iterating a llama-shaped TP matmul shard toward the TPU
roofline, one hypothesis -> change -> re-cost step at a time.

This is the *story* form of the generic coordinate-descent strategy in
``space.SearchSpace.hillclimb``: each named iteration is one move in the
(tiling x stencil x fusion) design space, scored with the same analytic
cost model the sweep runner uses.

The op is the per-chip shard of llama3-8b's LOGITS matmul during
train_4k on the 16x16 mesh: M = 8,192-token microbatch slice, K = 4096,
N = 128256-vocab / 16 model shards = 8,016 — large enough on both output
dims that the tiling decides how often each operand streams from HBM.

Iterations:
  0  flat (untiled) op               — infeasible: tile > VMEM cap
  1  naive square tiles 128^3/512^3  — feasible; HBM-bound
  2  autotile (roofline cost model)  — picks K-resident tiles, fewer fetches
  3  + MXU stencil pass              — aligns to 128x128x128, util -> 1.0
  4  + fusion (bias+silu epilogue)   — removes intermediate HBM round trip

Emits CSV rows: name,us_per_call,derived (us_per_call = modeled step time
of the dominant roofline term; derived = roofline fraction vs MXU peak).
"""
from __future__ import annotations

from ..core.cost import evaluate_tiling
from ..core.frontend import TileProgram, single_op_program
from ..core.hwconfig import get_config
from ..core.passes.autotile import choose_tiling

M, K, N = 8192, 4096, 8016
PARAMS = {"cost": "roofline", "search": "pow2", "mem_cap_frac": 0.45, "count_untiled": True}


def _block():
    prog = single_op_program(
        "O[i, j] += X[i, c] * W[c, j]",
        {"X": ((M, K), "bfloat16"), "W": ((K, N), "bfloat16"), "O": ((M, N), "bfloat16")},
        out="O",
    )
    return prog, prog.entry.stmts[0]


def _default_emit(name, us, derived):
    print(f"{name},{us:.2f},{derived}")


def roofline_hillclimb(emit=_default_emit) -> None:
    """Run the iteration story; ``emit(name, us_per_call, derived)`` rows
    land in the benchmark harness's CSV/JSON stream."""
    hw = get_config("tpu_v5e")
    peak = hw.peak_flops
    prog, blk = _block()

    def report(name, cost, extra=""):
        ideal = 2.0 * M * K * N / peak
        t = max(cost.t_mem, cost.t_compute)
        frac = ideal / t if t else 0.0
        emit(f"stripe_hillclimb/{name}", t * 1e6, f"{frac:.4f}{extra}")

    # it0: whole-op "tile" (flat): footprint check
    c0 = evaluate_tiling(blk, {}, hw, PARAMS)
    emit("stripe_hillclimb/flat_infeasible", 0.0, f"{int(c0.feasible)}  # {c0.why or 'fits'}")

    # it1: naive square tiles
    c1 = evaluate_tiling(blk, {"i": 128, "c": 128, "j": 128}, hw, PARAMS)
    report("naive_128cube", c1)
    c1b = evaluate_tiling(blk, {"i": 512, "c": 512, "j": 512}, hw, PARAMS)
    report("naive_512cube", c1b)

    # it2: autotile
    tiles, c2 = choose_tiling(blk, hw, PARAMS)
    report("autotile", c2, extra=f"  # tiles={tiles}")

    # it3: stencil utilization — force MXU multiples
    snapped = {v: max(128, (t // 128) * 128) if t >= 128 else t for v, t in tiles.items()}
    c3 = evaluate_tiling(blk, snapped, hw, {**PARAMS, "stencil": "mxu"})
    report("stenciled", c3, extra=f"  # tiles={snapped}")

    # it4: fusion — bias+silu epilogue folded into the same tiles (the
    # intermediate T never goes to HBM): model it by dropping one full
    # output write + read (2 x M*N*2 bytes)
    import dataclasses

    saved = 2 * (M * N * 2)
    c4 = dataclasses.replace(c3, bytes_hbm=c3.bytes_hbm - saved,
                             t_mem=(c3.bytes_hbm - saved) / hw.mem_units[0].bandwidth)
    report("fused_epilogue", c4)

    # confirm the fused kernel actually builds through the real pipeline
    from ..core.ir import Block
    from ..core.passes import compile_program

    tp = TileProgram("ffn")
    tp.input("X", (M, K), "bfloat16")
    tp.input("W", (K, N), "bfloat16")
    tp.input("B", (N,), "float32")
    tp.temp("T", (M, N))
    tp.output("O", (M, N), "bfloat16")
    tp.op("T[i, j] += X[i, c] * W[c, j]")
    tp.op("O[i, j] = silu(T[i, j] + B[j])")
    out = compile_program(tp.build(), hw)
    blocks = [s for s in out.entry.stmts if isinstance(s, Block)]
    # boundary may split a fused grid into interior/boundary pieces
    fused = len(blocks) >= 1 and all("fused" in b.tags for b in blocks)
    emit("stripe_hillclimb/pipeline_fuses_ffn", 0.0, int(fused))


if __name__ == "__main__":
    roofline_hillclimb()
