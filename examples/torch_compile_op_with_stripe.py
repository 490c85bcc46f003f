"""Deep-dive example on the PyTorch/CUDA port: watch each Stripe pass
transform the IR, reproduce the paper's Fig. 5 rewrite, run the
Stripe-compiled matmul on the hand-written CUDA contraction kernel, and
compile a conv through ``stripe_jit`` on the ``cuda`` backend.  The twin
of ``compile_op_with_stripe.py``.

    PYTHONPATH=src python examples/torch_compile_op_with_stripe.py                # on the card
    PYTHONPATH=src python examples/torch_compile_op_with_stripe.py --device cpu   # plain versions
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import api

# the heading's name of each hardware config's pipeline
PIPELINE = {"tpu_v5e": "TPU", "h100": "H100"}


def fig5_rewrite():
    print("=" * 70)
    print("Paper Fig. 5: conv tiling rewrite (3x4x16 output tile)")
    prog = api.single_op_program(
        "O[x, y, k] += I[x + i - 1, y + j - 1, c] * F[i, j, c, k]",
        {"I": ((12, 16, 8), "int8"), "F": ((3, 3, 8, 16), "int8"),
         "O": ((12, 16, 16), "int32")},
        out="O",
    )
    blk = prog.entry.stmts[0]
    print("--- before (Fig. 5a) ---")
    print(blk.pretty())
    tiled = api.split_block(blk, {"x": 3, "y": 4})
    print("--- after (Fig. 5b): note I view 5x6x8 at [3x-1, 4y-1, 0] ---")
    print(tiled.pretty())


def pass_by_pass(hw_name="h100"):
    print("=" * 70)
    print(f"{PIPELINE.get(hw_name, hw_name)} pipeline, pass by pass, on a 512^3 matmul")
    prog = api.single_op_program(
        "O[i, j] += A[i, c] * B[c, j]",
        {"A": ((512, 512), "float32"), "B": ((512, 512), "float32"),
         "O": ((512, 512), "float32")},
        out="O",
    )
    hw = api.get_config(hw_name)
    for name, params in hw.passes:
        prog = api.get_pass(name)(prog, hw, params)
        blocks = [s for s in prog.entry.stmts if hasattr(s, "tags")]
        tags = [sorted(t for t in b.tags if not t.startswith("sched")) for b in blocks]
        print(f"after {name:10s}: {len(blocks)} block(s), tags={tags}")
    print(prog.pretty()[:1200], "...")


def run_generated_kernel(device="cuda"):
    print("=" * 70)
    print(f"Stripe-compiled matmul on the CUDA contraction kernel ({device})")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(256, 512).astype(np.float32)).to(device)
    w = torch.from_numpy(rng.randn(512, 384).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.randn(384).astype(np.float32)).to(device)
    got = api.matmul(x, w, b, act="relu")
    want = api.matmul_ref(x, w, b, act="relu")
    print("max |err| vs oracle:", float((got - want).abs().max()))


def jit_with_cache(device="cuda"):
    """The unified driver: one call runs frontend -> passes -> lowering
    behind the two-level compilation cache; the second compile is a cache
    hit and skips the autotile search entirely.  On the ``cuda`` backend
    the conv runs on the hand-written windowed kernel."""
    print("=" * 70)
    print("stripe_jit: compile driver + persistent compilation cache")
    cache = api.CompilationCache()  # disk at $STRIPE_CACHE_DIR or ~/.cache/stripe-repro
    text = "O[x, y, k] += I[x + i - 1, y + j - 1, c] * F[i, j, c, k]"
    tensors = {"I": ((12, 16, 8), "float32"), "F": ((3, 3, 8, 16), "float32"),
               "O": ((12, 16, 16), "float32")}
    hw = api.get_config("h100")
    t0 = time.perf_counter()
    compiled = api.jit(text, hw, "cuda", tensors=tensors, out="O", cache=cache, device=device)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    api.jit(text, hw, "cuda", tensors=tensors, out="O", cache=cache, device=device)
    warm = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    ins = {"I": rng.randn(12, 16, 8).astype(np.float32),
           "F": rng.randn(3, 3, 8, 16).astype(np.float32)}
    out = compiled({k: torch.from_numpy(v).to(device) for k, v in ins.items()})["O"]
    want = api.execute_reference(api.single_op_program(text, tensors, out="O"), ins)["O"]
    err = float(np.abs(out.cpu().numpy() - want).max())
    print(f"cold compile {cold*1e3:.1f} ms  (tilings={compiled.record.tilings})")
    print(f"warm compile {warm*1e6:.0f} us  ({cold/warm:.0f}x faster)")
    print(f"output shape {tuple(out.shape)} on {out.device}, max |err| vs the reference "
          f"interpreter {err:.3e}; cache stats {cache.stats.as_dict()}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()
    fig5_rewrite()
    pass_by_pass()
    run_generated_kernel(args.device)
    jit_with_cache(args.device)
