"""Quickstart on the PyTorch/CUDA port: express a tensor op in the Tile
frontend, compile it with the Stripe pass pipeline for the H100, inspect
the optimized IR, and execute it on the plain PyTorch backend and on the
hand-written CUDA contraction kernel.  The twin of ``quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py                # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # the kernel's plain version
"""
import argparse

import numpy as np
import torch

from repro_torch import api


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()

    # 1. A fused linear layer in the Tile language (paper §3.4).
    tp = api.TileProgram("fused_linear")
    tp.input("X", (256, 512))
    tp.input("W", (512, 384))
    tp.input("B", (384,))
    tp.temp("T", (256, 384))
    tp.output("O", (256, 384))
    tp.op("T[i, j] += X[i, c] * W[c, j]")
    tp.op("O[i, j] = relu(T[i, j] + B[j])")
    prog = tp.build()
    assert api.validate_program(prog) == []          # Def. 2 holds

    # 2. Compile with the H100 hardware config: fuse -> autotile ->
    #    stencil -> boundary -> localize -> schedule.
    optimized = api.compile_program(prog, api.get_config("h100"))
    print("=== optimized Stripe IR ===")
    print(optimized.pretty())

    # 3. Execute: the plain PyTorch backend, then the Stripe-compiled
    #    matmul on the contraction kernel (its plain version on the CPU).
    rng = np.random.RandomState(0)
    host = {"X": rng.randn(256, 512).astype(np.float32),
            "W": rng.randn(512, 384).astype(np.float32),
            "B": rng.randn(384).astype(np.float32)}
    arrays = {k: torch.from_numpy(v).to(args.device) for k, v in host.items()}
    want = np.maximum(host["X"] @ host["W"] + host["B"], 0)
    out = api.lower_program_torch(optimized.source)(arrays)["O"]
    np.testing.assert_allclose(out.cpu().numpy(), want, rtol=1e-4, atol=1e-4)
    print("\ntorch backend matches numpy: OK", tuple(out.shape))
    got = api.matmul(arrays["X"], arrays["W"], arrays["B"], act="relu")
    ref = api.matmul_ref(arrays["X"], arrays["W"], arrays["B"], act="relu")
    err = float((got - ref).abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4, atol=1e-4)
    print(f"contraction kernel ({got.device}) matches numpy: OK, max |err| vs matmul_ref {err:.3e}")


if __name__ == "__main__":
    main()
