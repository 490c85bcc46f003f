"""How far the hybrid's sharded float32 gradients part from one device as
the Mamba2 stack deepens (ROADMAP C10), beside how far the single-device
gradients move when the weights move by one part in 1e7.

zamba2-2.7b at ``scaled()`` widths (a shared block every 2 Mamba2
layers, no residual path around a Mamba2 layer): for each depth, the
largest gradient leaf's difference over (1 + its largest |g|) between
``sharded_loss_and_grads`` on ``(2, 4)`` ranks and ``loss_and_grads``,
and between ``loss_and_grads`` on the weights and on the weights times
(1 + 1e-7 N(0, 1)).  Both grow alike with depth: the sharded step's
differences are rounding (a psum sums in another order), amplified by
the stack, not a fault; this is why phase 16 trains zamba2 at one group.

    python3 scripts/sharded_depth.py              # ranks on the card
    python3 scripts/sharded_depth.py --device cpu # ranks on the CPU
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="the ranks' device (cuda or cpu)")
    ap.add_argument("--depths", default="2,4,8,12")
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch import tree as T
    from repro_torch.parallel import sharded
    from repro_torch.parallel.spmd import Mesh
    from repro_torch.train.loop import loss_and_grads

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no card: pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda:0" if args.device == "cuda" else "cpu"
    mesh = Mesh(np.array([dev] * 8, dtype=object).reshape(2, 4), ("data", "model"))

    def rel(a, b):
        a, b = a.detach().double(), b.detach().double()
        return float((a - b).abs().max() / (1 + b.abs().max()))

    for depth in (int(d) for d in args.depths.split(",")):
        cfg = api.configs.get("zamba2-2.7b").scaled(vocab=256, n_layers=depth)
        model = api.build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        batch = api.make_batch(cfg, "train", 8, 16, device=dev)
        _, grads = loss_and_grads(model, params, batch, remat=False)
        _, sgrads = sharded.sharded_loss_and_grads(model, mesh, params, batch, timeout=120)
        gen = torch.Generator(device=dev).manual_seed(1)
        moved = T.tree_map(lambda t: (t * (1 + 1e-7 * torch.randn(
            t.shape, generator=gen, device=dev))).detach(), params)
        _, mgrads = loss_and_grads(model, moved, batch, remat=False)
        print(json.dumps({
            "depth": depth, "blocks": depth + -(-depth // cfg.hybrid.shared_attn_every),
            "sharded_vs_single": max(rel(a, b) for a, b in zip(sgrads, grads)),
            "weights_moved_1e-7_vs_single": max(rel(a, b) for a, b in zip(mgrads, grads))}),
            flush=True)


if __name__ == "__main__":
    main()
