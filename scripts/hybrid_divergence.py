#!/usr/bin/env python3
"""How far two prefills of the hybrid (zamba2-2.7b) part, block by block,
on one NVIDIA card: ``oplib`` on ``cuda`` against ``torch``, and, as
witnesses that run no kernel of the port, two ``torch`` prefills that
differ only in the projections' rounding or only in the gelu's form.

    python3 scripts/hybrid_divergence.py

zamba2-2.7b at full width and depth (54 Mamba2 layers): seeded random
bf16 weights and the wave's prefill (``chip_smoke.py``'s phase 12: the
serve phase's 4 prompts left-padded to 100 tokens), one
``Model.prefill`` a run. Four runs: ``cuda``; ``torch``;
``torch_split``, the torch backend with each projection summed in
float32 over the two halves of K, rounded to bf16 once, then its
activation (the same products, another order of the sums: a rounding
difference, as the kernel's against cuBLAS's); and ``torch_erf``, the
torch backend with the shared block's gate in gelu's erf form (the
Stripe intrinsic that the ``cuda`` backend runs) instead of the tanh
form. Each run records every block's output
(``chip_smoke.hybrid_blocks``: the shared block's 9 applications and the
54 Mamba2 layers, in order: no residual runs around a Mamba2 layer, so a
block's output is the next block's input). One JSON line a pair, against
``torch``: each block's largest difference over the largest element of
``torch``'s output, the final logits' the same way, and the growth a
block (``growth_a_block``).
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

PROMPT_LENS = (17, 40, 64, 100)
SLOTS = 4


def _split_linear(torch, act_fns):
    """The torch backend's projection with the sums in another order: K
    in two halves, each summed in float32, added, rounded once, then the
    activation in the input's type (as the torch backend applies it)."""
    def linear(x, w, bias=None, act=None):
        assert bias is None, "the hybrid's projections have no bias"
        h = w.shape[0] // 2
        out = (torch.einsum("...k,kn->...n", x[..., :h].float(), w[:h].float())
               + torch.einsum("...k,kn->...n", x[..., h:].float(), w[h:].float())).to(x.dtype)
        return act_fns[act](out) if act else out
    return linear


def _set(obj, name, value):
    """Put ``value`` at ``obj.name`` (``obj[name]`` for a dict); return
    what was there."""
    if isinstance(obj, dict):
        old, obj[name] = obj[name], value
    else:
        old = getattr(obj, name)
        setattr(obj, name, value)
    return old


def _run(torch, model, params, batch, backend, patches):
    """One prefill with ``patches`` ([(object, name, value)]) in force;
    returns every block's output and the logits, as float32."""
    from chip_smoke import hybrid_blocks
    from repro_torch.core import oplib

    kept = []
    saved = [(obj, name, _set(obj, name, value)) for obj, name, value in patches]
    old = oplib.get_backend()
    oplib.set_backend(backend)
    try:
        with hybrid_blocks(kept):
            logits, _ = model.prefill(params, batch, model.init_cache(SLOTS, 128))
            torch.cuda.synchronize()
    finally:
        for obj, name, value in reversed(saved):
            _set(obj, name, value)
        oplib.set_backend(old)
    return [out.float() for _, out in kept], logits.float()


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def growth_a_block(per_block):
    """(d_j / d_i)^(1 / (j - i)) from the first block whose difference d_i
    is not 0 to the last, j, whose difference is under 0.3; None if there
    is no such pair."""
    first = next((i for i, d in enumerate(per_block) if d > 0), None)
    last = max((i for i, d in enumerate(per_block) if 0 < d <= 0.3 and i > (first or 0)),
               default=None)
    if first is None or last is None:
        return None
    return (per_block[last] / per_block[first]) ** (1 / (last - first))


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("hybrid_divergence: needs an NVIDIA card")
    from repro_torch import api
    from repro_torch.nn import attention, core, ssm

    cfg = api.configs.get("zamba2-2.7b")
    model = api.build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(0)
    toks = np.zeros((SLOTS, max(PROMPT_LENS)), np.int32)
    for i, p in enumerate(PROMPT_LENS):
        toks[i, -p:] = rng.randint(1, cfg.vocab, size=p)
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    split = _split_linear(torch, core._ACT)
    runs = {
        "cuda": _run(torch, model, params, batch, "cuda", []),
        "torch": _run(torch, model, params, batch, "torch", []),
        "torch_split": _run(torch, model, params, batch, "torch",
                            [(m, "linear", split) for m in (core, attention, ssm)]),
        "torch_erf": _run(torch, model, params, batch, "torch", [(core._ACT, "gelu", F.gelu)]),
    }
    ref_outs, ref_logits = runs["torch"]
    for name in ("cuda", "torch_split", "torch_erf"):
        outs, logits = runs[name]
        per_block = [_rel(a, b) for a, b in zip(outs, ref_outs)]
        print(json.dumps({"pair": f"{name} against torch", "model": cfg.name,
                          "layers": cfg.n_layers, "blocks": len(per_block),
                          "logits_rel": _rel(logits, ref_logits),
                          "growth_a_block": growth_a_block(per_block),
                          "block_rel": per_block}), flush=True)


if __name__ == "__main__":
    main()
