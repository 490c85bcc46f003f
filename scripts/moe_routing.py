#!/usr/bin/env python3
"""Where two runs of a MoE model part, on one NVIDIA card: the wave with
``oplib`` on ``cuda`` against the wave on ``torch``, and, as a witness
that runs no kernel of the port, two ``torch`` waves that differ only in
the rounding of the attention projections.

    python3 scripts/moe_routing.py                  # qwen3-moe-30b-a3b, 48 layers
    python3 scripts/moe_routing.py --layers 8 --new-tokens 4

Seeded random bf16 weights (as ``chip_smoke.py``'s phase 11), the serve
phase's 4 prompts through ``WaveEngine(model, 4, 128)``, every run
choosing its own experts.  Three runs: ``cuda``; ``torch``; and
``torch_split``, the torch backend with each projection summed in
float32 over the two halves of K and rounded to bf16 once (the same
products, another order of the sums: a rounding difference, as the
kernel's against cuBLAS's).  Two pairs are compared, ``cuda`` against
``torch`` and ``torch_split`` against ``torch``.

For each pair the greedy tokens print first, with each request's first
differing token.  Then one JSON line per call, over the requests whose
tokens so far agree (a request's call j is compared while its tokens
before j agree; after that its inputs differ): each request's logit
difference over its row's largest logit, and every token whose top-k
experts differ between the runs at some layer (a flip), with the second
run's probabilities of its k-th and (k+1)-th experts and their gap, and
whether an earlier layer of the same call had already flipped a token of
the same request (a flip downstream of another).  A summary line per
pair ends.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

PROMPT_LENS = (17, 40, 64, 100)
SLOTS = 4


def _split_linear(torch):
    """The torch backend's projection with the sums in another order: K
    in two halves, each summed in float32, added, rounded once."""
    def linear(x, w, bias=None, act=None):
        assert bias is None and act is None, "the MoE models' projections have neither"
        h = w.shape[0] // 2
        out = (torch.einsum("...k,kn->...n", x[..., :h].float(), w[:h].float())
               + torch.einsum("...k,kn->...n", x[..., h:].float(), w[h:].float()))
        return out.to(x.dtype)
    return linear


def _run(torch, api, model, params, cfg, prompts, new_tokens, backend, split):
    from repro_torch.core import oplib
    from repro_torch.nn import attention, moe

    k = cfg.moe.top_k
    rec = {"rows": [], "routes": []}
    layers: list = []
    real_route, real_linear = moe.route, attention.linear

    def recording(p, x, c):
        probs, idx = real_route(p, x, c)
        layers.append(torch.topk(probs, k + 1, dim=-1))
        return probs, idx

    def wrap(fn):
        def call(*a):
            layers.clear()
            logits, cache = fn(*a)
            rec["rows"].append(logits[:, -1, : cfg.vocab].float().cpu())
            rec["routes"].append([(t.indices.cpu(), t.values.cpu()) for t in layers])
            return logits, cache
        return call

    old = oplib.get_backend()
    oplib.set_backend(backend)
    moe.route = recording
    if split:
        attention.linear = _split_linear(torch)
    try:
        wrapped = dataclasses.replace(model, prefill=wrap(model.prefill),
                                      decode_step=wrap(model.decode_step))
        engine = api.WaveEngine(wrapped, SLOTS, 128)
        for uid, p in enumerate(prompts):
            engine.submit(api.Request(uid=uid, prompt=p, sampling=api.SamplingParams(
                max_new_tokens=new_tokens)))
        done = engine.run(params)
    finally:
        moe.route, attention.linear = real_route, real_linear
        oplib.set_backend(old)
    rec["tokens"] = {r.uid: list(r.out_tokens) for r in done}
    return rec


def _compare(a, b, k, pair, cfg) -> dict:
    """Per call, over the requests whose tokens so far agree: the logit
    differences and every flipped token's gap (see the module's doc)."""
    div = {u: next((j for j, (x, y) in enumerate(zip(a["tokens"][u], b["tokens"][u]))
                    if x != y), None) for u in sorted(a["tokens"])}
    print(json.dumps({"pair": pair, "tokens_a": a["tokens"], "tokens_b": b["tokens"],
                      "first_divergence": div}), flush=True)
    summary = {"pair": pair, "max_logit_rel_diff": 0.0, "flips": 0, "first_flips": 0,
               "first_flip_gap": [None, None], "flip_gap": [None, None],
               "calls_with_flips": []}

    def widen(span, g):
        span[0] = g if span[0] is None else min(span[0], g)
        span[1] = g if span[1] is None else max(span[1], g)

    for j, (ra, rb) in enumerate(zip(a["rows"], b["rows"])):
        live = [u for u in div if div[u] is None or j <= div[u]]
        if not live:
            break
        rel = {u: ((ra[u] - rb[u]).abs().max() / rb[u].abs().max()).item() for u in live}
        summary["max_logit_rel_diff"] = max(summary["max_logit_rel_diff"], *rel.values())
        flips, flipped_rows = [], set()
        for layer, ((ia, _va), (ib, vb)) in enumerate(zip(a["routes"][j], b["routes"][j])):
            per_row = ia.shape[0] // SLOTS
            new_rows = set()
            for t in range(ia.shape[0]):
                u = t // per_row
                if u not in live or set(ia[t, :k].tolist()) == set(ib[t, :k].tolist()):
                    continue
                p_k, p_k1 = vb[t, k - 1].item(), vb[t, k].item()
                flip = {"layer": layer, "request": u, "pos": t % per_row, "p_k": p_k,
                        "p_k_plus_1": p_k1, "gap": p_k - p_k1,
                        "downstream": u in flipped_rows}
                flips.append(flip)
                new_rows.add(u)
                summary["flips"] += 1
                widen(summary["flip_gap"], flip["gap"])
                if not flip["downstream"]:
                    summary["first_flips"] += 1
                    widen(summary["first_flip_gap"], flip["gap"])
            flipped_rows |= new_rows
        if flips:
            summary["calls_with_flips"].append(j)
        print(json.dumps({"pair": pair, "call": j, "model": cfg.name, "layers": cfg.n_layers,
                          "requests_compared": live, "logit_rel_diff": rel,
                          "flips": flips}), flush=True)
    return summary


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="qwen3-moe-30b-a3b")
    ap.add_argument("--layers", type=int, default=None, help="depth (default: the model's)")
    ap.add_argument("--new-tokens", type=int, default=8)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("moe_routing: needs an NVIDIA card")
    from repro_torch import api

    cfg = api.configs.get(args.model)
    cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers)
    model = api.build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, size=p) for p in PROMPT_LENS]
    runs = {name: _run(torch, api, model, params, cfg, prompts, args.new_tokens, backend, split)
            for name, backend, split in (("cuda", "cuda", False), ("torch", "torch", False),
                                         ("torch_split", "torch", True))}
    summaries = [_compare(runs[a], runs[b], cfg.moe.top_k, f"{a} against {b}", cfg)
                 for a, b in (("cuda", "torch"), ("torch_split", "torch"))]
    for s in summaries:
        print(json.dumps({"summary": s}), flush=True)


if __name__ == "__main__":
    main()
