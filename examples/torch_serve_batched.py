"""Continuous-batching serving on the PyTorch/CUDA port: submit a set of
prompts to the paged-KV engine (per-slot admission/eviction, decode
compiled through stripe_jit onto the hand-written CUDA contraction
kernel, greedy sampling), then stream a couple of requests
token-by-token.  The twin of ``serve_batched.py``.

    PYTHONPATH=src python examples/torch_serve_batched.py --arch qwen3-4b
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import api


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()

    cfg = api.configs.get(args.arch).scaled()
    model = api.build_model(cfg)
    params = model.init(torch.Generator(device=args.device).manual_seed(0), device=args.device)
    engine = api.ServingEngine(
        model, api.EngineConfig(slots=4, max_len=64, page_size=8, device=args.device,
                                backend="cuda", hw="h100"))

    rng = np.random.RandomState(0)
    for i in range(args.requests):
        prompt = rng.randint(0, cfg.vocab, size=rng.randint(3, 9)).astype(np.int32)
        engine.submit(api.Request(
            uid=i, prompt=prompt,
            sampling=api.SamplingParams(max_new_tokens=args.new_tokens)))

    done = engine.run(params, max_steps=256)
    for r in sorted(done, key=lambda r: r.uid):
        print(f"req {r.uid}: prompt={list(r.prompt)} -> out={r.out_tokens}")
    m = engine.metrics()
    print(f"{len(done)}/{args.requests} requests completed | "
          f"{m['decode_steps']} decode steps, "
          f"slot utilization {m['slot_utilization']:.0%}")
    rec = engine.compile_records()["decode/mlp"]
    print(f"decode MLP via stripe_jit: {rec.n_kernels} kernels, groups={rec.groups}")

    # streaming API: tokens arrive as they are produced
    print("--- streaming ---")
    stream = engine.generate(
        [rng.randint(0, cfg.vocab, size=5).astype(np.int32) for _ in range(2)],
        params=params, sampling=api.SamplingParams(max_new_tokens=4))
    for uid, tok in stream:
        print(f"  uid={uid} token={tok}")
    engine.close()


if __name__ == "__main__":
    main()
