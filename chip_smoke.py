#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one
NVIDIA card.

    python3 chip_smoke.py                # the full check, one card
    python3 chip_smoke.py --layers 2     # a shorter model for a quick look

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. **build** — compile the CUDA contraction kernel from the sources in
   this checkout (``nvcc`` for ``sm_90a``) and bind it.
2. **kernel vs plain** — every fusion group of the full-width llama3-8b
   serving programs (decode: ``SLOTS`` rows, KV window ``MAX_LEN``;
   prefill: a ``BUCKET``-row prompt bucket) runs on the card through the
   kernel and through its plain PyTorch version on the same inputs; the
   results must agree within ``max|kernel - plain| <= RTOL * (1 + max|plain|)``
   over each unit's output (float32 sums of up to 14336 terms, taken in
   another order: the error grows with the sum's scale, not the element's).
   Each unit is timed with CUDA events (median, L2 flushed before every
   launch), beside its plain version, one ``torch.einsum`` of the same
   contraction (a yardstick the port never calls) and its bound.
3. **stripe_matmul** — the Stripe-compiled matmul (one launch of the same
   kernel) on the cases of tests/test_kernels.py, against its plain
   version and the plain matmul oracle.
4. **serve** — llama3-8b at full width and at its configured dtype
   (``--layers`` deep; random bfloat16 weights from a seeded
   ``torch.Generator``, ~16 GB; bfloat16 activations and KV pages) serves
   4 requests through ``ServingEngine(backend="cuda")``: every request
   must finish ``ok``, every unit of every compiled program must have
   lowered to the kernel with no fallback, and the kernel must have been
   launched at least once per unit per layer per step.  The same requests
   are served again with ``backend="torch"``.  The logits behind every
   greedy token are held between the two backends to ``LOGIT_RTOL`` of the
   row's largest logit, per request up to and including the first token
   where the two differ: bfloat16 re-rounds the residual stream in every
   layer, so two float32 summation orders can flip a near-tie, and after
   a flip the two contexts differ and nothing more is compared.  Within
   the tolerance a flip can only happen where the two tokens' logits are
   within ``2 * LOGIT_RTOL`` of the row's scale.
5. **serve, float32 activations** — the same weights and requests with
   float32 activations and KV pages (the block weights stay bfloat16 and
   are cast per call, as the JAX package's programs do): the two backends'
   greedy tokens must be identical, and their logits agree as above.

The last lines are the kernel summary (JSON), the card's name and power
limit as ``nvidia-smi`` reports them, and the result line
``{"ok": true, "device": {...}}``.  TF32 is off wherever the plain
version and the yardstick run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Data sheet figures of one H100 SXM (dense, no sparsity): the bound of a
# launch is the larger of its bytes over the memory rate and its float32
# operations over the CUDA cores' float32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# float32 sums of up to 14336 terms taken in another order, relative to
# the largest output of the unit
RTOL = 1e-4
# logits of the cuda and torch backends, relative to the row's largest
# logit, after 32 layers of bfloat16 rounding
LOGIT_RTOL = 5e-2
# the serving geometry of the check: decode batch, KV window, page size,
# the prefill bucket of phase 2, and the seed of weights and prompts
SLOTS, MAX_LEN, PAGE_SIZE, BUCKET, SEED = 4, 256, 16, 128, 0
PROMPT_LENS = (17, 40, 64, 100)


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class _Timer:
    """Median CUDA-event time of a callable, with the L2 cache flushed
    before every launch (the serving path meets each weight cold).  A spin
    kernel queued ahead of the start event keeps the card busy while the
    host enqueues the callable, so the time is the card's, not the
    host's."""

    def __init__(self, torch, reps: int):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def _einsum_of(semantic, members):
    """(equation, operand buffers) of the one contraction among a unit's
    semantic members: the yardstick call."""
    from repro_torch.core.flat import _product_leaves, analyze_flat
    from repro_torch.core.ir import Block

    for s in semantic.entry.stmts:
        if isinstance(s, Block) and s.name in members:
            op = analyze_flat(s)
            prod = _product_leaves(op.root)
            if op.agg == "add" and prod is not None:
                letters = {}
                terms = []
                for leaf in prod[0]:
                    axes = [e.terms[0][0] for e in leaf.ref.offsets]
                    for v in axes:
                        letters.setdefault(v, chr(ord("a") + len(letters)))
                    terms.append("".join(letters[v] for v in axes))
                out = "".join(letters[v] for v in op.out_vars)
                return ",".join(terms) + "->" + out, [l.ref.from_buf for l in prod[0]]
    raise AssertionError(f"no contraction among {members}")


def check_units(torch, api, K, cfg, reps: int):
    """Phase 2: every unit of the full-width serving programs, kernel
    against plain.  Returns one row per unit."""
    from repro_torch.core import cache as stripe_cache
    from repro_torch.serving import stripe_decode as sd

    hw = api.get_config("h100")
    jc = sd.EngineLikeConfig(hw=hw, backend="cuda", use_disk=False,
                             cache=stripe_cache.CompilationCache(use_disk=False))
    gen = torch.Generator(device="cuda").manual_seed(1)
    timer = _Timer(torch, reps)
    rows = []
    for phase, m, window in (("decode", SLOTS, MAX_LEN), ("prefill", BUCKET, None)):
        progs = sd.build_programs(cfg, m, jc, kv_window=window)
        for pname in ("qkv", "attn_out", "mlp", "scores", "values"):
            prog = getattr(progs, pname)
            if prog is None:
                continue
            if prog.record.backend != "cuda" or any(
                    b != "cuda" for b in prog.record.block_backends.values()):
                raise AssertionError(f"{phase}/{pname} did not lower to the kernel: "
                                     f"{prog.record.fallback_reasons()}")
            env = {}
            for name, decl in prog.program.buffers.items():
                if name in prog.program.inputs:
                    env[name] = torch.randn(decl.shape, generator=gen, device="cuda")
            for _unit, kind, fns in prog._fn.steps:
                assert kind == "cuda"
                for fn in fns:
                    # every unit reads its inputs from env; group outputs that
                    # feed a later unit are filled by running the units in order
                    got = fn(env)
                    want = fn.plain(env)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    scale = want.abs().max().item()
                    if not torch.isfinite(got).all() or not err <= RTOL * (1 + scale):
                        raise AssertionError(
                            f"{phase}/{pname}/{_unit.name}: kernel and plain differ "
                            f"(max abs {err:.3e}, largest output {scale:.3e})")
                    env[fn.out_buf] = got
                    plan = fn.plan
                    bufs = {s.buf for s in plan.slots + plan.eslots}
                    nbytes = 4 * (sum(env[b].numel() for b in bufs) + got.numel())
                    flops = 2 * plan.output_points() * plan.reduction_points()
                    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    t_ops = flops / F32_FLOPS_PER_S * 1e3
                    eq, ops = _einsum_of(prog.program.source, _unit.members)
                    args = [env[b] for b in ops]
                    rows.append({
                        "unit": f"{phase}/{pname}/{_unit.name}", "m": m,
                        "max_abs_err": err, "max_abs_out": scale,
                        "max_rel_err": err / max(scale, 1e-30),
                        "ms": timer(lambda: fn(env)),
                        "plain_ms": timer(lambda: fn.plain(env)),
                        "library_ms": timer(lambda: torch.einsum(eq, *args)),
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                        "bytes": nbytes, "flops": flops,
                    })
    return rows


def check_matmul(torch, K) -> float:
    """Phase 3: the Stripe-compiled matmul on the card; returns the
    largest error against the plain version."""
    from repro_torch.kernels.stripe_matmul import matmul, matmul_ref
    from repro_torch.kernels.stripe_matmul.kernel import build_matmul_kernel

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    cases = [(m, k, n, None, False) for m, k, n in
             ((128, 128, 128), (256, 512, 384), (64, 96, 32), (512, 256, 128))]
    cases += [(128, 256, 128, act, True) for act in (None, "relu", "tanh", "silu", "square")]
    for m, k, n, act, bias in cases:
        x = torch.randn(m, k, generator=gen, device="cuda")
        w = torch.randn(k, n, generator=gen, device="cuda")
        b = torch.randn(n, generator=gen, device="cuda") if bias else None
        got = matmul(x, w, b, act=act)
        arrays = {"X": x, "W": w, **({"B": b} if bias else {})}
        plain = build_matmul_kernel(m, k, n, act, bias).kernel.plain(arrays)
        ref = matmul_ref(x, w, b, act=act)
        for want in (plain, ref):
            err = (got - want).abs().max().item()
            if not err <= RTOL * (1 + want.abs().max().item()):
                raise AssertionError(f"stripe_matmul {m}x{k}x{n} act={act}: error {err:.3e}")
            worst = max(worst, err)
        bf = matmul(x.bfloat16(), w.bfloat16())
        if bf.dtype != torch.bfloat16 or not torch.isfinite(bf.float()).all():
            raise AssertionError("stripe_matmul bfloat16 inputs")
    return worst


def serve(torch, api, K, cfg, params, backend: str, new_tokens: int):
    """One engine run.  Returns (tokens by uid, the float32 logits behind
    each token by (uid, index) on the host, stats)."""
    import numpy as np
    from repro_torch.models import lm

    engine = api.ServingEngine(
        api.build_model(cfg),
        api.EngineConfig(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE_SIZE,
                         backend=backend))
    step_ms = []
    inner = engine._decode_fn

    def timed(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    # Every greedy token is the argmax of one ``lm._logits`` row: a prefill
    # (one row, for the admitted request that has no token yet) or a decode
    # step (one row per slot, for the slot's next token).
    logits = {}
    head = lm._logits

    def recorded(p, c, x):
        out = head(p, c, x)
        rows = out[:, -1, : c.vocab].float().cpu()
        reqs = [r for r in engine._slot_req if r is not None]
        admitting = [r for r in reqs if not r.out_tokens]
        if admitting:
            logits[admitting[0].uid, 0] = rows[0]
        else:
            for s, r in enumerate(engine._slot_req):
                if r is not None:
                    logits[r.uid, len(r.out_tokens)] = rows[s]
        return out

    engine._decode_fn = timed
    lm._logits = recorded
    rng = np.random.RandomState(SEED)
    for uid, plen in enumerate(PROMPT_LENS):
        engine.submit(api.Request(uid=uid, prompt=rng.randint(1, cfg.vocab, size=plen),
                                  sampling=api.SamplingParams(max_new_tokens=new_tokens)))
    K.launches = 0
    t0 = time.perf_counter()
    try:
        done = engine.run(params)
        torch.cuda.synchronize()
    finally:
        lm._logits = head
    wall = time.perf_counter() - t0
    launched = K.launches
    engine.close()
    if sorted(r.uid for r in done) != list(range(len(PROMPT_LENS))):
        raise AssertionError(f"{backend}: finished {[r.uid for r in done]}")
    for r in done:
        if r.status != "ok" or len(r.out_tokens) != new_tokens:
            raise AssertionError(f"{backend}: request {r.uid} {r.status} {r.error} "
                                 f"({len(r.out_tokens)} tokens)")
    if engine.quarantine_entries():
        raise AssertionError(f"{backend}: quarantine {engine.quarantine_entries()}")
    met = engine.metrics()
    stats = {"dtype": cfg.dtype, "wall_s": wall, "tokens": met["tokens_out"],
             "tok_per_s": met["tokens_out"] / wall,
             "decode_steps": met["decode_steps"],
             "decode_step_ms_median": statistics.median(step_ms),
             "launches": launched}
    if backend == "cuda":
        for name, rec in engine.compile_records().items():
            if (rec.backend != "cuda" or rec.fallback_reasons()
                    or any(b != "cuda" for b in rec.block_backends.values())):
                raise AssertionError(f"{name}: {rec.backend} {rec.fallback_reasons()}")
        want = cfg.n_layers * (9 * met["decode_steps"] + 7 * len(PROMPT_LENS))
        if launched < want:
            raise AssertionError(f"kernel launched {launched} times, the path needs >= {want}")
        stats["launches_needed"] = want
    return {r.uid: list(r.out_tokens) for r in done}, logits, stats


def compare(runs, exact: bool) -> dict:
    """Hold the cuda run against the torch run: per request, the logits
    behind each token up to and including the first token where the two
    differ agree within ``LOGIT_RTOL`` of the row's largest logit; with
    ``exact`` the tokens must not differ at all."""
    (ta, la, _), (tb, lb, _) = runs["cuda"], runs["torch"]
    out = {"max_logit_rel_err": 0.0, "compared": 0, "first_divergence": {}}
    for uid in sorted(ta):
        div = next((j for j, (x, y) in enumerate(zip(ta[uid], tb[uid])) if x != y), None)
        out["first_divergence"][uid] = div
        for j in range(len(ta[uid]) if div is None else div + 1):
            a, b = la[uid, j], lb[uid, j]
            rel = (a - b).abs().max().item() / b.abs().max().item()
            out["max_logit_rel_err"] = max(out["max_logit_rel_err"], rel)
            out["compared"] += 1
            if not rel <= LOGIT_RTOL:
                raise AssertionError(f"request {uid} token {j}: logits differ by {rel:.3e} "
                                     f"of the largest (tolerance {LOGIT_RTOL})")
        if div is not None:
            # the torch run's gap between the two chosen tokens, over the
            # row's largest logit: a near-tie
            b = lb[uid, div]
            out.setdefault("gap_at_divergence", {})[uid] = (
                (b[tb[uid][div]] - b[ta[uid][div]]).item() / b.abs().max().item())
    if exact and any(d is not None for d in out["first_divergence"].values()):
        raise AssertionError(f"greedy tokens differ: cuda {ta} torch {tb}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32, help="model depth (full: 32)")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--reps", type=int, default=10, help="timed launches per unit")
    args = ap.parse_args()

    if not (SRC / "repro_torch" / "csrc" / "contraction.cu").is_file():
        _fail(f"no repro_torch sources under {SRC}: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this check needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from repro_torch import api
    from repro_torch.kernels import contraction as K

    t0 = time.perf_counter()
    K.load_library()
    print(f"build: {K.BUILD_INFO.get('path')} in {time.perf_counter() - t0:.2f} s "
          f"(cached={K.BUILD_INFO.get('cached')})", flush=True)
    for line in str(K.BUILD_INFO.get("ptxas", "")).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    full = api.configs.get("llama3-8b")
    rows = check_units(torch, api, K, full, args.reps)
    print(f"kernel vs plain: {len(rows)} units, tolerance max|k-p| <= {RTOL}*(1+max|p|)")
    for r in rows:
        print("  unit " + json.dumps(r), flush=True)

    mm_err = check_matmul(torch, K)
    print(f"stripe_matmul: 9 cases on the card, max abs error {mm_err:.3e}", flush=True)

    import dataclasses
    cfg = dataclasses.replace(full, n_layers=args.layers)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = api.build_model(cfg).init(gen, device="cuda")
    torch.cuda.synchronize()
    print(f"model: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype} weights, init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card", flush=True)
    # the main path: the configuration as it stands
    runs = {}
    for backend in ("cuda", "torch"):
        runs[backend] = serve(torch, api, K, cfg, params, backend, args.new_tokens)
        print(f"serve[{backend}, {cfg.dtype}]: " + json.dumps(runs[backend][2]), flush=True)
    serve_launches = runs["cuda"][2]["launches"]
    print(f"cuda vs torch, {cfg.dtype}: " + json.dumps(compare(runs, exact=False)), flush=True)

    # float32 activations and KV pages over the same bfloat16 block weights
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = dict(params, embed=params["embed"].float(), unembed=params["unembed"].float(),
                    final_norm={k: v.float() for k, v in params["final_norm"].items()})
    runs32 = {}
    for backend in ("cuda", "torch"):
        runs32[backend] = serve(torch, api, K, cfg32, params32, backend, args.new_tokens)
        print(f"serve[{backend}, float32]: " + json.dumps(runs32[backend][2]), flush=True)
    print("cuda vs torch, float32: " + json.dumps(compare(runs32, exact=True)), flush=True)
    print(f"tokens identical across backends (float32): {runs32['cuda'][0]}")

    decode = [r for r in rows if r["unit"].startswith("decode/")]
    t_bytes = sum(r["bytes"] for r in decode) / HBM_BYTES_PER_S
    t_ops = sum(r["flops"] for r in decode) / F32_FLOPS_PER_S
    summary = {"kernels": [{
        "name": "contraction",
        "route": "cuda",
        "source": "src/repro_torch/csrc/contraction.cu",
        "replaces": "src/repro/core/lower_pallas.py:979",
        "launches": serve_launches,
        "max_abs_err": max(max(r["max_abs_err"] for r in rows), mm_err),
        # one decode layer: the 9 units at SLOTS rows, KV window MAX_LEN
        "ms": sum(r["ms"] for r in decode),
        "plain_ms": sum(r["plain_ms"] for r in decode),
        "bound_ms": sum(r["bound_ms"] for r in decode),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(r["library_ms"] for r in decode),
    }]}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
