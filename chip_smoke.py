#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one
NVIDIA card.

    python3 chip_smoke.py                # the full check, one card
    python3 chip_smoke.py --layers 2     # shorter models for a quick look

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. **build** — compile the five CUDA kernels (contraction, elementwise,
   windowed, flash_attention, gla) from the sources in this checkout, one
   ``nvcc`` per source for ``sm_90a``, all started together, and bind
   them.
2. **kernel vs plain** — every fusion group of the full-width llama3-8b
   serving programs (decode: ``SLOTS`` rows, KV window ``MAX_LEN``;
   prefill: a ``BUCKET``-row prompt bucket) runs on the card through the
   kernel and through its plain PyTorch version on the same inputs; the
   results must agree within ``max|kernel - plain| <= RTOL * (1 + max|plain|)``
   over each unit's output (float32 sums of up to 14336 terms, taken in
   another order: the error grows with the sum's scale, not the element's).
   Each unit must take the GEMM view's path (``launches_by_path`` read
   around its launch): ``skinny`` at decode, ``tiled`` at prefill.  Each
   is timed with CUDA events (median, L2 flushed before every launch), in
   turns with the general loop on the same unit (``general_ms``: the
   kernel's design before the GEMM view), beside its plain version, one
   ``torch.einsum`` of the same contraction (a yardstick the port never
   calls) and its bound.
3. **stripe_matmul** — the Stripe-compiled matmul (one launch of the same
   kernel) on the cases of tests/test_kernels.py, against its plain
   version and the plain matmul oracle.
   Then the card's time of one 256x512 @ 512x384 product (``tiled``), in
   turns with the general loop, beside ``torch.matmul``.
4. **corpus units** — every unit of the exploration corpus (``default``
   plus ``conv_mlp`` and ``fig5_conv_f32``) compiled under ``h100`` and
   under ``h100`` without the fusion pass (whose unfused activation, bias
   and gate units run on the elementwise kernel), a bf16 and an
   int8 -> int32 1024-cube matmul (the contraction kernel's 16-bit and
   integer paths), and ResNet-50's conv2_x 3x3 layer (He et al. 2016,
   Table 1: NHWC, batch 8, 56x56, 64 -> 64 channels) in float32, bf16 and
   int8 -> int32 on the windowed kernel: each unit's kernels against
   their plain versions on the same inputs.  Tolerances against the
   unit's largest output: integers exactly; float32 within ``RTOL``;
   bf16 within ``BF16_RTOL`` (kernel and plain round the same float32
   sum to bf16 once each, in different summation orders, which moves the
   result by at most one rounding step, 2**-8 = 3.9e-3 of the element).
   The cubes must run ``tiled`` on ``wgmma``; the 4 ResNet units must run
   the windowed kernel's ``igemm`` path in each type, and the 4
   ``h100-nofuse`` elementwise units (mm_bias_gelu's bias_gelu,
   ffn_relu2's bias and relu2, moe_ffn's gate) the elementwise kernel's
   ``vec`` path (each kernel's ``launches_by_path`` read around each
   launch); every corpus conv prints its windowed path and, where the
   conv view refuses it, why.  Each unit's general loop (the design
   before the GEMM view, the implicit GEMM or the vec path) runs once
   and is held against plain at the same tolerance
   (``general_max_abs_err``).  Each unit is timed as in phase 2, with
   ``general_ms`` (the general loop timed in turns), beside one library
   call of the same function where PyTorch has one (``torch.einsum``,
   ``torch._int_mm``, cuDNN's ``conv2d``, and for a map of one op on
   whole loads that op, such as ``torch.add`` for a bias; none for a
   longer elementwise DAG or an int8 conv), itself held against plain
   where it is a map.  Then one empty kernel's launch, timed the same
   way: the floor no unit's time can beat.
   Then path 4: the same ResNet layer in the three types through the
   compiled programs' entry point, every launch on ``igemm``, the layer
   held against ``conv2d`` in float64 (int8 exactly).
5. **serve** — llama3-8b at full width and at its configured dtype
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
6. **serve, float32 activations** — the same weights and requests with
   float32 activations and KV pages (the block weights stay bfloat16 and
   are cast per call, as the JAX package's programs do): the two backends'
   greedy tokens must be identical, and their logits agree as above.
7. **sweep** — the design-exploration path:
   ``run_sweep(get_space("h100-sweep"), "default", budget=8,
   measure_top_k=3)`` compiles the corpus at 8 points of the H100 design
   space, ranks them by the cost model, and measures the baseline and the
   top 3 on the card through the ``cuda`` backend.  Every unit of every
   measured point must have run on its kernel, and each of the three
   kernels must have been launched; the best predicted point's programs
   are then held against the ``torch`` backend.
8. **attention and recurrence kernels** — the entry points
   ``kernels.flash_attention.flash_attention``,
   ``kernels.mlstm_chunk.mlstm_chunk`` and ``kernels.ssd_chunk.ssd_chunk``
   at the full width of the models that use them, blocks and chunks left
   to the autotiler: llama3-8b's prefill attention (B 1, Hq 32, Hkv 8,
   D 128) in bf16 at S 4096 causal, in float32 at S 2048 causal and full,
   and causal with Sq 512 < Sk 2048 (top-left mask); xlstm-125m's mLSTM
   (arXiv:2405.04517: inner 1536, 4 heads, Dk = Dv = 384, B 8, S 2048,
   bf16, forget-gate bias 3); zamba2-2.7b's Mamba2 SSD (80 heads, P = N =
   64, B 2, S 4096, bf16, A = -(1..16), D = 1); the mLSTM and SSD calls
   again in float32 on the same values.  Inputs come from a CUDA
   ``torch.Generator``.  Each output is held against the kernel's plain
   version on the same inputs (``RTOL`` / ``BF16_RTOL`` of the largest
   plain output, by the inputs' type; the median plain output is printed
   beside it, for the headroom: the bf16 tolerance can exceed a typical
   output, and the float32 cases hold the same code tightly at these
   shapes) and timed as in phase 2, beside its bound and, for flash,
   ``scaled_dot_product_attention`` (the yardstick; GLA has no single
   PyTorch call).  The bf16 flash call must run the ``wgmma`` kernel and
   the float32 ones ``tf32x3`` (``launches_by_path`` read around each
   call); the wgmma output is also held element by element to
   ``kernel.wgmma_bound`` (one bf16 step plus what rounding P to bf16 can
   move it, about a tenth of the median output here: ``wgmma_excess``,
   the largest error over its bound, must not exceed 1), each tf32x3
   output to ``kernel.flash_tf32x3_bound`` (what splitting every product
   into three tf32 products can move it through the softmax, plus the
   float32 plain version's own error against float64: ``tf32x3_excess``
   <= 1); the CUDA-core design runs on each case's inputs, held against
   plain (``cuda_cores_max_abs_err``) and timed in turns beside it
   (``cuda_cores_ms``).  Beside SDPA as PyTorch picks its backend (the
   math backend for float32 with GQA), the float32 rows time its
   memory-efficient backend on kv expanded to Hq heads outside the timed
   call (``library_efficient_ms``).
   Likewise the bf16 mLSTM and SSD calls must run the GLA kernel's
   ``wgmma`` path and the float32 ones ``tf32x3``; each wgmma output is
   held element by element to ``kernel.gla_wgmma_bound`` (what rounding k
   w, the carried state and P to bf16 can move it, through the
   normalizer, plus one bf16 step; ``wgmma_excess`` <= 1), each tf32x3
   output to ``kernel.gla_tf32x3_bound`` (what splitting every product
   into three tf32 products can move it, plus the float32 plain version's
   own error against float64; ``tf32x3_excess`` <= 1), ``norm_rel_err``
   printed beside either, with the CUDA-core kernel run on the same
   inputs, held against plain at its type's tolerance
   (``cuda_cores_max_abs_err``) and timed in turns.  A tf32x3 row's bound
   (flash or GLA) is its bytes against three passes of its operations at
   the tensor cores' TF32 rate, the rate that path computes at; its bound
   at the CUDA cores' float32 rate stands beside it
   (``f32_cuda_core_bound_ms``).
9. **tune** — the tuning path: ``run_sweep(get_space("h100-sweep"),
   "default", budget=8, measure_top_k=3, measure=3, tune_db=TuningDB(<a
   temp dir>))`` on the card.  The measure mode times 3 candidate tilings
   a workload under ``h100``; every workload must have a DB entry measured
   on the card (``interpret`` false), and, for each, how many candidates
   launch distinct unit plans is printed (candidates of one plan differ
   by noise).  Each workload is then compiled with
   ``stripe_jit(..., tune=db)``: the compile must replay the measured
   winner (``decision_source == "tuned"``, every unit on its kernel) and
   its outputs hold against the ``torch`` backend at phase 4's
   tolerances.  The validated points' programs then run profiled on the
   card, twice each (the first call builds the plans' launch parameters
   and is not logged), a calibration
   ``measured ~= a*t_mem + b*t_compute + c`` is fitted from the residual
   rows the log holds (all ``interpret`` false), and the validated points are
   re-scored under it: the measured ranks print beside the predicted
   ones, uncalibrated and calibrated, with ``(a, b, c)``.  The contraction
   and windowed kernels must have been launched.
10. **model** — llama3-8b's own forward at full width with the serve
   phase's weights (``--layers`` deep): ``Model.prefill`` on 4 prompts of
   64 tokens, then 8 greedy ``Model.decode_step``s, with
   ``oplib.set_backend("cuda")`` and again with ``"torch"`` (each after
   one untimed prefill and decode step, which compile and load).  Every
   projection is one launch of the contraction kernel, 7 a layer a call:
   ``tiled`` on ``wgmma`` at prefill, ``skinny`` at decode (read from
   ``launches_by_path`` around each call), every ``oplib`` unit on
   ``cuda``.  After the counted runs, each of the 7 projections, at the
   prefill's m = 256 and the decode's m = 4, runs on seeded tensors of the
   model's type and is held against its kernel's plain version
   (``BF16_RTOL``; the largest error prints as ``ops_max_abs_err``).
   Logits are held between the backends as in phase 5, and the
   prefill and decode-step times print on the host clock (with
   ``torch.cuda.synchronize()``) beside the card's name and power limit.
11. **wave** — the wave engine, the one serving path of the moe and vlm
   families, after llama3-8b's weights are freed: qwen3-moe-30b-a3b at
   full width (``--layers`` deep, 48 by default: d 2048, 32 / 4 heads,
   128 experts top-8, vocab 151936; ~61 GB of seeded random bf16 weights
   drawn on the card, a layer at a time), then internvl2-26b at 4 layers
   and full width (d 6144, 48 / 8 heads, 256 zero patches in front of
   every prompt).  Each serves the serve phase's 4 prompts (16 new tokens:
   one prefill of 4 x 100 rows, 356 for the VLM, and 15 decode steps)
   through ``WaveEngine(model, 4, max_len)`` with ``oplib`` on ``cuda``
   and again on ``torch``: every request must finish; every projection
   (q, k, v, o; and the VLM's dense MLP) must be one launch of the
   contraction kernel a layer a call, ``tiled`` on wgmma at prefill and
   ``skinny`` at decode, ``general`` 0 (read from ``launches_by_path``
   around each call), every ``oplib`` unit on ``cuda``; each projection
   at the prefill's and the decode's rows is held against its kernel's
   plain version (``BF16_RTOL``), and the logits between the backends as
   in phase 5.  For qwen3-moe they are held between two untimed runs
   that take the same expert choices (the torch run replays the cuda
   run's, ``nn.moe.route`` patched): left free, the two backends'
   rounding flips the router's near-ties in a few tokens (the 8th and 9th
   experts' probabilities 5e-7 to 6e-4 apart), so the timed runs'
   free logits are printed beside the held ones, not held.  Two ``torch``
   runs that differ only in the projections' rounding part in the same
   way (``scripts/moe_routing.py``).  The prefill time, the decode-step median (host clock with
   ``torch.cuda.synchronize()``), tokens/s, the peak of
   ``torch.cuda.max_memory_allocated()`` and the launches by path print
   beside the card's name and power limit.

The run order is 1-6, 10, 11, 7, 9, 8: phase 10 reuses the serve phase's
weights, which are freed before phase 11.

Launch counts are read per path: every count is set to 0 just before the
serve phase (path 1), before the sweep (path 2), before phase 8's calls
of the entry points (path 3), before the ResNet layer (path 4), before
phase 9 (path 5), before phase 10's timed calls (path 6) and before
each of phase 11's timed waves (path 7), and read just after each; the
contraction kernel's ``launches_by_path`` (skinny, tiled, general) is
read the same way for the serve, sweep, tune, model and wave paths, and
none of the serve, model and wave paths may launch the general loop; the windowed kernel's (igemm, general) for the sweep, ResNet and
tune paths, the elementwise kernel's (vec, general) for the sweep and
tune paths (and phase 4's units, from their rows), flash attention's and the GLA kernel's (wgmma,
tf32x3, cuda_cores) for path 3, all in
the summary, which lists the six TPU kernels' counterparts
(``stripe_matmul`` rides on the contraction kernel; its launches are
phase 3's).  The
last lines are the kernel summary (JSON), the card's name and power
limit as ``nvidia-smi`` reports them, and the result line
``{"ok": true, "device": {...}}``.  TF32 is off wherever the plain
version and the yardstick run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Data sheet figures of one H100 SXM (dense, no sparsity): the bound of a
# launch is the larger of its bytes over the memory rate and its
# operations over the card's peak rate for the operands' type.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
PEAK_OPS = {"float32": F32_FLOPS_PER_S, "bfloat16": 989e12, "float16": 989e12,
            "int8": 1979e12}
# the tensor cores' dense TF32 rate: the flash and GLA kernels' tf32x3
# paths run every float32 product as three tf32 products at it
TF32_FLOPS_PER_S = 494.7e12
# float32 sums of up to 14336 terms taken in another order, relative to
# the largest output of the unit
RTOL = 1e-4
# bf16 outputs, relative to the unit's largest output: one bf16 rounding
# step (2**-8) of any element, with a 5x margin
BF16_RTOL = 2e-2
# logits of the cuda and torch backends, relative to the row's largest
# logit, after 32 layers of bfloat16 rounding
LOGIT_RTOL = 5e-2
# the serving geometry of the check: decode batch, KV window, page size,
# the prefill bucket of phase 2, and the seed of weights and prompts
SLOTS, MAX_LEN, PAGE_SIZE, BUCKET, SEED = 4, 256, 16, 128, 0
PROMPT_LENS = (17, 40, 64, 100)
# the exploration corpus of phase 4 and the sweep of phase 7
CORPUS = ("mm_bias_gelu", "ffn_relu2", "attn_scores", "moe_ffn", "fig4_conv", "conv_mlp",
          "fig5_conv_f32")
SWEEP = dict(space="h100-sweep", workloads="default", budget=8, measure_top_k=3)
# phase 9: the same sweep with its measure mode (3 candidate tilings a
# workload) into a tuning DB
TUNE = dict(SWEEP, measure=3)
# phase 10: llama3-8b's own prefill (MODEL_BATCH prompts of MODEL_PROMPT
# tokens) and MODEL_STEPS greedy decode steps
MODEL_BATCH, MODEL_PROMPT, MODEL_STEPS = 4, 64, 8
RESNET_BATCH = 8
# phase 11: the wave engine's slots; qwen3-moe-30b-a3b's KV window and
# internvl2-26b's (its 256 zero patches in front of the prompt), and
# internvl2-26b's depth
WAVE_SLOTS = 4
WAVE_MOE, WAVE_MOE_MAX_LEN = "qwen3-moe-30b-a3b", 128
WAVE_VLM, WAVE_VLM_MAX_LEN, WAVE_VLM_LAYERS = "internvl2-26b", 384, 4
# every kernel (its source is csrc/<name>.cu), and those the compiler's
# units launch (the sweep must reach each of these)
KERNEL_MODULES = ("contraction", "elementwise", "windowed", "flash_attention", "gla")
UNIT_KERNELS = ("contraction", "elementwise", "windowed")
# phase 8: llama3-8b attention (B, Hq, Hkv, D) and its cases (S_q, S_k,
# causal, dtype); xlstm-125m's mLSTM (B, heads, S, Dk = Dv); zamba2-2.7b's
# SSD (B, heads, S, P = N)
LLAMA_ATTN = (1, 32, 8, 128)
FLASH_CASES = ((4096, 4096, True, "bfloat16"), (2048, 2048, True, "float32"),
               (2048, 2048, False, "float32"), (512, 2048, True, "float32"))
XLSTM = (8, 4, 2048, 384)
ZAMBA2_SSD = (2, 80, 4096, 64)
# the GLA cases run in the models' type and again in float32 on the same
# values, where RTOL holds the kernel at the same widths
GLA_DTYPES = ("bfloat16", "float32")
# where phases 4 and 7 put their tensors (a rehearsal on the CPU sets
# "cpu": the kernels' plain versions then run, and nothing is launched)
DEVICE = "cuda"


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

    def turns(self, fa, fb) -> tuple:
        """Median times of two callables measured in turns (a b, b a, ...),
        each launch after its own flush: the view's path and the general
        loop on the same unit in the same call."""
        torch = self.torch
        fa()
        fb()
        times = ([], [])
        for i in range(self.reps):
            for j in ((0, 1) if i % 2 == 0 else (1, 0)):
                self.flush.zero_()
                torch.cuda._sleep(2_000_000)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                (fa, fb)[j]()
                b.record()
                b.synchronize()
                times[j].append(a.elapsed_time(b))
        return statistics.median(times[0]), statistics.median(times[1])


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
        want_path = "skinny" if phase == "decode" else "tiled"
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
                    before = dict(K.launches_by_path)
                    got = fn(env)
                    ran = _path_ran(K, before)
                    if ran != want_path:
                        raise AssertionError(f"{phase}/{pname}/{_unit.name} ran {ran}, not "
                                             f"{want_path} ({K.refusal(fn.plan)})")
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
                    lib = _library_call(torch, prog.program.source, _unit.members, env)
                    ms, general_ms = timer.turns(lambda: fn(env),
                                                 lambda: _general(K, fn, env))
                    rows.append({
                        "unit": f"{phase}/{pname}/{_unit.name}", "m": m, "path": ran,
                        "view": _view_desc(K, fn.plan),
                        "max_abs_err": err, "max_abs_out": scale,
                        "max_rel_err": err / max(scale, 1e-30),
                        "ms": ms, "general_ms": general_ms,
                        "plain_ms": timer(lambda: fn.plain(env)),
                        "library_ms": timer(lib),
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                        "bytes": nbytes, "ops": flops, "t_bytes_ms": t_bytes,
                        "t_ops_ms": t_ops,
                    })
    return rows


def _path_ran(K, before) -> str:
    """The one path a single launch took, from the ``launches_by_path`` of
    kernel module ``K``."""
    ran = [p for p, n in K.launches_by_path.items() if n != before[p]]
    if len(ran) != 1 or K.launches_by_path[ran[0]] != before[ran[0]] + 1:
        raise AssertionError(f"one launch moved launches_by_path from {before} to "
                             f"{K.launches_by_path}")
    return ran[0]


def _general(K, fn, env):
    """The same unit through the general loop (the contraction's design
    before its GEMM view, the windowed kernel's before its implicit GEMM,
    the elementwise kernel's before its vec path), for timing beside the
    view's path."""
    plan = fn.plan
    if fn.kernel == "windowed":
        return _kernel_modules()["windowed"].windowed(
            plan, [env[i.buf] for i in plan.ins], fn.out_clip, path="general")
    if fn.kernel == "elementwise":
        return _kernel_modules()["elementwise"].elementwise(
            plan, [env[s.buf] for s in plan.ins], fn.out_clip, path="general")
    return K.contraction(plan, [env[s.buf] for s in plan.slots],
                         [env[s.buf] for s in plan.eslots],
                         getattr(fn, "out_clip", fn.out_shape), path="general")


def _conv_desc(WK, plan, ins) -> dict:
    aligned = WK.input_alignment(ins)
    view = WK.conv_view(plan, aligned)
    if view is None:
        return {"path": "general", "reason": WK.refusal(plan, aligned)}
    return {"path": "igemm", "mma": view.mma, "M": view.M, "N": view.N, "K": view.K,
            "kc": view.kc, "tile": list(view.tile), "stages": view.stages,
            "b_load": view.b_load}


def _ew_desc(EW, plan, ins, clip) -> dict:
    view = EW.vec_view(plan, ins, clip)
    if view is None:
        return {"path": "general", "reason": EW.refusal(plan, ins, clip)}
    return {"path": "vec", "vectors": view.n_vec, "clipped": view.clipped,
            "blocks": view.blocks()}


def _view_desc(K, plan) -> dict:
    view = K.gemm_view(plan)
    if view is None:
        return {"path": "general", "reason": K.refusal(plan)}
    return {"path": view.path, "mma": view.mma, "M": view.M, "N": view.N, "K": view.K,
            "batch": list(view.batch_ext), "tile": list(view.tile), "stages": view.stages,
            "splits": view.splits, "deferred": view.deferred,
            "loads": [view.a.load, view.b.load]}


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


def time_matmul(torch, K, timer) -> dict:
    """The card's time of one stripe_matmul launch (256x512 @ 512x384,
    float32) beside its plain version and ``torch.matmul``."""
    from repro_torch.kernels.stripe_matmul import matmul
    from repro_torch.kernels.stripe_matmul.kernel import build_matmul_kernel

    m, k, n = 256, 512, 384
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(m, k, generator=gen, device="cuda")
    w = torch.randn(k, n, generator=gen, device="cuda")
    kernel = build_matmul_kernel(m, k, n, None, False).kernel
    plain = kernel.plain
    t_bytes = 4 * (m * k + k * n + m * n) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / F32_FLOPS_PER_S * 1e3
    before = dict(K.launches_by_path)
    matmul(x, w)
    ran = _path_ran(K, before)
    if ran != "tiled":
        raise AssertionError(f"stripe_matmul {m}x{k}x{n} ran {ran}")
    ms, general_ms = timer.turns(lambda: matmul(x, w),
                                 lambda: _general(K, kernel, {"X": x, "W": w}))
    return {"unit": f"stripe_matmul {m}x{k}x{n} float32", "path": ran,
            "view": _view_desc(K, kernel.plan), "ms": ms, "general_ms": general_ms,
            "plain_ms": timer(lambda: plain({"X": x, "W": w})),
            "library_ms": timer(lambda: torch.matmul(x, w)),
            "bound_ms": max(t_bytes, t_ops), "t_bytes_ms": t_bytes, "t_ops_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ------------------------------------------------------------ new units
def _kernel_modules():
    from repro_torch.kernels import contraction, elementwise, windowed
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.mlstm_chunk import kernel as gla

    return {"contraction": contraction, "elementwise": elementwise, "windowed": windowed,
            "flash_attention": flash, "gla": gla}


def _close(torch, got, want, what: str, tol: float | None = None) -> float:
    """Largest error of ``got`` against ``want`` by output type (integers
    exactly; float32 within RTOL, bf16 within BF16_RTOL, of the largest
    output; ``tol`` in place of either); raises past it."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} against "
                             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.double(), want.double()
    err = (g - w).abs().max().item() if g.numel() else 0.0
    scale = w.abs().max().item() if w.numel() else 0.0
    if not got.dtype.is_floating_point:
        ok = err == 0
    else:
        if tol is None:
            tol = RTOL if got.dtype == torch.float32 else BF16_RTOL
        ok = bool(torch.isfinite(g).all()) and err <= tol * (1 + scale)
    if not ok:
        raise AssertionError(f"{what}: kernel and plain differ (max abs {err:.3e}, "
                             f"largest output {scale:.3e}, tolerance {tol})")
    return err


def _op_rate(dtypes) -> float:
    """The card's peak for a unit's operand types: the slowest type it
    computes in (a float32 operand makes the product float32)."""
    return min(PEAK_OPS.get(str(d).replace("torch.", ""), F32_FLOPS_PER_S) for d in dtypes)


def _live_points(torch, plan, clip) -> int:
    """(output, reduction) points a windowed plan must compute: inside the
    clip and where every constraint holds, counted per tap combination."""
    import itertools
    import math
    from repro_torch.kernels.windowed import _mask

    names = plan.out_vars + plan.red_vars
    ext = dict(zip(names, plan.out_ext + plan.red_ext))
    tap_pos = [names.index(t) for t in plan.taps]
    rest = math.prod(e for v, e in zip(plan.red_vars, plan.red_ext) if v not in plan.taps)
    inside = torch.ones(plan.out_ext, dtype=torch.bool, device=DEVICE)
    for d, c in enumerate(clip):
        coord = torch.zeros(plan.out_ext, dtype=torch.int64, device=DEVICE)
        for i, (dd, coef, e) in enumerate(zip(plan.out_dim, plan.out_coef, plan.out_ext)):
            if dd == d:
                shape = [1] * len(plan.out_ext)
                shape[i] = e
                coord = coord + coef * torch.arange(e, device=DEVICE).reshape(shape)
        inside &= coord < c
    total = 0
    for combo in itertools.product(*[range(ext[t]) for t in plan.taps]):
        m = _mask(plan, combo, tap_pos, DEVICE)
        total += int((inside if m is None else inside & m).sum()) * rest
    return total


def _work(torch, fn, clip, env) -> tuple:
    """(operations, operand types) of one kernel launch."""
    import math

    plan = fn.plan
    if fn.kernel == "contraction":
        types = [env[s.buf].dtype for s in plan.slots]
        return 2 * math.prod(clip) * plan.reduction_points(), types
    if fn.kernel == "windowed":
        types = [env[i.buf].dtype for i in plan.ins]
        per = 2 if plan.n_sides == 2 else 1
        return per * _live_points(torch, plan, clip), types
    types = [env[s.buf].dtype for s in plan.ins]
    n_ops = sum(1 for code, _ in plan.prog if code >= 16)
    return n_ops * math.prod(clip), types


def _library_call(torch, semantic, members, env):
    """One PyTorch call of the unit's function, the yardstick: the
    contraction as ``torch.einsum`` (operands promoted to one type, the
    cast inside the timed call), an int8 matmul as ``torch._int_mm``, a
    float 2-D convolution as cuDNN's ``conv2d``, a map of one op as that
    op (:func:`_map_call`); None for anything else."""
    from repro_torch.core.flat import _product_leaves, analyze_flat
    from repro_torch.core.ir import Block

    for s in semantic.entry.stmts:
        if not (isinstance(s, Block) and s.name in members):
            continue
        op = analyze_flat(s)
        if op.agg == "assign":
            if len(members) == 1:
                return _map_call(torch, semantic, op, env)
            continue
        prod = _product_leaves(op.root)
        if op.agg != "add" or prod is None or len(prod[0]) != 2:
            continue
        leaves = prod[0]
        bufs = [l.ref.from_buf for l in leaves]
        args = [env[b] for b in bufs]
        multi = [any(len(e.terms) > 1 for e in l.ref.offsets) for l in leaves]
        if any(multi):
            x, w = (args[0], args[1]) if multi[0] else (args[1], args[0])
            if not x.dtype.is_floating_point or w.dim() != 4:
                return None
            pad = w.shape[0] // 2
            lead = x.dim() == 3
            xn = (x[None] if lead else x).permute(0, 3, 1, 2)
            wn = w.permute(3, 2, 0, 1)
            return lambda: torch.nn.functional.conv2d(xn, wn, padding=pad)
        if args[0].dtype == torch.int8 and args[1].dtype == torch.int8:
            return lambda: torch._int_mm(args[0], args[1])
        letters = {}
        terms = []
        for leaf in leaves:
            axes = [e.terms[0][0] for e in leaf.ref.offsets]
            for v in axes:
                letters.setdefault(v, chr(ord("a") + len(letters)))
            terms.append("".join(letters[v] for v in axes))
        eq = ",".join(terms) + "->" + "".join(letters[v] for v in op.out_vars)
        common = torch.promote_types(args[0].dtype, args[1].dtype)
        return lambda: torch.einsum(eq, *[a.to(common) for a in args])
    return None


def _map_call(torch, semantic, op, env):
    """A map of one unary or binary op on whole loads as that one PyTorch
    call (``torch.add`` for a bias add), where each load's indices are a
    suffix of the output's (so torch's broadcast is the map's) and the
    call's type is the output's; else None."""
    from repro_torch.core.lower_torch import _J_BINARY, _J_UNARY, torch_dtype

    n = op.root
    table = _J_UNARY if len(n.args) == 1 else _J_BINARY if len(n.args) == 2 else {}
    if n.kind != "op" or n.op == "cast" or n.op not in table:
        return None
    args = []
    for a in n.args:
        if a.kind != "load":
            return None
        axes = []
        for e in a.ref.offsets:
            if len(e.terms) != 1 or e.const != 0 or e.terms[0][1] != 1:
                return None
            axes.append(e.terms[0][0])
        t = env[a.ref.from_buf]
        if (axes != op.out_vars[len(op.out_vars) - len(axes):]
                or tuple(t.shape) != tuple(op.ranges[v] for v in axes)):
            return None
        args.append(t)
    out = semantic.buffers[op.out_ref.from_buf]
    kind = torch.result_type(*args) if len(args) == 2 else args[0].dtype
    if (tuple(out.shape) != tuple(op.ranges[v] for v in op.out_vars)
            or kind != torch_dtype(str(out.dtype))):
        return None
    fn = table[n.op]
    return lambda: fn(*args)


def _time_library(timer, lib, what):
    """The yardstick's time, or None where PyTorch has no such call (or
    refuses these operands: the yardstick is not the port)."""
    if lib is None:
        return None
    try:
        return timer(lib)
    except RuntimeError as e:
        print(f"  library call of {what} refused: {str(e).splitlines()[0]}", flush=True)
        return None


def unit_rows(torch, K, LC, timer, label, compiled, env) -> list:
    """Phase 4 for one compiled program: each unit's kernels against their
    plain versions (the unit's output buffer compared whole), timed; the
    kernel's result feeds the units after it.  One row per unit; each row
    names the path its launch took and times the general loop beside it."""
    mods = _kernel_modules()
    buffers = compiled.program.buffers
    semantic = compiled.program.source
    rows = []
    for unit, kind, fns in compiled._fn.steps:
        if kind != "cuda":
            raise AssertionError(f"{label}/{unit.name} is on {kind}")
        outs = {fn.out_buf for fn in fns}
        got_env = {k: v for k, v in env.items() if k not in outs}
        want_env = dict(got_env)
        paths = []
        for fn in fns:
            before = dict(mods[fn.kernel].launches_by_path)
            got_env[fn.out_buf] = LC._place(got_env, buffers[fn.out_buf], fn, fn(env))
            if DEVICE == "cuda":
                paths.append(_path_ran(mods[fn.kernel], before))
            want_env[fn.out_buf] = LC._place(want_env, buffers[fn.out_buf], fn, fn.plain(env))
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        (out,) = outs
        what = f"{label}/{unit.name}"
        err = _close(torch, got_env[out], want_env[out], what)
        ins = {b for fn in fns for b in fn.in_bufs}
        nbytes = (sum(env[b].numel() * env[b].element_size() for b in ins)
                  + got_env[out].numel() * got_env[out].element_size())
        flops, types = 0, []
        for fn in fns:
            f, t = _work(torch, fn, fn.out_clip, env)
            flops += f
            types += t
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / _op_rate(types) * 1e3
        # the general loop on the same unit, held to the same tolerance
        gen_env = {k: v for k, v in env.items() if k not in outs}
        for fn in fns:
            before = dict(mods[fn.kernel].launches_by_path)
            gen_env[fn.out_buf] = LC._place(gen_env, buffers[fn.out_buf], fn,
                                            _general(K, fn, env))
            if DEVICE == "cuda" and _path_ran(mods[fn.kernel], before) != "general":
                raise AssertionError(f"{what}: path='general' ran another path")
        general_err = _close(torch, gen_env[out], want_env[out], f"{what} (general loop)")
        lib = _library_call(torch, semantic, unit.members, env) if semantic else None
        if lib is not None and fns[0].kernel == "elementwise":
            _close(torch, lib(), want_env[out], f"{what} (library call)")

        def run(which, fns=fns):
            for fn in fns:
                if which == "plain":
                    fn.plain(env)
                elif which == "general":
                    _general(K, fn, env)
                else:
                    fn(env)

        env[out] = got_env[out]
        if DEVICE == "cuda":
            ms, general_ms = timer.turns(lambda: run("kernel"), lambda: run("general"))
        else:
            ms, general_ms = timer(lambda: run("kernel")), None
        views = [_view_desc(K, fn.plan) if fn.kernel == "contraction"
                 else _conv_desc(mods["windowed"], fn.plan, [env[i.buf] for i in fn.plan.ins])
                 if fn.kernel == "windowed"
                 else _ew_desc(mods["elementwise"], fn.plan, [env[s.buf] for s in fn.plan.ins],
                               fn.out_clip)
                 for fn in fns]
        rows.append({
            "unit": what, "kernel": sorted({fn.kernel for fn in fns}),
            "launches": len(fns), "dtype": str(got_env[out].dtype).replace("torch.", ""),
            "paths": paths, "views": views,
            "max_abs_err": err, "max_abs_out": got_env[out].double().abs().max().item(),
            "general_max_abs_err": general_err,
            "ms": ms, "general_ms": general_ms, "plain_ms": timer(lambda: run("plain")),
            "library_ms": _time_library(timer, lib, what),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": flops, "t_bytes_ms": t_bytes, "t_ops_ms": t_ops})
    return rows


def _matmul_program(api, dtype: str, n: int = 1024):
    tp = api.TileProgram(f"mm_{dtype}")
    out = "int32" if dtype == "int8" else dtype
    tp.input("A", (n, n), dtype)
    tp.input("B", (n, n), dtype)
    tp.output("O", (n, n), out)
    tp.op("O[i, j] += A[i, c] * B[c, j]", name="mm")
    return tp.build()


def check_new_units(torch, api, K, LC, timer) -> list:
    """Phase 4: the corpus under h100 with and without fusion, the bf16 and
    int8 matmuls (asserted tiled, on wgmma), and the ResNet-50 conv in three
    types."""
    from repro_torch.core import cache as stripe_cache
    from repro_torch.explore.runner import _random_arrays
    from repro_torch.explore.workloads import get_workloads, resnet50_conv2_3x3

    corpus = {w.name: w for w in get_workloads("all")}
    h100 = api.get_config("h100")
    cases = []
    for fuse, hw in (("h100", h100), ("h100-nofuse", h100.without_pass("fuse"))):
        cases += [(f"{fuse}/{name}", corpus[name].build(), hw) for name in CORPUS]
    cases += [(f"h100/mm_{dt}_1024", _matmul_program(api, dt), h100)
              for dt in ("bfloat16", "int8")]
    cases += [(f"h100/resnet50_conv2_3x3_b{RESNET_BATCH}_{dt}",
               resnet50_conv2_3x3(RESNET_BATCH, dt), h100)
              for dt in ("float32", "bfloat16", "int8")]
    rows = []
    for label, prog, hw in cases:
        c = api.jit(prog, hw, "cuda", cache=stripe_cache.CompilationCache(use_disk=False),
                    use_disk=False)
        if set(c.record.block_backends.values()) != {"cuda"}:
            raise AssertionError(f"{label}: {c.record.fallback_reasons()}")
        got = unit_rows(torch, K, LC, timer, label, c,
                        _random_arrays(c.program.source, seed=SEED, device=DEVICE))
        if label.startswith("h100/mm_") and DEVICE == "cuda":
            for r in got:
                if r["paths"] != ["tiled"] or [v.get("mma") for v in r["views"]] != ["wgmma"]:
                    raise AssertionError(f"{r['unit']} ran {r['paths']} {r['views']}, "
                                         "not tiled on wgmma")
        if "/resnet50_" in label:
            ran = [p for r in got for p in r["paths"]]
            if DEVICE == "cuda" and ran != ["igemm"] * 4:
                raise AssertionError(f"{label}: the windowed units ran {ran}, not igemm x 4")
        for r in got:
            if r["kernel"] == ["windowed"] and "/resnet50_" not in label:
                print(f"  windowed path of {r['unit']}: {json.dumps(r['views'])}", flush=True)
        rows += got
    # the unfused activation, bias and gate units take the vec path
    unfused = [r for r in rows if r["unit"].startswith("h100-nofuse/")
               and r["kernel"] == ["elementwise"]]
    ran = [p for r in unfused for p in r["paths"]]
    if DEVICE == "cuda" and ran != ["vec"] * 4:
        raise AssertionError(f"the h100-nofuse elementwise units ran {ran}, not vec x 4: "
                             f"{[r['views'] for r in unfused]}")
    return rows


def empty_floor(torch, timer) -> float:
    """The event time of one empty kernel's launch (phase 4's timer): the
    floor no unit's time can beat."""
    EW = _kernel_modules()["elementwise"]
    return timer(lambda: EW.empty_launch(torch.device("cuda")))


def resnet_path(torch, api) -> dict:
    """Path 4: ResNet-50's conv2_x layer through ``stripe_jit``'s compiled
    entry point, in float32, bf16 and int8, with the windowed kernel's
    counts set to 0 just before and read just after.  Every unit must run
    the igemm path; the layer is held against cuDNN's ``conv2d`` in
    float64 (int8 exactly)."""
    from repro_torch.core import cache as stripe_cache
    from repro_torch.explore.runner import _random_arrays
    from repro_torch.explore.workloads import resnet50_conv2_3x3

    WK = _kernel_modules()["windowed"]
    progs = {dt: api.jit(resnet50_conv2_3x3(RESNET_BATCH, dt), api.get_config("h100"), "cuda",
                         cache=stripe_cache.CompilationCache(use_disk=False), use_disk=False)
             for dt in ("float32", "bfloat16", "int8")}
    envs = {dt: _random_arrays(c.program.source, seed=SEED + 1, device=DEVICE)
            for dt, c in progs.items()}
    WK.launches = 0
    for p in WK.launches_by_path:
        WK.launches_by_path[p] = 0
    outs = {dt: c(envs[dt])["O"] for dt, c in progs.items()}
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    counts = {"launches": WK.launches, "launches_by_path": dict(WK.launches_by_path)}
    if DEVICE == "cuda" and counts["launches_by_path"] != {"igemm": 12, "general": 0}:
        raise AssertionError(f"ResNet path: windowed launches by path {counts}")
    err = {}
    for dt, got in outs.items():
        x = envs[dt]["I"].permute(0, 3, 1, 2).double()
        w = envs[dt]["F"].permute(3, 2, 0, 1).double()
        want = torch.nn.functional.conv2d(x, w, padding=1).permute(0, 2, 3, 1)
        err[dt] = _close(torch, got, want.to(got.dtype), f"ResNet conv2_x {dt} against conv2d")
    counts["max_abs_err_vs_conv2d"] = err
    return counts


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
    mods = _kernel_modules()
    for mod in mods.values():
        mod.launches = 0
    for p in K.launches_by_path:
        K.launches_by_path[p] = 0
    t0 = time.perf_counter()
    try:
        done = engine.run(params)
        torch.cuda.synchronize()
    finally:
        lm._logits = head
    wall = time.perf_counter() - t0
    counts = {name: mod.launches for name, mod in mods.items()}
    by_path = dict(K.launches_by_path)
    launched = counts["contraction"]
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
             "launches": launched, "launches_by_kernel": counts,
             "launches_by_path": by_path}
    if backend == "cuda":
        # decode units run skinny, prefill units skinny or tiled by their
        # bucket's rows: none may fall to the general loop
        if by_path["general"] or by_path["skinny"] == 0 or by_path["tiled"] == 0:
            raise AssertionError(f"serve launches by path: {by_path}")
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
    """Hold the cuda run against the torch run (``_held_logits``); with
    ``exact`` the tokens must not differ at all."""
    (ta, la, _), (tb, lb, _) = runs["cuda"], runs["torch"]
    out = _held_logits(ta, tb, lambda u, j: la[u, j], lambda u, j: lb[u, j], "serve")
    for uid, div in out["first_divergence"].items():
        if div is not None:
            # the torch run's gap between the two chosen tokens, over the
            # row's largest logit: a near-tie
            b = lb[uid, div]
            out.setdefault("gap_at_divergence", {})[uid] = (
                (b[tb[uid][div]] - b[ta[uid][div]]).item() / b.abs().max().item())
    if exact and any(d is not None for d in out["first_divergence"].values()):
        raise AssertionError(f"greedy tokens differ: cuda {ta} torch {tb}")
    return out


def _held_logits(ta, tb, la, lb, what: str, hold: bool = True) -> dict:
    """Two runs' greedy tokens, ``ta`` / ``tb`` (request -> tokens), and
    the logits behind them, ``la`` / ``lb`` ((request, j) -> the row behind
    token j): per request, the logits up to and including the first token
    where the two runs differ, each within ``LOGIT_RTOL`` of the row's
    largest logit (without ``hold`` the difference is only measured).
    Past that token the runs' inputs differ, so their logits are not
    compared."""
    out = {"max_logit_rel_err": 0.0, "compared": 0, "first_divergence": {}}
    for uid in sorted(ta):
        div = next((j for j, (x, y) in enumerate(zip(ta[uid], tb[uid])) if x != y), None)
        out["first_divergence"][uid] = div
        for j in range(len(ta[uid]) if div is None else div + 1):
            a, b = la(uid, j), lb(uid, j)
            rel = (a - b).abs().max().item() / b.abs().max().item()
            out["max_logit_rel_err"] = max(out["max_logit_rel_err"], rel)
            out["compared"] += 1
            if hold and not rel <= LOGIT_RTOL:
                raise AssertionError(f"{what} request {uid} token {j}: logits differ by "
                                     f"{rel:.3e} of the largest (tolerance {LOGIT_RTOL})")
    return out


def sweep(torch, api, K) -> dict:
    """Phase 7, the exploration path.  Returns the launch counts of the
    sweep's run (and the contraction kernel's by path) and its validation."""
    mods = _kernel_modules()
    for mod in mods.values():
        mod.launches = 0
    for m in (K, mods["windowed"], mods["elementwise"]):
        for p in m.launches_by_path:
            m.launches_by_path[p] = 0
    t0 = time.perf_counter()
    sw = api.run_sweep(api.get_space(SWEEP["space"]), SWEEP["workloads"],
                       budget=SWEEP["budget"], measure_top_k=SWEEP["measure_top_k"],
                       measure_device=DEVICE)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: mod.launches for name, mod in mods.items()}
    by_path = dict(K.launches_by_path)
    windowed_by_path = dict(mods["windowed"].launches_by_path)
    elementwise_by_path = dict(mods["elementwise"].launches_by_path)
    v = sw.validation
    for e in v["entries"]:
        if e["error"]:
            raise AssertionError(f"sweep point {e['config']}: {e['error']}")
        for wl, backends in e["block_backends"].items():
            if not backends or set(backends.values()) != {"cuda"}:
                raise AssertionError(f"sweep point {e['config']}/{wl}: {backends}")
    missing = [k for k in UNIT_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"the sweep launched no {missing} kernel: {counts}")
    # the best predicted point's programs against the torch backend
    from repro_torch.core import cache as stripe_cache
    from repro_torch.explore.runner import _random_arrays
    from repro_torch.explore.workloads import get_workloads

    best = min(sw.unique_points(), key=lambda p: p.latency_s)
    hw = sw.space.apply(best.point)
    held = 0.0
    for w in get_workloads(SWEEP["workloads"]):
        ref = api.jit(w.build(), hw, "torch", cache=stripe_cache.CompilationCache(use_disk=False),
                      use_disk=False)
        got = api.jit(w.build(), hw, "cuda", cache=stripe_cache.CompilationCache(use_disk=False),
                      use_disk=False)
        arrays = _random_arrays(got.program.source, seed=SEED, device=DEVICE)
        want, out = ref(arrays), got(arrays)
        for name in got.program.outputs:
            held = max(held, _close(torch, out[name], want[name], f"sweep {best.config_name}/"
                                    f"{w.name}/{name} against torch"))
    return {"wall_s": wall, "launches": counts, "launches_by_path": by_path,
            "windowed_launches_by_path": windowed_by_path,
            "elementwise_launches_by_path": elementwise_by_path, "validation": v,
            "points": [(p.index, p.config_name, p.latency_s, p.n_kernels, p.dedup_of)
                       for p in sw.points],
            "best": best.config_name, "max_abs_err_vs_torch": held}


def _sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _zero_counts(*mods) -> None:
    for mod in mods:
        mod.launches = 0
        for p in getattr(mod, "launches_by_path", {}):
            mod.launches_by_path[p] = 0


def tune(torch, api, K) -> dict:
    """Phase 9, the tuning path: the sweep's measure mode fills a tuning
    DB from the card, every workload then replays its measured winner
    through ``stripe_jit(tune=)``, and a calibration fitted from profiled
    runs on the card re-ranks the validated points."""
    import tempfile
    from repro_torch.core import cache as stripe_cache
    from repro_torch.explore.runner import _random_arrays, score_config
    from repro_torch.explore.workloads import get_workloads
    from repro_torch.obs import profile as obs_profile
    from repro_torch.tune import (TuningDB, clear_calibrations, fit_calibration,
                                  set_calibration)

    mods = _kernel_modules()
    _zero_counts(*mods.values())
    hw = api.get_config("h100")
    workloads = get_workloads(TUNE["workloads"])
    out = {}
    with tempfile.TemporaryDirectory() as d:
        db = TuningDB(dir=Path(d) / "db")
        t0 = time.perf_counter()
        sw = api.run_sweep(api.get_space(TUNE["space"]), TUNE["workloads"],
                           budget=TUNE["budget"], measure_top_k=TUNE["measure_top_k"],
                           measure=TUNE["measure"], tune_db=db, measure_device=DEVICE)
        _sync(torch)
        out["sweep_wall_s"] = time.perf_counter() - t0
        # every workload: an entry measured on the card under h100
        entries = db.entries().values()
        out["workloads"] = {}
        for w in workloads:
            wl = sw.measurement["workloads"].get(w.name, {"error": "not measured"})
            if wl.get("error"):
                raise AssertionError(f"tune: {w.name}: {wl['error']}")
            mine = [e for e in entries if e["workload"] == w.name
                    and e["hw_fingerprint"] == hw.fingerprint() and e["backend"] == "cuda"
                    and e["interpret"] is (DEVICE == "cpu")]
            if not mine:
                raise AssertionError(f"tune: {w.name} has no DB entry measured on {DEVICE}")
            out["workloads"][w.name] = {k: wl.get(k) for k in (
                "n_candidates", "n_rejected", "n_distinct_plans", "analytic_s", "best_s",
                "improved", "best_same_plan_as_analytic", "speedup_vs_analytic")}
        # the measured winners replay, held against the torch backend
        held = 0.0
        for w in workloads:
            got = api.jit(w.build(), hw, "cuda", cache=stripe_cache.CompilationCache(
                use_disk=False), use_disk=False, tune=db, device=DEVICE)
            if got.record.decision_source != "tuned":
                raise AssertionError(f"tune: {w.name} compiled {got.record.decision_source}")
            if set(got.record.block_backends.values()) != {"cuda"}:
                raise AssertionError(f"tune: {w.name} units {got.record.block_backends}")
            ref = api.jit(w.build(), hw, "torch", cache=stripe_cache.CompilationCache(
                use_disk=False), use_disk=False)
            arrays = _random_arrays(got.program.source, seed=SEED, device=DEVICE)
            want, res = ref(arrays), got(arrays)
            for name in got.program.outputs:
                held = max(held, _close(torch, res[name], want[name],
                                        f"tune {w.name}/{name} tuned against torch"))
            out["workloads"][w.name]["tuned_candidate"] = got.record.tuned["candidate_id"]
        out["max_abs_err_vs_torch"] = held
        # profiled runs on the card: the residual rows the calibration fits
        v = sw.validation
        configs = {e["index"]: (sw.space.base_config() if e["index"] < 0
                                else sw.space.apply(sw.points[e["index"]].point))
                   for e in v["entries"]}
        # two calls each: the log holds the second (on the card, the first
        # builds every plan's launch parameters and is not logged)
        cache = stripe_cache.CompilationCache(disk_dir=Path(d) / "cache")
        for cfg_hw in configs.values():
            for w in workloads:
                c = api.jit(w.build(), cfg_hw, "cuda", cache=cache, use_disk=False,
                            profile=True)
                arrays = _random_arrays(c.program.source, seed=SEED, device=DEVICE)
                c(arrays)
                c(arrays)
        rows = obs_profile.read_residuals(obs_profile.residual_log_path(cache))
        if not rows or any(r["interpret"] is not (DEVICE == "cpu") for r in rows):
            raise AssertionError(f"tune: residual rows {len(rows)}, interpret flags "
                                 f"{sorted({r['interpret'] for r in rows})}")
        measured = {e["index"]: e["measured_total_us"] for e in v["entries"]}
        out["ranks"] = {"predicted": v["predicted_rank"], "measured": v["measured_rank"]}
        out["points"] = [{"index": e["index"], "config": e["config"],
                          "predicted_us": e["predicted_latency_s"] * 1e6,
                          "measured_us": measured[e["index"]]} for e in v["entries"]]
        cal = fit_calibration(rows, hw.fingerprint(), "cuda")
        out["calibration"] = {"a": cal.scale_mem, "b": cal.scale_compute,
                              "c_s": cal.overhead_s, "method": cal.method,
                              "n_pairs": cal.n_pairs, "rows": len(rows)}
        # re-score the validated points with the card's coefficients: the
        # card is one, so the fit applies under every point's fingerprint
        clear_calibrations()
        try:
            for cfg_hw in configs.values():
                set_calibration(dataclasses.replace(cal, hw_fingerprint=cfg_hw.fingerprint()))
            calibrated = {}
            for idx, cfg_hw in configs.items():
                scores, _ = score_config(cfg_hw, workloads,
                                         cache=stripe_cache.CompilationCache(use_disk=False))
                calibrated[idx] = sum(s.latency_s for s in scores.values())
        finally:
            clear_calibrations()
        out["ranks"]["predicted_calibrated"] = sorted(calibrated, key=calibrated.get)
        for row in out["points"]:
            row["calibrated_us"] = calibrated[row["index"]] * 1e6
    counts = {name: mod.launches for name, mod in mods.items()}
    missing = [k for k in ("contraction", "windowed") if counts[k] == 0]
    if DEVICE == "cuda" and missing:
        raise AssertionError(f"phase 9 launched no {missing} kernel: {counts}")
    out["launches"] = counts
    out["launches_by_path"] = dict(K.launches_by_path)
    out["windowed_launches_by_path"] = dict(mods["windowed"].launches_by_path)
    out["elementwise_launches_by_path"] = dict(mods["elementwise"].launches_by_path)
    return out


def _model_ops(cfg):
    """The (k, n, act) of the projections of one layer that go through
    ``oplib``: q, k, v and o, then a dense GLU MLP's 3 (7 a layer); a MoE
    layer's experts are plain ``torch.einsum``s, so 4 a layer."""
    d, hd = cfg.d_model, cfg.hd
    ops = [(d, cfg.n_heads * hd, None), (d, cfg.n_kv_heads * hd, None),
           (d, cfg.n_kv_heads * hd, None), (cfg.n_heads * hd, d, None)]
    if not cfg.moe:
        ops += [(d, cfg.d_ff, cfg.act.split("_")[0]), (d, cfg.d_ff, None), (cfg.d_ff, d, None)]
    return ops


def hold_projections(torch, K, cfg, cases, what: str):
    """Each ``oplib`` projection of ``cfg`` at each (m, path) of ``cases``:
    every unit of its program on ``cuda``, one launch of the contraction
    kernel on ``path`` (``tiled`` on wgmma, or ``skinny``), run on seeded
    tensors of the model's type and held against the kernel's plain
    version (``BF16_RTOL``).  Returns ({op: path}, {op: max abs error})."""
    from repro_torch.core import oplib

    units, op_err = {}, {}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    tdt = getattr(torch, cfg.dtype)
    for m, path in cases:
        for k, n, act in _model_ops(cfg):
            op_name = f"{m}x{k}x{n}{'/' + act if act else ''}"
            op = oplib._compiled_linear(m, k, n, cfg.dtype, "float32", act, False, "cuda")
            if set(op.block_backends.values()) != {"cuda"} or op.block_reasons:
                raise AssertionError(f"{what} linear {op_name}: {op.block_backends} "
                                     f"{op.block_reasons}")
            fns = [fn for _u, _kind, unit_fns in op.cuda_fn.steps for fn in unit_fns]
            for fn in fns:
                view = K.gemm_view(fn.plan)
                if K.plan_path(fn.plan) != path or (path == "tiled" and view.mma != "wgmma"):
                    raise AssertionError(f"{what} linear {op_name}: {K.plan_path(fn.plan)}")
            if len(fns) != 1:
                raise AssertionError(f"{what} linear {op_name}: {len(fns)} kernels, want 1")
            arrays = {"X": torch.randn(m, k, generator=gen, device=DEVICE).to(tdt),
                      "W": (torch.randn(k, n, generator=gen, device=DEVICE)
                            * k ** -0.5).to(tdt)}
            got = op.cuda_fn(arrays)["O"]
            op_err[op_name] = max(op_err.get(op_name, 0.0), _close(
                torch, got, fns[0].plain(arrays), f"{what} linear {op_name} ({path})"))
            units[op_name] = path
    return units, op_err


def model(torch, api, K, cfg, params) -> dict:
    """Phase 10, the model's own forward: ``Model.prefill`` on
    ``MODEL_BATCH`` prompts of ``MODEL_PROMPT`` tokens, then
    ``MODEL_STEPS`` greedy ``decode_step``s, with ``oplib`` on ``cuda`` and
    again on ``torch``; the logits held between the two as the serve phase
    holds them.  Every projection is one launch of the contraction kernel:
    7 a layer a call, tiled (wgmma) at prefill and skinny at decode."""
    from repro_torch.core import oplib

    mdl = api.build_model(cfg)
    batch = api.make_batch(cfg, "prefill", MODEL_BATCH, MODEL_PROMPT, seed=SEED, device=DEVICE)
    max_len = MODEL_PROMPT + MODEL_STEPS
    per_call = len(_model_ops(cfg)) * cfg.n_layers
    old = oplib.get_backend()
    runs = {}
    try:
        for backend in ("cuda", "torch"):
            oplib.set_backend(backend)
            # untimed: compiles the 10 programs and loads each kernel once
            logits, cache = mdl.prefill(params, batch, mdl.init_cache(
                MODEL_BATCH, max_len, device=DEVICE))
            mdl.decode_step(params, cache, logits[:, -1:].argmax(-1).int())
            _sync(torch)
            _zero_counts(K)
            cache = mdl.init_cache(MODEL_BATCH, max_len, device=DEVICE)
            t0 = time.perf_counter()
            logits, cache = mdl.prefill(params, batch, cache)
            _sync(torch)
            prefill_ms = (time.perf_counter() - t0) * 1e3
            by_call = [dict(K.launches_by_path)]
            rows, toks, step_ms = [logits[:, -1].float().cpu()], [], []
            for _ in range(MODEL_STEPS):
                tok = logits[:, -1:].argmax(-1).int()
                toks.append(tok.cpu())
                before = dict(K.launches_by_path)
                _sync(torch)
                t0 = time.perf_counter()
                logits, cache = mdl.decode_step(params, cache, tok)
                _sync(torch)
                step_ms.append((time.perf_counter() - t0) * 1e3)
                by_call.append({p: K.launches_by_path[p] - before[p] for p in before})
                rows.append(logits[:, -1].float().cpu())
            toks.append(logits[:, -1:].argmax(-1).int().cpu())
            runs[backend] = {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
                             "decode_step_ms_median": statistics.median(step_ms),
                             "tokens": torch.cat(toks, 1), "rows": rows,
                             "launches": K.launches, "by_call": by_call}
    finally:
        oplib.set_backend(old)
    cuda, ref = runs["cuda"], runs["torch"]
    if ref["launches"]:
        raise AssertionError(f"the torch backend launched the kernel {ref['launches']} times")
    # 7 launches a layer a call: tiled at prefill, skinny at decode
    want = [{"skinny": 0, "tiled": per_call, "general": 0}] + \
        [{"skinny": per_call, "tiled": 0, "general": 0}] * MODEL_STEPS
    if cuda["by_call"] != want or cuda["launches"] != per_call * (1 + MODEL_STEPS):
        raise AssertionError(f"model launches by call {cuda['by_call']}, want {want}")
    # every CompiledOp unit on the kernel, wgmma at prefill, and each of
    # the 7 projections held against its kernel's plain version on seeded
    # tensors of the model's shapes (after the counted run)
    units, op_err = hold_projections(
        torch, K, cfg, ((MODEL_BATCH * MODEL_PROMPT, "tiled"), (MODEL_BATCH, "skinny")), "model")
    # logits up to each row's first differing token, as the serve phase
    ta, tb = ({r: run["tokens"][r].tolist() for r in range(MODEL_BATCH)} for run in (cuda, ref))
    held = _held_logits(ta, tb, lambda r, j: cuda["rows"][j][r, : cfg.vocab],
                        lambda r, j: ref["rows"][j][r, : cfg.vocab], "model")
    return {"layers": cfg.n_layers, "batch": MODEL_BATCH, "prompt": MODEL_PROMPT,
            "steps": MODEL_STEPS, "units": units, "ops_max_abs_err": op_err,
            "max_abs_err": max(op_err.values()), "max_logit_rel_err": held["max_logit_rel_err"],
            "first_divergence": held["first_divergence"], "launches": cuda["launches"],
            "launches_by_call": {"prefill": cuda["by_call"][0], "decode": cuda["by_call"][1]},
            **{f"{b}_{k}": runs[b][k] for b in runs
               for k in ("prefill_ms", "decode_step_ms_median", "decode_step_ms")}}


def wave(torch, api, K, cfg, max_len: int, new_tokens: int) -> dict:
    """Phase 11 for one model: seeded random weights drawn on the card, a
    layer at a time; the serve phase's prompts through
    ``WaveEngine(model, WAVE_SLOTS, max_len)`` with ``oplib`` on ``cuda``
    and again on ``torch``, each timed run after an untimed one that
    compiles and loads what it calls.  The engine gains no hook: the
    script wraps the ``Model``'s ``prefill`` / ``decode_step``, recording
    each call's launches by path, its time on the host clock (with
    ``torch.cuda.synchronize()``) and the logits behind each greedy token.
    Every projection is one launch of the contraction kernel (4 a layer a
    call for MoE, 7 for a dense MLP): ``tiled`` on wgmma at prefill,
    ``skinny`` at decode, never ``general``; each is then held against its
    kernel's plain version at the prefill's and the decode's rows.

    Without a router the timed runs' logits are held (``_held_logits``).
    A MoE model's untimed ``cuda`` run records each layer's expert choices
    (``nn.moe.route`` patched) and the untimed ``torch`` run replays them,
    and those two runs' logits are held.  Left free, the backends'
    rounding flips the router's near-ties in some tokens (the 8th and 9th
    experts' probabilities 5e-7 to 6e-4 apart), each flip moving that
    token by one expert's share, so the timed runs are compared and
    printed, not held (``scripts/moe_routing.py`` shows the same with two
    ``torch`` runs that differ only in the projections' rounding)."""
    import numpy as np
    from repro_torch.core import oplib
    from repro_torch.nn import moe

    cuda = DEVICE == "cuda"
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    mdl = api.build_model(cfg)
    t0 = time.perf_counter()
    params = mdl.init(gen, device=DEVICE)
    _sync(torch)
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9 if cuda else None
    per_call = len(_model_ops(cfg)) * cfg.n_layers
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab, size=p) for p in PROMPT_LENS]
    plen = max(PROMPT_LENS) + (cfg.frontend_len if cfg.frontend == "patches" else 0)
    routes: list = []  # the recording run's expert choices, call by call, layer by layer
    real_route = moe.route

    def recording(p, x, c):
        probs, idx = real_route(p, x, c)
        routes.append(idx)
        return probs, idx

    def replaying(p, x, c):
        return real_route(p, x, c)[0], next(replay)

    replay = iter(())
    # (run, backend, new tokens, the router in force); an untimed run
    # without a router only compiles and loads, so 2 tokens do
    if cfg.moe:
        plan = (("cuda_routed", "cuda", new_tokens, recording), ("cuda", "cuda", new_tokens, None),
                ("torch_replay", "torch", new_tokens, replaying),
                ("torch", "torch", new_tokens, None))
    else:
        plan = (("cuda_warm", "cuda", 2, None), ("cuda", "cuda", new_tokens, None),
                ("torch_warm", "torch", 2, None), ("torch", "torch", new_tokens, None))
    runs = {}
    old = oplib.get_backend()
    try:
        for run, backend, n_new, route_fn in plan:
            oplib.set_backend(backend)
            if route_fn is replaying:
                replay = iter(routes)
            rec = {"ms": [], "by_call": [], "rows": []}

            def recorded(fn, rec=rec):
                def call(*a):
                    before = dict(K.launches_by_path)
                    _sync(torch)
                    t0 = time.perf_counter()
                    logits, cache = fn(*a)
                    _sync(torch)
                    rec["ms"].append((time.perf_counter() - t0) * 1e3)
                    rec["by_call"].append({p: K.launches_by_path[p] - before[p] for p in before})
                    rec["rows"].append(logits[:, -1, : cfg.vocab].float().cpu())
                    return logits, cache
                return call

            model = dataclasses.replace(mdl, prefill=recorded(mdl.prefill),
                                        decode_step=recorded(mdl.decode_step))
            engine = api.WaveEngine(model, WAVE_SLOTS, max_len, device=DEVICE)
            for uid, prompt in enumerate(prompts):
                engine.submit(api.Request(uid=uid, prompt=prompt,
                                          sampling=api.SamplingParams(max_new_tokens=n_new)))
            _zero_counts(K)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            if route_fn is not None:
                moe.route = route_fn
            t0 = time.perf_counter()
            try:
                done = engine.run(params)
                _sync(torch)
            finally:
                moe.route = real_route
            wall = time.perf_counter() - t0
            if sorted(r.uid for r in done) != list(range(len(PROMPT_LENS))) or any(
                    not r.done or len(r.out_tokens) != n_new for r in done):
                raise AssertionError(f"wave {cfg.name} {run}: finished "
                                     f"{[(r.uid, len(r.out_tokens)) for r in done]}")
            n_tok = sum(len(r.out_tokens) for r in done)
            runs[run] = {
                "backend": backend,
                "tokens": {r.uid: list(r.out_tokens) for r in done}, "rows": rec["rows"],
                "by_call": rec["by_call"], "launches": K.launches,
                "prefill_ms": rec["ms"][0], "decode_step_ms": rec["ms"][1:],
                "decode_step_ms_median": statistics.median(rec["ms"][1:]),
                "wall_s": wall, "tok_per_s": n_tok / wall,
                "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() / 1e9
                                            if cuda else None),
                "compile_log": engine.compile_log()}
    finally:
        oplib.set_backend(old)
    if next(replay, None) is not None:
        raise AssertionError(f"wave {cfg.name}: the replay left recorded routes unused")
    for run, r in runs.items():
        if r["backend"] == "torch":
            if r["launches"]:
                raise AssertionError(f"wave {cfg.name} {run}: the torch backend launched the kernel")
            continue
        calls = len(r["by_call"])
        want = [{"skinny": 0, "tiled": per_call, "general": 0}] + \
            [{"skinny": per_call, "tiled": 0, "general": 0}] * (calls - 1)
        if r["by_call"] != want or r["launches"] != per_call * calls:
            raise AssertionError(f"wave {cfg.name} {run}: launches by call {r['by_call']}, "
                                 f"want {want}")
    units, op_err = hold_projections(
        torch, K, cfg, ((WAVE_SLOTS * plen, "tiled"), (WAVE_SLOTS, "skinny")), f"wave {cfg.name}")

    def held(a, b, hold):
        return _held_logits(runs[a]["tokens"], runs[b]["tokens"],
                            lambda u, j: runs[a]["rows"][j][u], lambda u, j: runs[b]["rows"][j][u],
                            f"wave {cfg.name} {a} against {b}", hold)

    free = held("cuda", "torch", not cfg.moe)
    same = held("cuda_routed", "torch_replay", True) if cfg.moe else free
    del params
    if cuda:
        torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "slots": WAVE_SLOTS, "max_len": max_len, "prefill_rows": WAVE_SLOTS * plen,
            "new_tokens": new_tokens, "init_s": init_s, "weights_gb": weights_gb,
            "units": units, "ops_max_abs_err": op_err, "max_abs_err": max(op_err.values()),
            "max_logit_rel_err": same["max_logit_rel_err"],
            "first_divergence": same["first_divergence"],
            **({"free_routing_max_logit_rel_err": free["max_logit_rel_err"],
                "free_routing_first_divergence": free["first_divergence"]} if cfg.moe else {}),
            "launches": runs["cuda"]["launches"],
            "launches_by_call": {"prefill": runs["cuda"]["by_call"][0],
                                 "decode": runs["cuda"]["by_call"][1]},
            **{f"{b}_{k}": runs[b][k] for b in ("cuda", "torch")
               for k in ("prefill_ms", "decode_step_ms_median", "decode_step_ms", "wall_s",
                         "tok_per_s", "max_memory_allocated_gb", "compile_log")}}


def _sdpa(torch, q, k, v, causal):
    """``scaled_dot_product_attention`` on the same inputs (the yardstick;
    the port never calls it) and the backend torch chose for them."""
    F = torch.nn.functional
    try:
        from torch.nn.attention import SDPBackend

        backend = SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=causal,
                                                     enable_gqa=True)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        backend = f"unknown ({type(e).__name__})"
    return (lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True),
            backend)


def _sdpa_efficient(torch, q, k, v, causal):
    """SDPA's memory-efficient backend on the same inputs, kv expanded to
    Hq heads here, outside the timed call (the backend takes no GQA)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    group = q.shape[1] // k.shape[1]
    ke, ve = (t.repeat_interleave(group, dim=1) for t in (k, v))

    def call():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(q, ke, ve, is_causal=causal)
    return call


def _attention_bound(torch, ins, out, pairs_macs: int) -> dict:
    """Bytes (each input read once, the output written once) over the HBM
    rate against ``pairs_macs`` multiply-adds over the peak of the inputs'
    type."""
    nbytes = sum(t.numel() * t.element_size() for t in ins) + out.numel() * out.element_size()
    ops = 2 * pairs_macs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / _op_rate([ins[0].dtype]) * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "t_bytes_ms": t_bytes, "t_ops_ms": t_ops}


def _tf32x3_bound(row) -> dict:
    """A tf32x3 row's bound: its bytes over the HBM rate against its
    operations run three times (a_hi b_hi + a_hi b_lo + a_lo b_hi) at the
    tensor cores' TF32 rate, which is what that path computes on; beside
    it, for comparison, the same operations once at the CUDA cores'
    float32 rate (the CUDA-core kernel's own bound)."""
    t_ops = 3 * row["ops"] / TF32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(row["t_bytes_ms"], t_ops),
            "bound_by": "bytes" if row["t_bytes_ms"] >= t_ops else "operations",
            "t_ops_ms": t_ops, "f32_cuda_core_bound_ms": row["bound_ms"]}


def _flash_check(torch, FA, what, path, got, want, q, k, v, causal) -> dict:
    """A tensor-core flash kernel held element by element to its path's
    bound: ``kernel.wgmma_bound`` (one bf16 step of each output plus 2**-8
    of the attention of |v|, the most that rounding P to bf16 can move
    it) or ``kernel.flash_tf32x3_bound`` (what the split of every product
    into three tf32 products can move an output through the softmax, plus
    the plain version's own float32 error against float64): the largest
    ratio of error to bound must not exceed 1.  Also the error's norm
    relative to the output's."""
    bound = {"wgmma": FA.wgmma_bound, "tf32x3": FA.flash_tf32x3_bound}[path]
    g, w = got.double(), want.double()
    excess = ((g - w).abs() / bound(q, k, v, want, causal)).max().item()
    if not excess <= 1.0:
        raise AssertionError(f"{what}: {path} kernel off its elementwise bound "
                             f"(largest error / bound {excess:.3f})")
    return {f"{path}_excess": excess, "norm_rel_err": ((g - w).norm() / w.norm()).item()}


def _gla_check(torch, GLA, what, path, got, want, ins, chunk, kw) -> dict:
    """The GLA kernel's output against the plain version's: the error's
    norm relative to the output's, and the largest ratio of error to the
    path's elementwise bound, which must not exceed 1: on the wgmma path
    ``kernel.gla_wgmma_bound`` (what rounding k w, C_prev and P to bf16 can
    move an output, through the normalizer, plus one bf16 step), on the
    tf32x3 path ``kernel.gla_tf32x3_bound`` (what the split of every
    product into three tf32 products can move it, plus the plain version's
    own float32 error against float64)."""
    g, w = got.double(), want.double()
    row = {"norm_rel_err": ((g - w).norm() / w.norm()).item(), "wgmma_excess": None,
           "tf32x3_excess": None}
    bounds = {"wgmma": GLA.gla_wgmma_bound, "tf32x3": GLA.gla_tf32x3_bound}
    if path in bounds:
        bound = bounds[path](*ins, want, chunk, kw["normalize"], kw["scale"])
        key = f"{path}_excess"
        row[key] = ((g - w).abs() / bound).max().item()
        if not row[key] <= 1.0:
            raise AssertionError(f"{what}: GLA {path} path off its elementwise bound "
                                 f"(largest error / bound {row[key]:.3f})")
    return row


def _gla_macs(b, h, s, dk, dv, chunk) -> int:
    """Multiply-adds of the chunk's four products over the whole sequence:
    the scores q k^T and scores @ v on and below the diagonal, q @ C and
    (k w)^T v in full."""
    tri = chunk * (chunk + 1) // 2
    return b * h * (s // chunk) * (tri * (dk + dv) + 2 * chunk * dk * dv)


def check_attention_kernels(torch, timer) -> dict:
    """Phase 8, path 3: the attention and recurrence entry points at full
    width.  Returns the launch counts of the path, one row per case, and
    the largest error per kernel."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.mlstm_chunk import kernel as GLA
    from repro_torch.kernels.mlstm_chunk import choose_chunk, mlstm_chunk
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    from repro_torch.nn.scan_ops import chunked_gla_torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def randn(*shape, dtype="bfloat16"):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(getattr(torch, dtype))

    b, hq, hkv, d = LLAMA_ATTN
    flash_in = [(randn(b, hq, sq, d, dtype=dt), randn(b, hkv, sk, d, dtype=dt),
                 randn(b, hkv, sk, d, dtype=dt)) for sq, sk, _c, dt in FLASH_CASES]
    xb, xh, xs, xd = XLSTM
    mq, mk, mv = (randn(xb, xh, xs, xd) for _ in range(3))
    m_i, m_f = randn(xb, xh, xs), (3.0 + randn(xb, xh, xs, dtype="float32")).bfloat16()
    sb, sh, ss, sp = ZAMBA2_SSD
    sx, sB, sC = (randn(sb, sh, ss, sp) for _ in range(3))
    s_dt = F.softplus(randn(sb, sh, ss, dtype="float32")).bfloat16()
    s_A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, sh, device=DEVICE)))
    s_D = torch.ones(sh, device=DEVICE)
    # the GLA inputs in each of GLA_DTYPES, the same values
    mlstm_in = {ty: [t.to(getattr(torch, ty)) for t in (mq, mk, mv, m_i, m_f)]
                for ty in GLA_DTYPES}
    ssd_in = {ty: [t.to(getattr(torch, ty)) for t in (sx, s_dt, sB, sC)] for ty in GLA_DTYPES}

    mods = _kernel_modules()
    for mod in mods.values():
        mod.launches = 0
    for mod in (FA, GLA):
        for p in mod.launches_by_path:
            mod.launches_by_path[p] = 0
    t0 = time.perf_counter()
    flash_out, flash_paths, gla_paths = [], [], {}
    for (q, k, v), (_sq, _sk, c, _dt) in zip(flash_in, FLASH_CASES):
        before = dict(FA.launches_by_path)
        flash_out.append(FA.flash_attention(q, k, v, causal=c))
        if DEVICE == "cuda":
            flash_paths.append(_path_ran(FA, before))
    m_out, s_out = {}, {}
    for ty in GLA_DTYPES:
        (x, dt, B, C), before = ssd_in[ty], dict(GLA.launches_by_path)
        m_out[ty] = mlstm_chunk(*mlstm_in[ty])
        if DEVICE == "cuda":
            gla_paths[f"mlstm {ty}"] = _path_ran(GLA, before)
        before = dict(GLA.launches_by_path)
        s_out[ty] = ssd_chunk(x, dt, s_A, B, C, s_D)
        if DEVICE == "cuda":
            gla_paths[f"ssd {ty}"] = _path_ran(GLA, before)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: mod.launches for name, mod in mods.items()}
    flash_by_path, gla_by_path = dict(FA.launches_by_path), dict(GLA.launches_by_path)
    for name in ("flash_attention", "gla"):
        if counts[name] == 0:
            raise AssertionError(f"phase 8 launched no {name} kernel: {counts}")
    want_paths = ["wgmma" if dt == "bfloat16" else "tf32x3" for *_x, dt in FLASH_CASES]
    if DEVICE == "cuda" and flash_paths != want_paths:
        raise AssertionError(f"flash paths {flash_paths}, want {want_paths}")
    want_gla = {f"{m} {ty}": "wgmma" if ty == "bfloat16" else "tf32x3"
                for ty in GLA_DTYPES for m in ("mlstm", "ssd")}
    if DEVICE == "cuda" and gla_paths != want_gla:
        raise AssertionError(f"GLA paths {gla_paths}, want {want_gla}")

    rows, worst = [], {"flash_attention": 0.0, "gla": 0.0}

    def hold(what, kernel, got, want, ty):
        tol = RTOL if ty == "float32" else BF16_RTOL
        err = _close(torch, got, want, what, tol)
        worst[kernel] = max(worst[kernel], err)
        w = want.float().abs()
        scale = w.max().item()
        return {"dtype": ty, "max_abs_err": err, "max_abs_out": scale,
                "median_abs_out": w.median().item(), "rtol": tol,
                "tolerance": tol * (1 + scale)}

    for (q, k, v), (sq, sk, causal, dt), got in zip(flash_in, FLASH_CASES, flash_out):
        bq, bk = FA.choose_block_sizes(sq, sk, d)
        what = f"flash llama3-8b B{b} Hq{hq} Hkv{hkv} Sq{sq} Sk{sk} D{d} {dt} " + \
            ("causal" if causal else "full")
        row = {"unit": what, "kernel": "flash_attention", "blocks": [bq, bk]}
        want = FA.flash_attention_plain(q, k, v, causal=causal)
        row.update(hold(what, "flash_attention", got, want, dt))
        row["path"] = FA.path_of(q.dtype, d)
        if row["path"] in ("wgmma", "tf32x3"):
            row.update(_flash_check(torch, FA, what, row["path"], got, want, q, k, v, causal))
        pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
        row.update(_attention_bound(torch, (q, k, v), got, 2 * b * hq * pairs * d))
        if row["path"] == "tf32x3":
            row.update(_tf32x3_bound(row))
        lib, backend = _sdpa(torch, q, k, v, causal)
        if DEVICE == "cuda":
            # the CUDA-core design on the same inputs: held against plain,
            # then timed in turns
            before = FA.launches_by_path["cuda_cores"]
            cores = FA.flash_attention(q, k, v, causal=causal, path="cuda_cores")
            if FA.launches_by_path["cuda_cores"] != before + 1:
                raise AssertionError(f"{what}: path='cuda_cores' launched no CUDA-core kernel")
            row["cuda_cores_max_abs_err"] = _close(torch, cores, want, f"{what} (cuda_cores)")
            row["ms"], row["cuda_cores_ms"] = timer.turns(
                lambda: FA.flash_attention(q, k, v, causal=causal),
                lambda: FA.flash_attention(q, k, v, causal=causal, path="cuda_cores"))
        else:
            row["ms"] = timer(lambda: FA.flash_attention(q, k, v, causal=causal))
        row.update({"plain_ms": timer(lambda: FA.flash_attention_plain(q, k, v, causal=causal)),
                    "library_ms": _time_library(timer, lib, what), "library": backend})
        if dt == "float32" and DEVICE == "cuda":
            row["library_efficient_ms"] = _time_library(
                timer, _sdpa_efficient(torch, q, k, v, causal), f"{what} (efficient)")
        rows.append(row)

    # the GLA rows: each entry point's output against the plain version of
    # the same composition (the SSD adds its D skip in float32 to both),
    # within the tolerance of the inputs' type; the times are of the
    # kernel's own call and its plain version on the same inputs
    for ty in GLA_DTYPES:
        (q, k, v, i_gate, f_gate), (x, dt, B, C) = mlstm_in[ty], ssd_in[ty]
        skip = s_D[None, :, None, None] * x
        for what, out, ins, kw, post, dims in (
                (f"mlstm xlstm-125m B{xb} H{xh} S{xs} Dk=Dv={xd} {ty}", m_out[ty],
                 (q, k, v, F.logsigmoid(f_gate), torch.exp(torch.clamp(i_gate, max=8.0))),
                 {"normalize": True, "scale": xd ** -0.5}, None, (xb, xh, xs, xd, xd)),
                (f"ssd zamba2-2.7b B{sb} H{sh} S{ss} P=N={sp} {ty}", s_out[ty],
                 (C, B, x, dt * s_A[None, :, None], dt),
                 {"normalize": False, "scale": 1.0}, lambda y: y + skip, (sb, sh, ss, sp, sp))):
            chunk = choose_chunk(dims[2], dims[3], dims[4])
            what = f"{what} chunk {chunk}"
            row = {"unit": what, "kernel": "gla", "chunk": chunk}
            want = chunked_gla_torch(*ins, chunk=chunk, **kw)
            row.update(hold(what, "gla", out, want if post is None else post(want), ty))
            row["path"] = GLA.path_of(ins[0].dtype, dims[3], dims[4], chunk)
            # the kernel's own output (the SSD's skip left out), held to its
            # path's elementwise bound
            got = GLA.chunked_gla(*ins, chunk=chunk, **kw)
            row.update(_gla_check(torch, GLA, what, row["path"], got, want, ins, chunk, kw))
            row.update(_attention_bound(torch, ins, want, _gla_macs(*dims, chunk)))
            if row["path"] == "tf32x3":
                row.update(_tf32x3_bound(row))
            if row["path"] in ("wgmma", "tf32x3") and DEVICE == "cuda":
                # the CUDA-core design on the same inputs: held against
                # plain at its type's tolerance, then timed in turns
                before = GLA.launches_by_path["cuda_cores"]
                cores = GLA.chunked_gla(*ins, chunk=chunk, **kw, path="cuda_cores")
                if GLA.launches_by_path["cuda_cores"] != before + 1:
                    raise AssertionError(f"{what}: path='cuda_cores' launched no CUDA-core kernel")
                row["cuda_cores_max_abs_err"] = _close(
                    torch, cores, want, f"{what} (cuda_cores)",
                    RTOL if ty == "float32" else BF16_RTOL)
                row["ms"], row["cuda_cores_ms"] = timer.turns(
                    lambda: GLA.chunked_gla(*ins, chunk=chunk, **kw),
                    lambda: GLA.chunked_gla(*ins, chunk=chunk, **kw, path="cuda_cores"))
            else:
                row["ms"] = timer(lambda: GLA.chunked_gla(*ins, chunk=chunk, **kw))
                row["cuda_cores_ms"] = row["ms"] if row["path"] == "cuda_cores" else None
            row.update({"plain_ms": timer(lambda: chunked_gla_torch(*ins, chunk=chunk, **kw)),
                        "library_ms": None, "library": None})
            rows.append(row)
    return {"wall_s": wall, "launches": counts, "flash_launches_by_path": flash_by_path,
            "gla_launches_by_path": gla_by_path, "rows": rows, "max_abs_err": worst}


def _pick(rows, prefix):
    return [r for r in rows if r["unit"].startswith(prefix)]


def _kernel_entry(name, source, replaces, launches, rows, err) -> dict:
    """One kernel of the summary line, its times the sums over ``rows``
    (the bound: the sum of the rows' bounds, by what bounds most of it)."""
    libs = [r["library_ms"] for r in rows]
    by_bytes = sum(r["t_bytes_ms"] for r in rows) >= sum(r["t_ops_ms"] for r in rows)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err,
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if by_bytes else "operations",
            "library_ms": None if any(x is None for x in libs) else sum(libs)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="depth of llama3-8b and qwen3-moe-30b-a3b (default: full, 32 and 48; "
                         "internvl2-26b runs at most 4)")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--reps", type=int, default=10, help="timed launches per unit")
    args = ap.parse_args()

    if not all((SRC / "repro_torch" / "csrc" / f"{k}.cu").is_file() for k in KERNEL_MODULES):
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
    from repro_torch.core import lower_cuda as LC
    from repro_torch.kernels import _build
    from repro_torch.kernels import contraction as K

    t0 = time.perf_counter()
    _build.build_all()
    for name in KERNEL_MODULES:
        _kernel_modules()[name].load_library()
        info = _build.BUILD_INFO[name]
        print(f"build {name}: {info['path']} (cached={info['cached']})", flush=True)
        for line in str(info.get("ptxas", "")).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build: {len(KERNEL_MODULES)} kernels in {time.perf_counter() - t0:.2f} s", flush=True)

    full = api.configs.get("llama3-8b")
    rows = check_units(torch, api, K, full, args.reps)
    print(f"kernel vs plain: {len(rows)} units, tolerance max|k-p| <= {RTOL}*(1+max|p|)")
    for r in rows:
        print("  unit " + json.dumps(r), flush=True)

    timer = _Timer(torch, args.reps)
    K.launches = 0
    mm_err = check_matmul(torch, K)
    mm_launches = K.launches
    mm_row = time_matmul(torch, K, timer)
    print(f"stripe_matmul: 9 cases on the card, max abs error {mm_err:.3e}", flush=True)
    print("  unit " + json.dumps(mm_row), flush=True)

    t0 = time.perf_counter()
    new_rows = check_new_units(torch, api, K, LC, timer)
    print(f"corpus and ResNet units, kernel vs plain: {len(new_rows)} units in "
          f"{time.perf_counter() - t0:.1f} s; tolerance: integers exact, float32 "
          f"{RTOL}*(1+max|p|), bf16 {BF16_RTOL}*(1+max|p|)", flush=True)
    for r in new_rows:
        print("  unit " + json.dumps(r), flush=True)
    empty_ms = empty_floor(torch, timer)
    print(f"empty kernel: {empty_ms} ms a launch (the timer's floor)", flush=True)
    rn = resnet_path(torch, api)
    print(f"ResNet-50 conv2_x b{RESNET_BATCH} through stripe_jit (f32, bf16, int8): "
          + json.dumps(rn), flush=True)

    cfg = dataclasses.replace(full, n_layers=args.layers or full.n_layers)
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

    t0 = time.perf_counter()
    md = model(torch, api, K, cfg, params)
    print(f"model: Model.prefill ({MODEL_BATCH} x {MODEL_PROMPT} tokens) and {MODEL_STEPS} "
          f"decode_steps, {cfg.n_layers} layers, oplib cuda against torch, in "
          f"{time.perf_counter() - t0:.1f} s; card {card}: " + json.dumps(
              {k: v for k, v in md.items() if not k.endswith("decode_step_ms")}), flush=True)
    print(f"model: prefill {md['cuda_prefill_ms']:.3f} ms (torch {md['torch_prefill_ms']:.3f}), "
          f"decode step median {md['cuda_decode_step_ms_median']:.3f} ms (torch "
          f"{md['torch_decode_step_ms_median']:.3f}), host clock with torch.cuda.synchronize(); "
          f"steps {json.dumps(md['cuda_decode_step_ms'])}; card {card}", flush=True)

    # phase 11: the wave engine, qwen3-moe-30b-a3b at full width and
    # internvl2-26b at 4 layers, on the card alone
    del params, params32
    torch.cuda.empty_cache()
    wv = {}
    for name, max_len, layers in ((WAVE_MOE, WAVE_MOE_MAX_LEN, args.layers),
                                  (WAVE_VLM, WAVE_VLM_MAX_LEN,
                                   min(WAVE_VLM_LAYERS, args.layers or WAVE_VLM_LAYERS))):
        wcfg = api.configs.get(name)
        wcfg = dataclasses.replace(wcfg, n_layers=layers or wcfg.n_layers)
        t0 = time.perf_counter()
        wv[name] = w = wave(torch, api, K, wcfg, max_len, args.new_tokens)
        print(f"wave: {name} {wcfg.n_layers} layers, d_model {wcfg.d_model}, WaveEngine "
              f"{WAVE_SLOTS} slots, prompts {PROMPT_LENS}, {args.new_tokens} new tokens, oplib "
              f"cuda against torch, in {time.perf_counter() - t0:.1f} s; card {card}: "
              + json.dumps({k: v for k, v in w.items() if not k.endswith("decode_step_ms")}),
              flush=True)
        print(f"wave: {name} prefill {w['cuda_prefill_ms']:.3f} ms (torch "
              f"{w['torch_prefill_ms']:.3f}), decode step median "
              f"{w['cuda_decode_step_ms_median']:.3f} ms (torch "
              f"{w['torch_decode_step_ms_median']:.3f}), {w['cuda_tok_per_s']:.2f} tokens/s "
              f"(torch {w['torch_tok_per_s']:.2f}), peak {w['cuda_max_memory_allocated_gb']:.2f} "
              f"GB, host clock with torch.cuda.synchronize(); launches by call "
              f"{json.dumps(w['launches_by_call'])}; steps "
              f"{json.dumps(w['cuda_decode_step_ms'])}; card {card}", flush=True)

    sw = sweep(torch, api, K)
    v = sw["validation"]
    print(f"sweep: {SWEEP} in {sw['wall_s']:.1f} s; launches {json.dumps(sw['launches'])}; "
          f"contraction by path {json.dumps(sw['launches_by_path'])}; windowed by path "
          f"{json.dumps(sw['windowed_launches_by_path'])}; elementwise by path "
          f"{json.dumps(sw['elementwise_launches_by_path'])}", flush=True)
    for p in sw["points"]:
        print(f"  point {json.dumps(p)}")
    for e in v["entries"]:
        print("  measured " + json.dumps({k: e[k] for k in (
            "index", "config", "predicted_latency_s", "measured_total_us", "measured_us")}))
    print(f"sweep ranks (-1 = baseline): predicted {v['predicted_rank']}, measured "
          f"{v['measured_rank']}; every unit of every measured point on its kernel; "
          f"best predicted {sw['best']} against torch: max abs {sw['max_abs_err_vs_torch']:.3e}",
          flush=True)

    tn = tune(torch, api, K)
    print(f"tune: {TUNE} into a tuning DB in {tn['sweep_wall_s']:.1f} s; launches "
          f"{json.dumps(tn['launches'])}; contraction by path "
          f"{json.dumps(tn['launches_by_path'])}; windowed by path "
          f"{json.dumps(tn['windowed_launches_by_path'])}", flush=True)
    for name, wl in tn["workloads"].items():
        print(f"  tuned {name}: " + json.dumps(wl), flush=True)
    print(f"tune: every workload replays its measured winner (decision_source 'tuned', all "
          f"units on cuda), against torch: max abs {tn['max_abs_err_vs_torch']:.3e}", flush=True)
    print("tune: calibration measured ~= a*t_mem + b*t_compute + c fitted from the card's "
          "residual rows (the log: each program's first warm call): "
          + json.dumps(tn["calibration"]), flush=True)
    for row in tn["points"]:
        print("  ranked " + json.dumps(row), flush=True)
    print("tune ranks (-1 = baseline): " + json.dumps(tn["ranks"]), flush=True)

    t0 = time.perf_counter()
    attn = check_attention_kernels(torch, timer)
    print(f"attention and recurrence kernels: {len(attn['rows'])} cases in "
          f"{time.perf_counter() - t0:.1f} s (the entry points' run {attn['wall_s']:.2f} s); "
          f"launches {json.dumps(attn['launches'])}; tolerance max|k-p| <= rtol*(1+max|p|), "
          f"float32 {RTOL}, bf16 {BF16_RTOL}", flush=True)
    for r in attn["rows"]:
        print("  unit " + json.dumps(r), flush=True)

    decode = _pick(rows, "decode/")
    ew = [r for r in new_rows if r["kernel"] == ["elementwise"]]
    conv = _pick(new_rows, f"h100/resnet50_conv2_3x3_b{RESNET_BATCH}_float32")
    # contraction: one decode layer (the 9 units at SLOTS rows, KV window
    # MAX_LEN); elementwise: every unfused elementwise unit of the corpus;
    # windowed: the float32 ResNet-50 conv, the general loop's time beside
    # it.  launches: serve + sweep (for the three compiler kernels), and
    # the ResNet path for the windowed kernel.
    contraction = _kernel_entry(
        "contraction", "src/repro_torch/csrc/contraction.cu", "src/repro/core/lower_pallas.py:979",
        serve_launches + sw["launches"]["contraction"] + md["launches"]
        + sum(w["launches"] for w in wv.values()) + tn["launches"]["contraction"], decode,
        max([r["max_abs_err"] for r in rows]
            + [r["max_abs_err"] for r in new_rows if r["kernel"] == ["contraction"]]
            + [mm_err, md["max_abs_err"]] + [w["max_abs_err"] for w in wv.values()]))
    contraction["general_ms"] = sum(r["general_ms"] for r in decode)
    contraction["launches_by_path"] = {"serve": runs["cuda"][2]["launches_by_path"],
                                       "sweep": sw["launches_by_path"],
                                       "model": md["launches_by_call"],
                                       "wave": {n: w["launches_by_call"] for n, w in wv.items()},
                                       "tune": tn["launches_by_path"]}
    windowed = _kernel_entry(
        "windowed", "src/repro_torch/csrc/windowed.cu", "src/repro/core/lower_pallas.py:812",
        sw["launches"]["windowed"] + rn["launches"] + tn["launches"]["windowed"], conv,
        max(r["max_abs_err"] for r in new_rows if r["kernel"] == ["windowed"]))
    windowed["general_ms"] = sum(r["general_ms"] for r in conv)
    windowed["launches_by_path"] = {"sweep": sw["windowed_launches_by_path"],
                                    "resnet": rn["launches_by_path"],
                                    "tune": tn["windowed_launches_by_path"]}
    # flash: llama3-8b's bf16 prefill attention at S 4096 (wgmma), the
    # CUDA-core design's time beside it; launches: phase 8's path
    flash = _kernel_entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                          "src/repro/kernels/flash_attention/kernel.py:108",
                          attn["launches"]["flash_attention"], attn["rows"][:1],
                          attn["max_abs_err"]["flash_attention"])
    flash["cuda_cores_ms"] = attn["rows"][0].get("cuda_cores_ms")
    flash["wgmma_excess"] = attn["rows"][0].get("wgmma_excess")
    flash["launches_by_path"] = attn["flash_launches_by_path"]
    # ... and the float32 calls (tf32x3), row by row
    flash_f32 = [r for r in attn["rows"] if r["kernel"] == "flash_attention"
                 and r["dtype"] == "float32"]
    flash["tf32x3"] = {key: [r.get(key) for r in flash_f32]
                       for key in ("ms", "cuda_cores_ms", "bound_ms", "f32_cuda_core_bound_ms",
                                   "plain_ms", "library_ms", "library_efficient_ms",
                                   "tf32x3_excess", "cuda_cores_max_abs_err")}
    # GLA: the bf16 mLSTM and SSD calls (wgmma), the CUDA-core design's
    # times beside them; launches: phase 8's path
    gla_rows = [r for r in attn["rows"] if r["kernel"] == "gla" and r["dtype"] == "bfloat16"]
    gla = _kernel_entry("chunked_gla", "src/repro_torch/csrc/gla.cu",
                        "src/repro/kernels/mlstm_chunk/kernel.py:115", attn["launches"]["gla"],
                        gla_rows, attn["max_abs_err"]["gla"])
    gla["cuda_cores_ms"] = sum(r["cuda_cores_ms"] for r in gla_rows)
    gla["wgmma_excess"] = max(r["wgmma_excess"] for r in gla_rows)
    gla["cuda_cores_max_abs_err"] = max((r["cuda_cores_max_abs_err"] for r in attn["rows"]
                                         if r["kernel"] == "gla" and "cuda_cores_max_abs_err" in r),
                                        default=None)
    gla["launches_by_path"] = attn["gla_launches_by_path"]
    # ... and the float32 calls (tf32x3), the same way
    f32_rows = [r for r in attn["rows"] if r["kernel"] == "gla" and r["dtype"] == "float32"]
    gla["tf32x3"] = {key: sum(r[key] for r in f32_rows)
                     for key in ("ms", "cuda_cores_ms", "bound_ms", "f32_cuda_core_bound_ms",
                                "plain_ms")}
    gla["tf32x3"]["excess"] = max(r["tf32x3_excess"] for r in f32_rows)
    # stripe_matmul rides on the contraction kernel; launches: phase 3's
    matmul_entry = _kernel_entry("stripe_matmul", "src/repro_torch/csrc/contraction.cu",
                                 "src/repro/kernels/stripe_matmul/kernel.py:23", mm_launches,
                                 [mm_row], mm_err)
    # elementwise: every unfused elementwise unit of the corpus, the general
    # loop's time beside it; launches: the sweep's, by path there and in
    # phase 4's units
    elementwise = _kernel_entry("elementwise", "src/repro_torch/csrc/elementwise.cu",
                                "src/repro/core/lower_pallas.py:1097",
                                sw["launches"]["elementwise"] + tn["launches"]["elementwise"],
                                ew,
                                max(r["max_abs_err"] for r in ew))
    elementwise["general_ms"] = sum(r["general_ms"] for r in ew)
    elementwise["general_max_abs_err"] = max(r["general_max_abs_err"] for r in ew)
    # one PyTorch call computes only some units (a bias add): by unit
    elementwise["library_ms_by_unit"] = {r["unit"]: r["library_ms"] for r in ew}
    phase4 = [p for r in new_rows if r["kernel"] == ["elementwise"] for p in r["paths"]]
    elementwise["launches_by_path"] = {
        "sweep": sw["elementwise_launches_by_path"],
        "tune": tn["elementwise_launches_by_path"],
        "phase4": {p: phase4.count(p) for p in ("vec", "general")}}
    elementwise["empty_kernel_ms"] = empty_ms
    summary = {"kernels": [
        contraction,
        elementwise,
        windowed,
        flash,
        gla,
        matmul_entry,
    ]}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
