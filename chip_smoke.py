#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one
NVIDIA card.

    python3 chip_smoke.py                # the full check, one card
    python3 chip_smoke.py --layers 2     # shorter models for a quick look

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. **build** — compile the six CUDA kernels (contraction, elementwise,
   windowed, flash_attention, gla, moe_dispatch) from the sources in this checkout, one
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
   around each call), every ``oplib`` unit on ``cuda``; every call of
   qwen3-moe, on either backend, must launch the MoE dispatch's positions
   kernel twice a layer; each projection at the prefill's and the
   decode's rows is held against its kernel's
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
   beside the card's name and power limit.  Then the same wave of
   granite-4.0-h-small at full width and two layers of each kind
   (Mamba2, attention; each followed by 72 experts top-10 and a shared
   expert), as qwen3-moe (its routes replayed; two launches of the MoE
   dispatch's kernel a layer a call, at 72 experts; one of the
   contraction kernel a projection, 24 a call; each projection shape,
   the Mamba2 ``in_proj`` 4096x16768 and ``out_proj`` 8192x4096 and the
   shared expert's 4096x1536 and 1536x4096 among them, held against its
   plain version), on the benchmark's seeded weights, and the timed
   ``cuda`` run's served logits read against the benchmark's plain
   reference (``bench/check.py``) under ``REFERENCE_LIMITS``, which the
   4-layer reading sets.
12. **families** — the hybrid, ssm and audio families through the same
   wave (``WaveEngine(model, 4, 128)``, the serve phase's 4 prompts, 16
   new tokens: one prefill of 4 x 100 rows and 15 decode steps), each
   model's seeded random bf16 weights drawn on the card after the last
   one's are freed: zamba2-2.7b at full width and depth (54 Mamba2
   layers, d 2560, 80 SSD heads of 64, state 64; its one shared
   attention + GLU block applied 9 times, each with its own KV cache) and
   xlstm-125m (12 blocks, sLSTM at 5 and 11), each with ``oplib`` on
   ``cuda`` and on ``torch``, held as in phase 11: every ``oplib`` unit
   on ``cuda``, every projection one launch of the contraction kernel
   (171 a call for zamba2, 56 for xlstm), ``tiled`` on wgmma at the
   prefill and ``skinny`` at each decode step, ``general`` 0; each
   projection at both row counts against its kernel's plain version
   (``BF16_RTOL``); the logits behind each greedy token ``cuda`` against
   ``torch`` (``LOGIT_RTOL``) up to each request's first differing token.
   For zamba2 those are held between an untimed ``cuda`` run that keeps
   every block's input and output and an untimed ``torch`` run that feeds
   each block the kept input, where each block's output is held too
   (``LOGIT_RTOL``): its 63 blocks have no residual path around a Mamba2
   layer and amplify a rounding difference about 1.5 times a block, so
   the free runs' logits part completely; they print beside the held
   ones.
   seamless-m4t-large-v2 (24 + 24 layers, d 1024, zero frames for the
   encoder) serves on ``torch`` alone: its relu2 MLP has no Tile
   intrinsic (ROADMAP C9), which the ``cuda`` backend must raise on its
   ``w_up`` on the card; its logits must be finite.  Times, peak memory
   and launches print as in phase 11.

13. **training** — after phase 12, every earlier model freed (the memory
   still allocated prints first), with ``oplib`` on ``torch``: the
   hand-written kernels have no backward (ROADMAP C11), so the phase
   must launch none of them.  (a) ``Trainer`` on llama3-8b at full width
   and ``TRAIN_LAYERS`` of its 32 layers, bf16 weights, ``TRAIN_BATCH`` x
   ``TRAIN_SEQ`` tokens a step, ``TRAIN_STEPS`` steps of AdamW (``TRAIN_OPT``),
   remat on: each step's loss, grad norm, lr and time (host clock after
   ``torch.cuda.synchronize()``), the median of steps 2 on, tokens/s, the
   model-FLOPs share (6 x the matrix parameters x tokens plus causal
   attention, over the step time, against 989 TFLOP/s bf16 dense; remat's
   recompute not counted) and ``max_memory_allocated``; every loss and
   norm finite, the last loss below the first.  (b) the same initial
   weights upcast to float32 on the same first batch: the bf16 loss
   within ``BF16_LOSS_RTOL`` and grad norm within ``BF16_GNORM_RTOL``.  (c)
   each of the 10 configs at ``scaled()`` (float32): one step on the card
   against the CPU from the same weights and batch (``STEP_LOSS_RTOL``,
   ``STEP_GRAD_RTOL``).  (d) the reference test's tiny llama3-8b, 12
   steps, a checkpoint every 4, a fault at step 6 under
   ``run_with_restarts``: steps 10-12 against the uninterrupted run (bit
   for bit, else ``RESUME_RTOL``).  (e) xlstm-125m at full size
   (``XLSTM_BATCH`` x ``XLSTM_SEQ``, ``XLSTM_STEPS`` steps): step times,
   peak memory, finite losses.  (f) ``oplib.linear`` on ``cuda``,
   ``flash_attention`` and ``chunked_gla`` on card tensors that require
   grad, and a ``Trainer`` under ``cuda``, must raise.

14. **multi-device** — ``MESH_RANKS`` ranks emulated on the one card
   (``Mesh(["cuda:0"] * 4, ("x",))``: one host thread a rank, their
   launches on the card's one stream, so the times are the emulation's,
   not an interconnect's).  (a) the programs of the mesh tests at
   published widths through ``api.jit(..., backend="cuda", mesh=...)``
   (``MESH_FFN``, ``MESH_DOWN``, ``MESH_CONV``, ``MESH_HALO``, ``MESH_MLP2``
   under ``MESH_SLOW``): each plan's collectives must be the expected ones
   with no fallback; each output is held against the single-device
   compile on the card within ``MESH_RTOL * (1 + max|single|)`` and
   printed bit-equal or not; the collective call sites of one call
   (``mesh_lower.count_collectives``) must equal the plan's
   (``expected_primitive_counts_from_record``); every unit of every
   segment must be on ``cuda`` (none sent to torch by the per-unit
   legality check) and the unit kernels' launches of each case must be
   exactly ranks x the segments' launches (``n_cuda``), never 0; each
   case is timed in turns with the single-device compile (CUDA events)
   and by the host clock.  (b) the collective library at llama3-8b's
   widths: both ring matmuls against the gather-then-multiply baseline,
   ``sp_decode_attention`` against ``full_decode_attention_ref``
   (``SP_DECODE``), ``pipeline_apply`` over 4 stages against the
   sequential loop, ``zero1_update`` on one layer's float32 parameters,
   each rank given a different share of the gradient (``zero1_shares``),
   against ``adamw.apply_updates`` on their sum, ``compressed_psum`` with error
   feedback (two rounds, each the rank-order sum of the dequantized
   shards bit for bit).  (c) ``stripe_jit(mesh=8)`` on a machine with
   fewer cards must raise.
15. **sharded step** — the LM family's train, prefill and decode steps
   with their collectives placed by hand (``parallel/sharded.py``: what
   the JAX package leaves to GSPMD), ranks emulated on the one card.
   (a) ``sharded_loss_and_grads`` on 8 ranks, ``(2, 4)`` ``('data',
   'model')``, float32 on oplib's ``torch`` backend (no kernel has a
   backward), of llama3-8b, chatglm3-6b (KV heads cut over 'model') and
   qwen3-moe-30b-a3b (experts on 'model', their D on 'data', a capacity
   that drops tokens) at full width and cut depth (``SHARD_LAYERS``),
   against the single-device ``loss_and_grads``: the loss within rtol
   ``SHARD_LOSS_RTOL``, each gradient leaf within ``SHARD_GRAD_RTOL`` x
   (1 + max); then one ``sharded_train_step`` against ``apply_updates_``
   (each parameter within ``SHARD_PARAM_RTOL`` x (1 + max)).  (b)
   ``sharded_prefill`` and ``MODEL_STEPS`` ``sharded_decode_step`` calls of
   llama3-8b at full width and depth, bf16, oplib on ``cuda``, on ``(1,
   4)``, then batch 1 on ``(2, 2)`` (the cache's sequence on 'data'), the
   contraction kernel's launches counted per rank (a unit the legality
   check sends to torch is recorded with its reason) and the logits held
   within ``LOGIT_RTOL`` of the row's largest against the single-device
   ``Model`` on the same tokens.  (c) a checkpoint saved from ``(2, 4)``
   restored onto ``(1, 4)`` bit-equal.  Times (CUDA events and host
   clock, one call each; training's second call) beside the single-device
   ones, peak memory, and rank 0's collectives by kind and bytes.
16. **sharded step of the other families** — phase 15's step for the
   hybrid, ssm and audio families (``sharded.FAMILIES``), ranks emulated
   on the one card.  (a) ``sharded_loss_and_grads`` on ``(2, 4)``,
   float32, ``torch``, ``SHARD_BATCH`` x ``SHARD_SEQ`` tokens (seamless's
   frames as many), against the single-device ``loss_and_grads`` with
   phase 15's holds: zamba2-2.7b at full width and the depth of
   ``FAMILY_SHARD_LAYERS`` (whole groups of 6), xlstm-125m at full size,
   seamless-m4t-large-v2 with its encoder and decoder cut alike; then one
   ``sharded_train_step`` of zamba2 at one group against
   ``apply_updates_``.  (b) sharded serving, bf16, ``MODEL_BATCH`` x
   ``MODEL_PROMPT`` tokens and ``MODEL_STEPS`` decode steps on ``(1, 4)``:
   zamba2-2.7b at all 54 layers and xlstm-125m whole with oplib on
   ``cuda`` (B1 counted per rank, as in phase 15), seamless-m4t-large-v2 at
   full depth on ``torch`` (ROADMAP C9); then zamba2 at
   ``FAMILY_SP_LAYERS`` at batch 1 on ``(2, 2)`` (the attention cache's
   positions on 'data', the recurrent states replicated over it).  The
   logits are held within ``LOGIT_RTOL`` of the row's largest against the
   single-device ``Model`` on the same tokens, but zamba2's: its free
   difference prints beside a replay in which every block of the sharded
   run takes the single-device run's input and its output is held
   (``hybrid_blocks``, as phase 12 does: ROADMAP C10), then the replay's
   logits.  Times, peaks and rank 0's collectives print as in phase 15.
17. **dry run** — ``launch/dryrun.py`` on the 16 x 16 production mesh of
   ``meta`` devices, rank 0 traced alone (``spmd.tracing``).  (a)
   ``run_cell`` of ``DRYRUN_CELLS``: every row ``ok`` with its FLOPs,
   argument bytes and collectives, printed.  (b) phase 15's llama3-8b
   train-step case on ``SHARD_MESH`` traced on meta devices against a
   ``sharded_train_step`` of it on as many ranks of the card: the
   predicted argument bytes must equal those of rank 0's placed shards and
   batch block on the card, and the predicted collectives (kind, count,
   bytes sent) phase 15's ``collective_census`` of the card's run under
   the HLO kinds (``psum`` and ``pmax`` all-reduce, ``psum_scatter``
   reduce-scatter, ``all_gather`` all-gather).  (c) ``roofline.analyze``
   of (a)'s rows under the H100's data-sheet figures: the table and the
   five worst rows.  (d) the four example twins (``examples/torch_*.py``)
   at their default presets on the card, each in its own process within
   ``EXAMPLE_TIMEOUT``, exit code 0; their kernels' launches (the
   contraction kernel's in quickstart, compile_op and serve, the windowed
   kernel's in compile_op's ``stripe_jit``; the trainer launches none,
   C11) counted into the summary.  (a)'s cells run in ``DRYRUN_WORKERS``
   processes at once (host work on ``meta`` devices alone).
18. **the multi-pod mesh** — the sharded step on ``('pod', 'data',
   'model')`` meshes ('pod' pure data parallelism: the batch, or a batch-1
   cache's sequence, cut over ``('pod', 'data')``, 'pod' major; every
   parameter whole over 'pod'), ranks emulated on the one card as in
   phases 15-16.  (a) ``sharded_loss_and_grads`` of llama3-8b,
   qwen3-moe-30b-a3b (capacity 1.0: tokens drop), zamba2-2.7b (one group:
   C10) and xlstm-125m (whole) at full width, float32, oplib on ``torch``,
   on ``POD_MESH`` (8 ranks) against the single-device ``loss_and_grads``
   (phase 15's holds) and against the same call on ``POD_DATA_MESH``
   ``('data', 'model')``, whose batch blocks are the same, within
   ``POD_SAME_RTOL`` x (1 + max); then one ``sharded_train_step`` of each
   against ``apply_updates_`` (phase 15's hold) and against the same step
   on the 'data' mesh of the same blocks, within ``POD_SAME_RTOL`` x (1 +
   max): on ``POD_MESH`` for zamba2 and the xLSTM, on ``(2, 1, 4)`` for
   llama3-8b and qwen3-moe, whose 8 ranks' AdamW state on ``POD_MESH``
   does not fit one card (``POD_STEP_MESH``).  (b) llama3-8b bf16 at full
   width and depth on ``POD_SERVE_MESH``: ``MODEL_BATCH`` x
   ``MODEL_PROMPT`` tokens and ``MODEL_STEPS`` decode steps, B1 on every
   rank (counted per rank as in phase 15), then batch 1 at
   ``SHARD_SP_LAYERS`` on ``POD_SP_MESH`` (the cache's sequence on
   ``('pod', 'data')``), the logits held within ``LOGIT_RTOL`` of the
   row's largest against the single-device ``Model``.  (c) phase 17 (b)
   on the multi-pod mesh: (a)'s llama3-8b step traced on ``meta`` devices
   of its mesh, and zamba2-2.7b's on ``POD_MESH``, each against the same
   step on ranks of the card: argument bytes and collectives (kind,
   count, bytes sent) equal, exactly.  (d) ``run_cell(..., multi_pod=True)``
   of ``DRYRUN_CELLS`` on the 2 x 16 x 16 mesh of 512 ``meta`` devices,
   every row ``ok``, in ``DRYRUN_WORKERS`` processes; the roofline table
   of both meshes' rows and the five worst single-pod rows.
19. **the MoE dispatch** — the positions kernel (``csrc/moe_dispatch.cu``)
   at ``MOE_DISPATCH_SHAPES`` (qwen3-moe-30b-a3b's wave prefill of 16384
   tokens and a decode call of 16, 128 experts, top-8; granite-4.0-h-
   small's extraction prefill of 4 x 2506 tokens, 72 experts, top-10;
   capacity factor 1.25): its ``pair_of_slot`` and drop count equal to its plain
   version's (the ``cumsum`` formulation, on the card) and to a stable
   sort's (``_sorted_positions``) exactly, two launches a call, and the
   experts' rows gathered from its map equal to the scatter of the
   dispatch before it bit for bit; the kernel, the plain positions, the
   sort, the gather, and the whole dispatch in turns with the one before
   it timed with CUDA events beside their bounds by bytes.

The run order is 1-6, 10, 11, 19, 12, 13, 7, 9, 8, 14, 15, 16, 17, 18:
phase 10 reuses the serve phase's weights, which are freed before phase
11.

Launch counts are read per path: every count is set to 0 just before the
serve phase (path 1), before the sweep (path 2), before phase 8's calls
of the entry points (path 3), before the ResNet layer (path 4), before
phase 9 (path 5), before phase 10's timed calls (path 6), before each
of phase 11's timed waves (path 7), before each of phase 12's (path
8), before phase 13 (path 9, which must launch none), before phase
14's mesh calls (path 10), before each of phase 15's sharded serving
runs (path 11), before each of phase 16's (path 12) and before each of
phase 18's (path 14), and read just after each; each example twin of
phase 17 (path 13) counts from 0 in its own process and prints its
counts at its end; the contraction kernel's
``launches_by_path`` (skinny, tiled, general) is read the same way for
the serve, sweep, tune, model, wave and families paths, and none of the
serve, model, wave and families paths may launch the general loop;
the windowed kernel's (igemm, general) for the sweep, ResNet and
tune paths, the elementwise kernel's (vec, general) for the sweep and
tune paths (and phase 4's units, from their rows), flash attention's and the GLA kernel's (wgmma,
tf32x3, cuda_cores) for path 3, all in
the summary, which lists the six TPU kernels' counterparts
(``stripe_matmul`` rides on the contraction kernel; its launches are
phase 3's) and the MoE dispatch's positions kernel, which replaces none:
its launches are those of phase 11's timed ``cuda`` wave of
qwen3-moe-30b-a3b (path 7; two a MoE layer a model call, on each call,
held), phase 19's beside them (the other model paths launch it too,
training included, since it reads only the experts' ids).  The
last lines are the kernel summary (JSON), the card's name and power
limit as ``nvidia-smi`` reports them, and the result line
``{"ok": true, "device": {...}}``.  TF32 is off wherever the plain
version and the yardstick run.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
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
# phase 11's granite wave: granite-4.0-h-small (the benchmark's
# configuration file) at full width, two layers of each kind, and its KV
# window; its wave read against the plain reference (bench/check.py's
# numbers, the share counting tokens over REFERENCE_OVER): at these 4
# layers the program read logit_error_q10 0.009 and error_share 0, the
# float8 control about 0.10 (the 40-layer cell's limits are 0.21 and 0.3);
# one slot of the 4 served wrong reads a share of 0.25
GRANITE, GRANITE_LAYERS = "granite-4.0-h-small", ("mamba", "attention", "mamba", "attention")
GRANITE_MAX_LEN = 128
REFERENCE_LIMITS = {"logit_error_q10": 0.03, "error_share": 0.1}
REFERENCE_OVER = 0.1
# phase 19: the MoE dispatch at qwen3-moe-30b-a3b's routing (128 experts,
# top-8, width 2048): a wave prefill of 16 x 1024 tokens and a decode
# call of 16; and at granite-4.0-h-small's (72 experts, top-10, width
# 4096): the extraction cell's widest wave prefill, 4 x 2506 tokens;
# (t, k, e, cap, d) with the capacity of factor 1.25
MOE_DISPATCH_SHAPES = ((16384, 8, 128, 1280, 2048), (16, 8, 128, 4, 2048),
                       (10024, 10, 72, 1741, 4096))
# phase 12: the hybrid, ssm and audio families, and their KV window
FAMILIES = ("zamba2-2.7b", "xlstm-125m", "seamless-m4t-large-v2")
FAMILY_MAX_LEN = 128
# the hybrid's blocks (``models/hybrid.py``): the shared block and a
# Mamba2 layer; no residual runs around a Mamba2 layer, so each block's
# output is the next one's input
HYBRID_BLOCKS = ("_shared_block", "mamba2_apply")
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
# where phases 4, 7 and 13 put their tensors (a rehearsal on the CPU sets
# "cpu": the kernels' plain versions then run, and nothing is launched)
DEVICE = "cuda"
# phase 13: llama3-8b at full width and TRAIN_LAYERS of its 32 layers (the
# 32 need ~96 GB of weights, gradients and AdamW state, more than one card
# holds), TRAIN_BATCH x TRAIN_SEQ tokens a step for TRAIN_STEPS steps;
# then xlstm-125m at full size, the reference example's --full preset
TRAIN_MODEL, TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = "llama3-8b", 8, 1024, 4, 8
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
XLSTM_TRAIN, XLSTM_SEQ, XLSTM_BATCH, XLSTM_STEPS = "xlstm-125m", 512, 8, 4
XLSTM_OPT = dict(lr=3e-4, warmup_steps=20, total_steps=XLSTM_STEPS)
# (b) the bf16 step against the same weights upcast to float32: the first
# loss and the gradient norm, relative
BF16_LOSS_RTOL, BF16_GNORM_RTOL = 1e-2, 5e-2
# (c) one float32 step on the card against the CPU: the loss, relative, and
# each gradient leaf against (1 + the leaf's largest |g|)
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-5, 1e-4
# (d) the reference test's resume tolerance where the card is not bit-exact
RESUME_RTOL = 1e-6
# phase 14: MESH_RANKS ranks emulated on the one card.  (a) the mesh tests'
# programs (tests/test_mesh_lowering.py) at published widths: ffn at
# llama3-8b's (m, d_model, d_ff); its down projection (m, d_ff, d_model) one
# row and one column short of (256, 4096), the smallest change that makes
# the plan a psum (the planner splits a divisible output dim instead);
# ResNet-50 conv2_x 3x3 (56 x 56, 64 -> 64), whose plan splits the output
# channels, and the same with 63 output channels, the smallest change that
# makes it a halo split; mlp2 at llama3-8b's FFN widths, 12 rows, under the
# reference test's slow copy of the config (links at 1e7 B/s, compute at
# 1e8 FLOP/s), where the ring wins.  Each held against the single-device
# compile on the card within MESH_RTOL * (1 + max|single|).
MESH_RANKS = 4
MESH_FFN = (256, 4096, 14336)
MESH_DOWN = (255, 14336, 4095)
MESH_CONV = (56, 56, 64, 64)
MESH_HALO = (56, 56, 64, 63)
MESH_MLP2 = (12, 4096, 14336, 4096)
MESH_SLOW = dict(ici_link_bw=1e7, peak_flops=1e8)
MESH_RTOL = 1e-5
# (b) the collective library at llama3-8b's widths: the ring matmuls'
# rows; decode attention (B, Hq, Hkv, D, cached positions); the pipeline
# (microbatches, rows a microbatch; one d_model x d_model stage a rank)
RING_ROWS = 1024
SP_DECODE = (4, 32, 8, 128, 8192)
PIPE_MICRO, PIPE_ROWS = 8, 64
# phase 15: the LM family's sharded step (parallel/sharded.py), ranks
# emulated on the one card.  (a) sharded_loss_and_grads against the
# single-device loss_and_grads, float32, oplib on torch (no kernel has a
# backward: ROADMAP C11), SHARD_BATCH x SHARD_SEQ tokens on SHARD_MESH
# ('data', 'model'): llama3-8b, chatglm3-6b (2 KV heads, cut over 'model')
# and qwen3-moe-30b-a3b (experts on 'model', their D on 'data'; capacity
# factor SHARD_MOE_CAPACITY, the mean load, so tokens drop) at full width,
# the depth cut to SHARD_LAYERS so that the meshed state and the
# single-device reference fit in 80 GB together; then one
# sharded_train_step (the default AdamWConfig) against apply_updates_ at
# SHARD_STEP_LAYERS.  (b) llama3-8b served at full width and depth, bf16,
# oplib on cuda, on SHARD_SERVE_MESH: MODEL_BATCH x MODEL_PROMPT tokens and
# MODEL_STEPS decode steps against the single-device Model; then batch 1
# on SHARD_SP_MESH (the cache's sequence on 'data') at SHARD_SP_LAYERS.
# (c) restore(shardings=) of llama3-8b at SHARD_CKPT_LAYERS layer, bf16.
SHARD_MESH = (2, 4)
SHARD_BATCH, SHARD_SEQ = 8, 128
SHARD_LAYERS = {"llama3-8b": 3, "chatglm3-6b": 4, "qwen3-moe-30b-a3b": 1}
SHARD_STEP_LAYERS = 1
SHARD_MOE_CAPACITY = 1.0
SHARD_LOSS_RTOL, SHARD_GRAD_RTOL, SHARD_PARAM_RTOL = 2e-4, 1e-4, 1e-5
SHARD_SERVE_MESH, SHARD_SP_MESH, SHARD_SP_LAYERS, SHARD_MAX_LEN = (1, 4), (2, 2), 8, 128
SHARD_CKPT_LAYERS = 1
# a rank that never reaches a collective fails the call within this time
SHARD_TIMEOUT = 120.0
# phase 16: the hybrid, ssm and audio families' sharded step.  (a) the
# depth of each (zamba2 in whole groups of 6; seamless's encoder and
# decoder alike), cut so that the meshed state and the single-device
# reference fit in 80 GB; zamba2 at one group besides: its float32
# gradients part from one device by about 1.7x a block without a residual
# path (ROADMAP C10; scripts/sharded_depth.py), so a deeper stack would
# fail the hold on rounding alone.  The AdamW step's zamba2 at one group.
# (b) zamba2's depth at batch 1 on SHARD_SP_MESH.
FAMILY_SHARD_LAYERS = {"zamba2-2.7b": 6, "xlstm-125m": 12, "seamless-m4t-large-v2": 12}
FAMILY_STEP_LAYERS = 6
FAMILY_SP_LAYERS = 12
# phase 17: the dry run (launch/dryrun.py) on the 16 x 16 production mesh
# of meta devices, rank 0 traced alone.  (a) its cells: decode_32k for all
# ten configs, prefill_32k for every config but zamba2-2.7b and
# xlstm-125m, train_4k for llama3-8b and qwen3-moe-30b-a3b, long_500k for
# the two sub-quadratic configs; the other cells take 24 s to 7 min each
# on a host (zamba2's and the sLSTM's time loops), past this phase's
# 3-minute share of the run.  (b) phase 15's llama3-8b train-step case
# (SHARD_STEP_LAYERS deep, float32, SHARD_BATCH x SHARD_SEQ, SHARD_MESH)
# traced on meta and run as a sharded_train_step on ranks of the card.  (d) the four example
# twins, each in a subprocess within EXAMPLE_TIMEOUT.
DRYRUN_CONFIGS = ("llama3-8b", "qwen3-4b", "chatglm3-6b", "nemotron-4-15b", "internvl2-26b",
                  "qwen3-moe-30b-a3b", "dbrx-132b", "zamba2-2.7b", "xlstm-125m",
                  "seamless-m4t-large-v2")
DRYRUN_CELLS = ([(a, "decode_32k") for a in DRYRUN_CONFIGS]
                + [(a, s) for a in ("llama3-8b", "qwen3-moe-30b-a3b")
                   for s in ("train_4k", "prefill_32k")]
                + [(a, "prefill_32k") for a in DRYRUN_CONFIGS
                   if a not in ("llama3-8b", "qwen3-moe-30b-a3b", "zamba2-2.7b", "xlstm-125m")]
                + [(a, "long_500k") for a in ("zamba2-2.7b", "xlstm-125m")])
# the dry run's cells (phases 17 (a) and 18 (d)) run in this many
# processes at once: host work on meta devices, each cell on one core
DRYRUN_WORKERS = 4
# phase 18: the multi-pod mesh.  (a) the 8 ranks of POD_MESH ('pod', 'data',
# 'model') and the 'data' mesh with the same batch blocks (a rank's block
# of the batch is its index over ('pod', 'data'), 'pod' major); float32 at
# full width, the depth cut until the single-device reference and the 8
# ranks' weights, gradients and their psum fit in 80 GB (POD_MESH places
# every weight 4 times: llama3-8b at 1 layer, where phase 15 runs 3);
# qwen3-moe at SHARD_MOE_CAPACITY; zamba2 at one group (C10).  The AdamW
# step's mesh and its 'data' twin: llama3-8b's and qwen3-moe's placed
# weights and AdamW state on POD_MESH come to 60.9 and 45.3 GB before the
# gradients (the dry run of the step), past one card with them, so their
# step runs on (2, 1, 4), which places each weight twice.  (b) serving on
# POD_SERVE_MESH, then batch 1 on POD_SP_MESH.
POD_MESH, POD_DATA_MESH = (2, 2, 2), (4, 2)
POD_LAYERS = {"llama3-8b": 1, "qwen3-moe-30b-a3b": 1, "zamba2-2.7b": 6, "xlstm-125m": 12}
POD_STEP_MESH = {"llama3-8b": ((2, 1, 4), (2, 4)), "qwen3-moe-30b-a3b": ((2, 1, 4), (2, 4)),
                 "zamba2-2.7b": (POD_MESH, POD_DATA_MESH), "xlstm-125m": (POD_MESH, POD_DATA_MESH)}
POD_SAME_RTOL = 1e-6
POD_SERVE_MESH, POD_SP_MESH = (2, 1, 4), (2, 2, 1)
EXAMPLES = ("torch_quickstart.py", "torch_compile_op_with_stripe.py", "torch_serve_batched.py",
            "torch_train_tiny_lm.py")
EXAMPLE_TIMEOUT = 300
# runs one example as its own __main__, then prints the kernels' launch
# counts of that process (which start at 0)
EXAMPLE_RUNNER = """
import json, runpy, sys
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
from repro_torch.kernels import contraction, elementwise, windowed
from repro_torch.kernels.flash_attention import kernel as flash
from repro_torch.kernels.mlstm_chunk import kernel as gla
print("example launches " + json.dumps({
    "contraction": contraction.launches, "elementwise": elementwise.launches,
    "windowed": windowed.launches, "flash_attention": flash.launches, "gla": gla.launches,
    "contraction_by_path": dict(contraction.launches_by_path)}))
"""


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
    """The (k, n, act) of every projection of one call of ``cfg``'s model
    that goes through ``oplib``, in order.  The lm family: q, k, v and o a
    layer, then a dense GLU MLP's 3 (7 a layer; a MoE layer's experts are
    plain ``torch.einsum``s, so 4).  The hybrid: a group's shared block
    (7), then each of its Mamba2 layers' ``in_proj`` and ``out_proj``.
    The layered family: each layer's mixer (attention's 4, or a Mamba2
    layer's 2), then its MoE's shared expert (3).
    xLSTM: an mLSTM block's 5 (``up_proj``, ``wq``, ``wk``, ``wv``,
    ``down_proj``), an sLSTM block's 3 (``w_gates``, ``w_up``,
    ``w_down``); its gates are float32 ``einsum``s outside ``oplib``."""
    from repro_torch.nn.ssm import mamba2_dims

    d, hd = cfg.d_model, cfg.hd
    block = [(d, cfg.n_heads * hd, None), (d, cfg.n_kv_heads * hd, None),
             (d, cfg.n_kv_heads * hd, None), (cfg.n_heads * hd, d, None)]

    def glu(f):
        return [(d, f, cfg.act.split("_")[0]), (d, f, None), (f, d, None)]

    if not cfg.moe:
        block += glu(cfg.d_ff)
    if cfg.family in ("hybrid", "layered"):
        inner, nh, ns = mamba2_dims(cfg)
        mamba = [(d, 2 * inner + 2 * ns + nh, None), (inner, d, None)]
    if cfg.family == "hybrid":
        per_group = cfg.hybrid.shared_attn_every
        return (block + mamba * per_group) * -(-cfg.n_layers // per_group)
    if cfg.family == "layered":
        shared = glu(cfg.moe.d_ff_shared) if cfg.moe.d_ff_shared else []
        return [op for kind in cfg.layer_types
                for op in (block if kind == "attention" else mamba) + shared]
    if cfg.family == "ssm":
        inner, dff = int(cfg.xlstm.proj_factor_mlstm * d), int(cfg.xlstm.proj_factor_slstm * d)
        mlstm = [(d, 2 * inner, None)] + [(inner, inner, None)] * 3 + [(inner, d, None)]
        slstm = [(d, 4 * d, None), (d, 2 * dff, None), (dff, d, None)]
        return [op for i in range(cfg.n_layers)
                for op in (slstm if i in cfg.xlstm.slstm_at else mlstm)]
    return block * cfg.n_layers


def projection_bound(cfg, m: int) -> dict:
    """The least time the card could take for one call's projections
    (``_model_ops``) at ``m`` rows: each weight and activation read once
    and each output written once over the memory rate, or the products'
    operations over the peak rate for ``cfg.dtype``, whichever is
    larger."""
    import torch

    size = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    ops = _model_ops(cfg)
    nbytes = size * sum(k * n + m * k + m * n for k, n, _act in ops)
    flops = 2 * m * sum(k * n for k, n, _act in ops)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_OPS[cfg.dtype] * 1e3
    return {"rows": m, "bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
        for k, n, act in dict.fromkeys(_model_ops(cfg)):
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
    per_call = len(_model_ops(cfg))
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


def oplib_backends(cfg) -> tuple:
    """The ``oplib`` backends a model serves on: ``cuda`` and ``torch``,
    or ``torch`` alone for a ``relu2`` MLP, which has no Tile intrinsic
    (ROADMAP C9: seamless-m4t-large-v2, nemotron)."""
    return ("torch",) if cfg.act == "relu2" else ("cuda", "torch")


@contextlib.contextmanager
def hybrid_blocks(kept: list, hold=None):
    """Patch the hybrid's blocks (``HYBRID_BLOCKS`` of
    ``repro_torch.models.hybrid``) while the body runs.  With no ``hold``
    each call appends its ``(input, output)`` to ``kept``; with one, each
    call takes the next kept input in place of its own and passes
    ``(output, kept output)`` to ``hold``, and every kept pair must have
    been used when the body ends.  Each rank of a sharded call (which
    holds the whole batch, replicated) replays every kept pair itself."""
    from repro_torch.models import hybrid
    from repro_torch.parallel import spmd

    real = {n: getattr(hybrid, n) for n in HYBRID_BLOCKS}
    items: dict = {}

    def wrap(fn):
        def call(p, x, *a, **kw):
            if hold is None:
                out = fn(p, x, *a, **kw)
                kept.append((x, out[0]))
            else:
                mine = items.setdefault(spmd.current_rank(), iter(kept))
                x, want = next(mine)
                out = fn(p, x, *a, **kw)
                hold(out[0], want)
            return out
        return call

    for n, fn in real.items():
        setattr(hybrid, n, wrap(fn))
    try:
        yield
        if hold is not None and (not items or any(next(it, None) is not None
                                                   for it in items.values())):
            raise AssertionError("hybrid_blocks: the replay left kept blocks unused")
    finally:
        for n, fn in real.items():
            setattr(hybrid, n, fn)


def wave(torch, api, K, cfg, max_len: int, new_tokens: int, reference=None) -> dict:
    """Phases 11 and 12 for one model: seeded random weights drawn on the
    card, a layer at a time; the serve phase's prompts through
    ``WaveEngine(model, WAVE_SLOTS, max_len)`` with ``oplib`` on each of
    its backends (``oplib_backends``), each timed run after an untimed
    one that compiles and loads what it calls.  A model served on
    ``torch`` alone (seamless-m4t-large-v2, ROADMAP C9) must first be
    refused by the ``cuda`` backend at its MLP (``_c9``), and its logits
    must be finite.  The engine gains no hook: the
    script wraps the ``Model``'s ``prefill`` / ``decode_step``, recording
    each call's launches by path, its time on the host clock (with
    ``torch.cuda.synchronize()``) and the logits behind each greedy token.
    Every projection is one launch of the contraction kernel (4 a layer a
    call for MoE, 7 for a dense MLP): ``tiled`` on wgmma at prefill,
    ``skinny`` at decode, never ``general``; each is then held against its
    kernel's plain version at the prefill's and the decode's rows.  Every
    call of a MoE model, on either backend, launches the MoE dispatch's
    positions kernel twice a layer (its count is set to 0 before each run
    and read around each call).  With ``reference`` (a plain reference
    of ``bench/reference/`` and its configuration file's dict) the
    weights are the benchmark's (``bench/weights.py``), and the timed
    ``cuda`` run's wave is read against the reference
    (``_against_reference``).

    The timed runs' logits are held (``_held_logits``), but for two kinds
    of model, whose untimed ``cuda`` run keeps what the untimed ``torch``
    run then replays; their timed runs are compared and printed, not held.
    A MoE model's ``cuda`` run keeps each layer's expert choices
    (``nn.moe.route`` patched) and the ``torch`` run takes them, and those
    two runs' logits are held: left free, the backends' rounding flips the
    router's near-ties in some tokens (the 8th and 9th experts'
    probabilities 5e-7 to 6e-4 apart), each flip moving that token by one
    expert's share (``scripts/moe_routing.py`` shows the same with two
    ``torch`` runs that differ only in the projections' rounding).  The
    hybrid's ``cuda`` run keeps each block's input and output (the shared
    block and every Mamba2 layer, ``hybrid_blocks``), and the ``torch``
    run feeds every block the kept input and holds its output against the
    kept one within ``LOGIT_RTOL`` of the largest, then the logits: left
    free, 63 blocks without a residual path amplify a rounding difference
    about 1.5 times a block, so two runs that differ only in rounding part
    completely (``scripts/hybrid_divergence.py``; the JAX package's own
    prefill parts the same way, ``tests/zamba2_reference_witness.py``)."""
    import numpy as np
    from repro_torch.core import oplib
    from repro_torch.kernels import moe_dispatch as MD
    from repro_torch.nn import moe

    cuda = DEVICE == "cuda"
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    mdl = api.build_model(cfg)
    t0 = time.perf_counter()
    if reference is None:
        params = mdl.init(gen, device=DEVICE)
    else:
        from bench import weights

        params = weights.make(mdl, SEED, DEVICE)
    _sync(torch)
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9 if cuda else None
    per_call = len(_model_ops(cfg))
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab, size=p) for p in PROMPT_LENS]
    plen = max(PROMPT_LENS) + (cfg.frontend_len if cfg.frontend == "patches" else 0)
    # what the recording run keeps, call by call, layer by layer: a MoE
    # layer's expert choices, or a hybrid block's (input, output)
    kept: list = []
    block_err = {"max": 0.0, "blocks": 0}

    @contextlib.contextmanager
    def routes(replay: bool):
        real_route, items = moe.route, iter(kept)

        def route(p, x, c):
            probs, idx = real_route(p, x, c)
            if replay:
                return probs, next(items)
            kept.append(idx)
            return probs, idx

        moe.route = route
        try:
            yield
        finally:
            moe.route = real_route
        if replay and next(items, None) is not None:
            raise AssertionError(f"wave {cfg.name}: the replay left recorded routes unused")

    def block_held(out, want):
        rel = ((out.float() - want.float()).abs().max() / want.float().abs().max()).item()
        block_err["max"] = max(block_err["max"], rel)
        block_err["blocks"] += 1
        if not rel <= LOGIT_RTOL:
            raise AssertionError(f"wave {cfg.name}: block {block_err['blocks'] - 1} of the "
                                 f"replay differs by {rel:.3e} of its largest output "
                                 f"(tolerance {LOGIT_RTOL})")

    # (run, backend, new tokens, what is patched in while it runs); a
    # replaying run replays what the recording run kept; an untimed run
    # with nothing to keep only compiles and loads, so 2 tokens do
    keep = replay_with = None
    if cfg.moe:
        keep, replay_with = lambda: routes(False), lambda: routes(True)
    elif cfg.family == "hybrid":
        keep, replay_with = lambda: hybrid_blocks(kept), lambda: hybrid_blocks(kept, block_held)
    backends = oplib_backends(cfg)
    if keep:
        plan = (("cuda_kept", "cuda", new_tokens, keep),
                ("cuda", "cuda", new_tokens, contextlib.nullcontext),
                ("torch_replay", "torch", new_tokens, replay_with),
                ("torch", "torch", new_tokens, contextlib.nullcontext))
    else:
        plan = tuple(run for b in backends
                     for run in ((f"{b}_warm", b, 2, contextlib.nullcontext),
                                 (b, b, new_tokens, contextlib.nullcontext)))
    c9 = None if "cuda" in backends else _c9(torch, cfg, params, WAVE_SLOTS * plen)
    runs = {}
    old = oplib.get_backend()
    try:
        for run, backend, n_new, patch in plan:
            oplib.set_backend(backend)
            rec = {"ms": [], "by_call": [], "dispatch_by_call": [], "rows": []}

            def recorded(fn, rec=rec):
                def call(*a):
                    before = dict(K.launches_by_path)
                    dispatch_before = MD.launches
                    _sync(torch)
                    t0 = time.perf_counter()
                    logits, cache = fn(*a)
                    _sync(torch)
                    rec["ms"].append((time.perf_counter() - t0) * 1e3)
                    rec["by_call"].append({p: K.launches_by_path[p] - before[p] for p in before})
                    rec["dispatch_by_call"].append(MD.launches - dispatch_before)
                    rec["rows"].append(logits[:, -1, : cfg.vocab].float().cpu())
                    return logits, cache
                return call

            model = dataclasses.replace(mdl, prefill=recorded(mdl.prefill),
                                        decode_step=recorded(mdl.decode_step))
            engine = api.WaveEngine(model, WAVE_SLOTS, max_len, device=DEVICE)
            for uid, prompt in enumerate(prompts):
                engine.submit(api.Request(uid=uid, prompt=prompt,
                                          sampling=api.SamplingParams(max_new_tokens=n_new)))
            _zero_counts(K, MD)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with patch():
                done = engine.run(params)
                _sync(torch)
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
                "dispatch_by_call": rec["dispatch_by_call"], "dispatch_launches": MD.launches,
                "prefill_ms": rec["ms"][0], "decode_step_ms": rec["ms"][1:],
                "decode_step_ms_median": statistics.median(rec["ms"][1:]),
                "wall_s": wall, "tok_per_s": n_tok / wall,
                "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() / 1e9
                                            if cuda else None),
                "compile_log": engine.compile_log()}
    finally:
        oplib.set_backend(old)
    del kept
    # the MoE dispatch's positions kernel: two launches a MoE layer a call,
    # whatever the backend (it reads only the experts' ids)
    dispatch = 2 * cfg.n_layers if cfg.moe and cuda else 0
    for run, r in runs.items():
        calls = len(r["by_call"])
        if r["dispatch_by_call"] != [dispatch] * calls or r["dispatch_launches"] != dispatch * calls:
            raise AssertionError(f"wave {cfg.name} {run}: the MoE dispatch kernel launched "
                                 f"{r['dispatch_by_call']} by call, {r['dispatch_launches']} in "
                                 f"all; want {dispatch} a call")
        if r["backend"] == "torch":
            if r["launches"]:
                raise AssertionError(f"wave {cfg.name} {run}: the torch backend launched the kernel")
            continue
        want = [{"skinny": 0, "tiled": per_call, "general": 0}] + \
            [{"skinny": per_call, "tiled": 0, "general": 0}] * (calls - 1)
        if r["by_call"] != want or r["launches"] != per_call * calls:
            raise AssertionError(f"wave {cfg.name} {run}: launches by call {r['by_call']}, "
                                 f"want {want}")
    checked = (_against_reference(torch, params, prompts, runs["cuda"], reference)
               if reference else None)
    del params
    if cuda:
        torch.cuda.empty_cache()
    out = {"model": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "slots": WAVE_SLOTS, "max_len": max_len, "prefill_rows": WAVE_SLOTS * plen,
           "new_tokens": new_tokens, "init_s": init_s, "weights_gb": weights_gb,
           "backends": list(backends),
           **{f"{b}_{k}": runs[b][k] for b in backends
              for k in ("prefill_ms", "decode_step_ms_median", "decode_step_ms", "wall_s",
                        "tok_per_s", "max_memory_allocated_gb", "compile_log")}}
    if c9 is not None:
        rows = torch.stack([row for run in runs.values() for row in run["rows"]])
        if not bool(torch.isfinite(rows).all()):
            raise AssertionError(f"wave {cfg.name}: logits not finite")
        return dict(out, c9=c9, launches=0, logits_finite=True)
    units, op_err = hold_projections(
        torch, K, cfg, ((WAVE_SLOTS * plen, "tiled"), (WAVE_SLOTS, "skinny")), f"wave {cfg.name}")

    def held(a, b, hold):
        return _held_logits(runs[a]["tokens"], runs[b]["tokens"],
                            lambda u, j: runs[a]["rows"][j][u], lambda u, j: runs[b]["rows"][j][u],
                            f"wave {cfg.name} {a} against {b}", hold)

    replayed = "torch_replay" in runs
    free = held("cuda", "torch", not replayed)
    same = held("cuda_kept", "torch_replay", True) if replayed else free
    return dict(out, units=units, ops_max_abs_err=op_err, max_abs_err=max(op_err.values()),
                max_logit_rel_err=same["max_logit_rel_err"],
                first_divergence=same["first_divergence"],
                **({"free_max_logit_rel_err": free["max_logit_rel_err"],
                    "free_first_divergence": free["first_divergence"]} if replayed else {}),
                **({"replay_blocks_held": block_err["blocks"],
                    "replay_block_max_rel_err": block_err["max"]}
                   if block_err["blocks"] else {}),
                projection_bound={"prefill": projection_bound(cfg, WAVE_SLOTS * plen),
                                  "decode": projection_bound(cfg, WAVE_SLOTS)},
                launches=runs["cuda"]["launches"], launches_per_call=per_call,
                launches_by_call={"prefill": runs["cuda"]["by_call"][0],
                                  "decode": runs["cuda"]["by_call"][1]},
                dispatch_launches=runs["cuda"]["dispatch_launches"],
                dispatch_launches_per_call=dispatch,
                **({"reference_check": checked, "reference_limits": REFERENCE_LIMITS}
                   if checked else {}))


def _against_reference(torch, params, prompts, run, reference) -> dict:
    """A wave run's served logits read against the plain reference, as
    the benchmark's wave driver hands a wave to its check
    (``bench/check.py``): every row left-padded with token 0 to the
    longest prompt, then the tokens each decode call was fed (every
    request is served all its tokens, so those are its served tokens but
    the last); the prefill's tokens one group of the MoE's capacity, each
    decode call's another.  Each number is held under
    ``REFERENCE_LIMITS``."""
    import numpy as np
    from bench import check
    from bench.served import Job

    ref, arch = reference
    width, n = max(len(p) for p in prompts), len(run["tokens"][0])
    toks = np.zeros((len(prompts), width + n - 1), np.int64)
    for uid, prompt in enumerate(prompts):
        toks[uid, width - len(prompt):width] = prompt
        toks[uid, width:] = run["tokens"][uid][:-1]
    served = [(uid, j) for uid in range(len(prompts)) for j in range(n)]
    at = np.asarray([(uid, width - 1 + j) for uid, j in served], np.int64)
    job = Job(tokens=toks, at=at,
              served=np.asarray([run["tokens"][uid][j] for uid, j in served], np.int64),
              groups=[(0, width)] + [(width + j, width + j + 1) for j in range(n - 1)],
              logits=torch.stack([run["rows"][j][uid] for uid, j in served]),
              stage=np.minimum(at[:, 1] - (width - 1), 2))
    reading = check.read(ref, params, arch, [job], DEVICE, over=REFERENCE_OVER)
    for name, limit in REFERENCE_LIMITS.items():
        if not reading[name] <= limit:
            raise AssertionError(f"wave {arch['name']}: {name} {reading[name]:.5f} against the "
                                 f"plain reference, over {limit}")
    return {k: reading[k] for k in (*REFERENCE_LIMITS, "tokens_checked")}


def _c9(torch, cfg, params, rows: int) -> str:
    """ROADMAP C9 on the card: the ``cuda`` backend refuses the
    encoder-decoder's MLP (``act`` relu2 has no Tile intrinsic) with the
    reference's ``ValueError``; returns its message."""
    from repro_torch.core import oplib
    from repro_torch.nn.core import linear

    w_up = params["decoder"]["mlp"]["w_up"][0]
    x = torch.zeros((rows, cfg.d_model), dtype=w_up.dtype, device=w_up.device)
    old = oplib.get_backend()
    oplib.set_backend("cuda")
    try:
        linear(x, w_up, act=cfg.act)
    except ValueError as e:
        if "unknown intrinsic 'relu2'" not in str(e):
            raise
        return str(e)
    finally:
        oplib.set_backend(old)
    raise AssertionError(f"{cfg.name}: the cuda backend ran the {cfg.act} MLP (ROADMAP C9)")


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


# ------------------------------------------------------------- training
def step_grads(api, cfg, params, batch) -> tuple:
    """One train step without the update (the ``Trainer``'s
    ``loss_and_grads``, remat on): the loss and the gradients in the
    trees' leaf order."""
    from repro_torch.train.loop import loss_and_grads

    loss, grads = loss_and_grads(api.build_model(cfg), params, batch)
    return float(loss), grads


def card_against_cpu(torch, api, name: str) -> dict:
    """Phase 13 (c) for one config at ``scaled()`` (float32): one train
    step on the card and on the CPU from the same weights and batch; the
    loss within STEP_LOSS_RTOL, each gradient leaf within STEP_GRAD_RTOL x
    (1 + its largest |g|)."""
    from repro_torch import tree as T

    cfg = api.configs.get(name).scaled()
    cpu = api.build_model(cfg).init(torch.Generator().manual_seed(SEED), device="cpu")
    pairs, _ = T.flatten_with_path(cpu)
    card = T.tree_map(lambda t: t.to(DEVICE), cpu)
    got = {dev: step_grads(api, cfg, params,
                           api.make_batch(cfg, "train", 2, 32, seed=1, device=dev))
           for dev, params in (("cpu", cpu), (DEVICE, card))}
    loss_err = abs(got[DEVICE][0] - got["cpu"][0]) / abs(got["cpu"][0])
    worst, where = 0.0, ""
    for (path, _), a, b in zip(pairs, got[DEVICE][1], got["cpu"][1]):
        err = float((a.cpu() - b).abs().max()) / (1.0 + float(b.abs().max()))
        if err >= worst:
            worst, where = err, T.key_path(path)
    if not (loss_err <= STEP_LOSS_RTOL and worst <= STEP_GRAD_RTOL):
        raise AssertionError(f"train step {name}: card against CPU, loss {loss_err:.3e} "
                             f"(<= {STEP_LOSS_RTOL}), gradient {worst:.3e} at {where} "
                             f"(<= {STEP_GRAD_RTOL})")
    return {"config": name, "loss": got[DEVICE][0],
            "loss_rel_err": loss_err, "grad_err": worst, "worst_leaf": where,
            "leaves": len(pairs)}


def _tiny_llama(api):
    """The reference test's tiny llama3-8b (tests/test_train_fault.py)."""
    return api.configs.get("llama3-8b").scaled(n_layers=2, d_model=32, n_heads=2,
                                               n_kv_heads=2, d_ff=64, vocab=64,
                                               head_dim=16, vocab_pad_multiple=16)


def fault_resume(torch, api, workdir: Path, device: str = DEVICE) -> dict:
    """Phase 13 (d): 12 steps of the tiny llama3-8b, a checkpoint every 4,
    uninterrupted and again with a fault at step 6 under
    ``run_with_restarts``; steps 10-12 of the resumed run against the
    uninterrupted one, bit for bit where the card gives it, else within
    RESUME_RTOL."""
    from repro_torch.train.loop import FaultInjector, run_with_restarts

    cfg = _tiny_llama(api)

    def make(d):
        return lambda: api.Trainer(
            api.build_model(cfg), api.adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                        total_steps=12),
            api.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4),
            api.TrainConfig(steps=12, ckpt_dir=str(workdir / d), ckpt_every=4, log_every=1),
            gen=torch.Generator(device=device).manual_seed(0), device=device)

    ref = run_with_restarts(make("a"))
    out = run_with_restarts(make("b"), fault=FaultInjector(fail_at_step=6))
    if out["restarts"] != 1 or ref["restarts"] != 0:
        raise AssertionError(f"fault resume: restarts {out['restarts']}, {ref['restarts']}")
    want = {h["step"]: h["loss"] for h in ref["history"]}
    got = {h["step"]: h["loss"] for h in out["history"]}
    rows = [(s, got[s], want[s]) for s in (10, 11, 12)]
    bit_equal = all(a == b for _, a, b in rows)
    worst = max(abs(a - b) / abs(b) for _, a, b in rows)
    if worst > RESUME_RTOL:
        raise AssertionError(f"fault resume: steps 10-12 {rows} differ by {worst:.3e} "
                             f"(> {RESUME_RTOL})")
    return {"resumed_losses": [a for _, a, _ in rows], "uninterrupted": [b for _, _, b in rows],
            "bit_equal": bit_equal, "max_rel_err": worst, "restarts": out["restarts"]}


def c11_refusals(torch, api, device: str = DEVICE) -> list:
    """Phase 13 (f): ``oplib.linear`` on the ``cuda`` backend,
    ``flash_attention`` and ``chunked_gla`` on tensors that require grad,
    and a ``Trainer`` under the ``cuda`` backend, each must raise
    ``KernelAutogradError`` (ROADMAP C11) before any launch."""
    from repro_torch.core import oplib
    from repro_torch.kernels._build import KernelAutogradError
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.mlstm_chunk.kernel import chunked_gla

    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape, grad=False):
        t = torch.randn(shape, generator=gen, device=device)
        return t.requires_grad_(True) if grad else t

    q, k, v = randn(1, 2, 64, 64, grad=True), randn(1, 2, 64, 64), randn(1, 2, 64, 64)
    cfg = _tiny_llama(api)
    calls = {
        "oplib.linear": lambda: oplib.linear(randn(8, 64), randn(64, 32, grad=True)),
        "flash_attention": lambda: flash_attention(q, k, v),
        "chunked_gla": lambda: chunked_gla(q, k, v, -randn(1, 2, 64).abs(),
                                           randn(1, 2, 64).abs(), chunk=64),
        "Trainer": lambda: api.Trainer(api.build_model(cfg), api.adamw.AdamWConfig(),
                                       api.DataConfig(vocab=cfg.vocab, seq_len=8,
                                                      global_batch=2),
                                       api.TrainConfig(steps=1), device=device),
    }
    raised = []
    old = oplib.get_backend()
    oplib.set_backend("cuda")
    try:
        for name, call in calls.items():
            try:
                call()
            except KernelAutogradError as e:
                if "C11" not in str(e):
                    raise
                raised.append(name)
            else:
                raise AssertionError(f"C11: {name} did not raise under autograd")
    finally:
        oplib.set_backend(old)
    return raised


def _matmul_params(params) -> int:
    """The parameters that enter a matrix product: the stacked block
    matrices (three axes) and the unembedding."""
    n = sum(t.numel() for t in params["blocks"].values() for t in
            (t.values() if isinstance(t, dict) else [t]) if t.dim() == 3)
    return n + params["unembed" if "unembed" in params else "embed"].numel()


def _model_flops(cfg, params, batch: int, seq: int) -> float:
    """6 x matrix parameters x tokens, plus causal attention's
    ``QK^T`` and ``PV`` (forward and backward: 6 B Hq S^2 hd a layer);
    remat's recompute is not counted."""
    attn = 6 * batch * cfg.n_heads * seq * seq * cfg.hd * cfg.n_layers
    return 6.0 * _matmul_params(params) * batch * seq + attn


def train(torch, api, card: str, layers: int | None) -> dict:
    """Phase 13: training on the card (see the module docstring)."""
    from repro_torch import tree as T
    from repro_torch.data.pipeline import TokenStream

    out = {"memory_at_start_gb": torch.cuda.memory_allocated() / 1e9}
    print(f"train: {out['memory_at_start_gb']:.3f} GB allocated on the card at the "
          f"start of phase 13; card {card}", flush=True)
    torch.cuda.reset_peak_memory_stats()

    # (a) llama3-8b at full width
    full = api.configs.get(TRAIN_MODEL)
    cfg = dataclasses.replace(full, n_layers=min(TRAIN_LAYERS, layers or TRAIN_LAYERS))
    data = api.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    t0 = time.perf_counter()
    trainer = api.Trainer(api.build_model(cfg), api.adamw.AdamWConfig(**TRAIN_OPT), data,
                          api.TrainConfig(steps=TRAIN_STEPS, log_every=1),
                          gen=torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in T.leaves(trainer.params))
    flops = _model_flops(cfg, trainer.params, TRAIN_BATCH, TRAIN_SEQ)
    print(f"train: {cfg.name} {cfg.n_layers} of {full.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype} weights, {n_params / 1e9:.3f} B parameters "
          f"({_matmul_params(trainer.params) / 1e9:.3f} B in matrix products), init "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated; {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step; card {card}", flush=True)
    try:
        hist = trainer.run()["history"]
    finally:
        trainer.pipeline.close()
    for h in hist:
        print(f"train: {cfg.name} step {h['step']} loss {h['loss']:.6f} grad_norm "
              f"{h['grad_norm']:.6f} lr {h['lr']:.6e} {h['dt'] * 1e3:.3f} ms (host clock "
              f"after torch.cuda.synchronize()); card {card}", flush=True)
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train: non-finite loss or grad norm: {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: step {len(losses)}'s loss {losses[-1]} is not below "
                             f"step 1's {losses[0]}")
    med = statistics.median(h["dt"] for h in hist[1:])
    a = {"config": cfg.name, "layers": cfg.n_layers, "tokens_per_step": TRAIN_BATCH * TRAIN_SEQ,
         "losses": losses, "grad_norms": norms, "lrs": [h["lr"] for h in hist],
         "step_ms": [h["dt"] * 1e3 for h in hist], "step_ms_median_2_on": med * 1e3,
         "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med, "model_tflop_per_step": flops / 1e12,
         "model_flops_share": flops / med / PEAK_OPS["bfloat16"],
         "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["llama"] = a
    print(f"train: {cfg.name} step median (steps 2-{TRAIN_STEPS}) {a['step_ms_median_2_on']:.3f}"
          f" ms, {a['tokens_per_s']:.1f} tokens/s, {a['model_tflop_per_step']:.2f} model TFLOP "
          f"a step, model-FLOPs share {a['model_flops_share']:.4f} of {PEAK_OPS['bfloat16'] / 1e12:.0f}"
          f" TFLOP/s bf16 dense, peak {a['max_memory_allocated_gb']:.2f} GB "
          f"(max_memory_allocated); card {card}", flush=True)
    del trainer
    torch.cuda.empty_cache()

    # (b) the first bf16 step against the same weights in float32
    params = api.build_model(cfg).init(torch.Generator(device=DEVICE).manual_seed(SEED),
                                       device=DEVICE)
    params = T.tree_map(lambda t: t.float(), params)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in TokenStream(data).batch_at(0).items()}
    loss32, grads32 = step_grads(api, dataclasses.replace(cfg, dtype="float32"), params,
                                 batch)
    gnorm32 = float(api.adamw.global_norm(grads32))
    del params, grads32, batch
    torch.cuda.empty_cache()
    b = {"loss_bf16": losses[0], "loss_f32": loss32, "grad_norm_bf16": norms[0],
         "grad_norm_f32": gnorm32, "loss_gap": abs(losses[0] - loss32) / abs(loss32),
         "grad_norm_gap": abs(norms[0] - gnorm32) / gnorm32}
    out["bf16_vs_f32"] = b
    print(f"train: bf16 step 1 against float32 on the same weights and batch: loss "
          f"{b['loss_bf16']:.6f} / {b['loss_f32']:.6f} (gap {b['loss_gap']:.3e}, hold "
          f"{BF16_LOSS_RTOL}), grad norm {b['grad_norm_bf16']:.6f} / {b['grad_norm_f32']:.6f} "
          f"(gap {b['grad_norm_gap']:.3e}, hold {BF16_GNORM_RTOL}); card {card}", flush=True)
    if not (b["loss_gap"] <= BF16_LOSS_RTOL and b["grad_norm_gap"] <= BF16_GNORM_RTOL):
        raise AssertionError(f"train: the bf16 step parts from float32: {b}")

    # (c) one float32 step of every config, card against CPU
    out["card_vs_cpu"] = rows = [card_against_cpu(torch, api, n) for n in api.configs.names()]
    for r in rows:
        print("  train step " + json.dumps(r), flush=True)
    print(f"train: {len(rows)} configs at scaled(), float32, one step on the card against the "
          f"CPU: loss within {STEP_LOSS_RTOL} relative (worst "
          f"{max(r['loss_rel_err'] for r in rows):.3e}), each gradient leaf within "
          f"{STEP_GRAD_RTOL} x (1 + max|g|) (worst {max(r['grad_err'] for r in rows):.3e})",
          flush=True)

    # (d) fault recovery
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        out["fault_resume"] = fr = fault_resume(torch, api, Path(d), DEVICE)
    print("train: fault at step 6 of 12, a checkpoint every 4, run_with_restarts: "
          + json.dumps(fr), flush=True)

    # (e) xlstm-125m at full size
    xcfg = api.configs.get(XLSTM_TRAIN)
    xcfg = dataclasses.replace(xcfg, n_layers=layers or xcfg.n_layers)
    torch.cuda.reset_peak_memory_stats()
    xtr = api.Trainer(api.build_model(xcfg), api.adamw.AdamWConfig(**XLSTM_OPT),
                      api.DataConfig(vocab=xcfg.vocab, seq_len=XLSTM_SEQ,
                                     global_batch=XLSTM_BATCH),
                      api.TrainConfig(steps=XLSTM_STEPS, log_every=1),
                      gen=torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    try:
        xh = xtr.run()["history"]
    finally:
        xtr.pipeline.close()
    del xtr
    x = {"config": xcfg.name, "layers": xcfg.n_layers, "losses": [h["loss"] for h in xh],
         "grad_norms": [h["grad_norm"] for h in xh], "step_ms": [h["dt"] * 1e3 for h in xh],
         "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    if not all(math.isfinite(v) for v in x["losses"] + x["grad_norms"]):
        raise AssertionError(f"train: {xcfg.name} non-finite: {x}")
    out["xlstm"] = x
    print(f"train: {xcfg.name} {xcfg.n_layers} layers (sLSTM at {list(xcfg.xlstm.slstm_at)}), "
          f"{XLSTM_BATCH} x {XLSTM_SEQ} tokens a step: " + json.dumps(x) + f"; card {card}",
          flush=True)

    # (f) C11 on the card
    out["c11_raised"] = c11_refusals(torch, api, DEVICE)
    print(f"train: C11 on the card, raised KernelAutogradError: {out['c11_raised']}", flush=True)
    return out


# ------------------------------------------------------------ multi-device
def _mesh_programs(api):
    """Phase 14 (a)'s programs, built by the port's frontend: name ->
    (program, config)."""
    T = api.TileProgram
    h100 = api.get_config("h100")

    def ffn(m, k, n):
        tp = T("ffn")
        tp.input("X", (m, k), "float32"); tp.input("W", (k, n), "float32")
        tp.input("B", (n,), "float32"); tp.output("O", (m, n), "float32")
        tp.temp("T", (m, n), "float32"); tp.temp("U", (m, n), "float32")
        tp.op("T[i, j] += X[i, c] * W[c, j]", name="mm")
        tp.op("U[i, j] = T[i, j] + B[j]", name="bias")
        tp.op("O[i, j] = gelu(U[i, j])", name="act")
        return tp.build()

    def matmul(m, k, n):
        tp = T("down")
        tp.input("X", (m, k), "float32"); tp.input("W", (k, n), "float32")
        tp.output("O", (m, n), "float32")
        tp.op("O[i, j] += X[i, c] * W[c, j]", name="mm")
        return tp.build()

    def conv(x, y, c, k):
        tp = T("conv")
        tp.input("I", (x, y, c), "float32"); tp.input("F", (3, 3, c, k), "float32")
        tp.output("O", (x, y, k), "float32")
        tp.op("O[x, y, k] += I[x + i - 1, y + j - 1, c] * F[i, j, c, k]", name="conv")
        return tp.build()

    def mlp2(m, c, h, f):
        tp = T("mlp2")
        tp.input("X", (m, c), "float32"); tp.input("W1", (c, h), "float32")
        tp.input("W2", (h, f), "float32"); tp.output("O", (m, f), "float32")
        tp.temp("H", (m, h), "float32")
        tp.op("H[i, h] += X[i, c] * W1[c, h]", name="mm1")
        tp.op("O[i, f] += H[i, h] * W2[h, f]", name="mm2")
        return tp.build()

    return {"ffn": (ffn(*MESH_FFN), h100),
            "down_psum": (matmul(*MESH_DOWN), h100),
            "conv2_x": (conv(*MESH_CONV), h100),
            "conv2_x_halo": (conv(*MESH_HALO), h100),
            "mlp2_ring": (mlp2(*MESH_MLP2), dataclasses.replace(h100, **MESH_SLOW))}


# what each case's plan must do: its collectives, in the plan's order
MESH_PLANS = {"ffn": ["all_gather"], "down_psum": ["psum"], "conv2_x": ["all_gather"],
              "conv2_x_halo": ["halo", "all_gather"], "mlp2_ring": ["ring_matmul"]}


def _rank_device() -> str:
    return "cuda:0" if DEVICE == "cuda" else DEVICE


def _counts(mods) -> dict:
    return {k: (m.launches, dict(m.launches_by_path)) for k, m in mods.items()}


def _counts_since(before: dict, mods) -> dict:
    out = {}
    for k, m in mods.items():
        n0, p0 = before[k]
        out[k] = {"launches": m.launches - n0,
                  "by_path": {p: v - p0.get(p, 0) for p, v in m.launches_by_path.items()}}
    return out


def _host_ms(torch, fn, reps: int) -> float:
    """Median host-clock time of ``fn`` ending in a synchronize."""
    fn()
    _sync(torch)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(torch)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def mesh_cases(torch, api, timer, reps: int) -> dict:
    """Phase 14 (a): the mesh tests' programs through ``api.jit(...,
    backend="cuda", mesh=Mesh(["cuda:0"] * MESH_RANKS))``, the unit
    kernels' counts set to 0 just before the five calls (path 10) and read
    just after.  ``DEVICE = "cpu"`` rehearses it on CPU ranks."""
    from repro_torch.core import cache as stripe_cache
    from repro_torch.core import mesh_lower
    from repro_torch.parallel.spmd import Mesh

    mods = {k: _kernel_modules()[k] for k in UNIT_KERNELS}
    mesh = Mesh([_rank_device()] * MESH_RANKS, ("x",))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    cases = {}
    for name, (prog, hw) in _mesh_programs(api).items():
        cache = stripe_cache.CompilationCache(use_disk=False)
        t0 = time.perf_counter()
        meshed = api.jit(prog, hw, "cuda", cache=cache, use_disk=False, mesh=mesh)
        compile_s = time.perf_counter() - t0
        single = api.jit(prog, hw, "cuda", cache=cache, use_disk=False)
        info = meshed.record.mesh
        if "fallback" in info:
            raise AssertionError(f"phase 14 {name}: the mesh compile fell back: {info}")
        ops = [c["collective"] for c in info["collectives"]]
        if ops != MESH_PLANS[name]:
            raise AssertionError(f"phase 14 {name}: plan collectives {ops}, expected "
                                 f"{MESH_PLANS[name]}")
        env = {k: torch.randn(prog.buffers[k].shape, generator=gen, device=DEVICE)
               for k in prog.inputs}
        cases[name] = dict(prog=prog, meshed=meshed, single=single, env=env,
                           row={"case": name, "shape": {k: list(prog.buffers[k].shape)
                                                        for k in (*prog.inputs, *prog.outputs)},
                                "config": hw.name + (" (slow copy)" if name == "mlp2_ring" else ""),
                                "splits": info["splits"], "collectives": ops,
                                "collective_bytes": info["collective_bytes"],
                                "overlapped": info["overlapped"],
                                "segments": [{"name": s["name"], "backend": s["backend"],
                                              "n_kernels": s["n_kernels"]}
                                             for s in info["segments"]],
                                "block_backends": meshed.record.block_backends,
                                "compile_s": compile_s})
    # the main path: every count to 0, one call of each case, counts read
    _zero_counts(*mods.values())
    outs = {}
    for name, c in cases.items():
        before = _counts(mods)
        outs[name] = c["meshed"](c["env"])
        _sync(torch)
        c["row"]["launches"] = _counts_since(before, mods)
    total = {k: {"launches": m.launches, "by_path": dict(m.launches_by_path)}
             for k, m in mods.items()}
    for name, c in cases.items():
        row, meshed = c["row"], c["meshed"]
        # a unit the per-unit legality check sent to torch launches nothing;
        # a segment all of whose units went there has backend "torch"
        # every unit of every segment runs on a kernel: a unit the per-unit
        # legality check sent to torch fails the phase
        segs = meshed.record.mesh["segments"]
        torch_units = {u: meshed.record.block_fallbacks.get(u, "")
                       for u, b in meshed.record.block_backends.items() if b != "cuda"}
        if torch_units or any(s["backend"] != "cuda" for s in segs):
            raise AssertionError(f"phase 14 {name}: units off the kernels: {torch_units}, "
                                 f"segments {[(s['name'], s['backend']) for s in segs]}")
        per_rank = sum(s["n_cuda"] for s in segs)
        launched = sum(v["launches"] for v in row["launches"].values())
        row["launches_expected"] = MESH_RANKS * per_rank
        if DEVICE != "cuda":
            pass  # a rehearsal on CPU ranks runs the plain versions: nothing launches
        elif per_rank == 0 or launched != MESH_RANKS * per_rank:
            raise AssertionError(f"phase 14 {name}: {launched} launches, expected "
                                 f"{MESH_RANKS} ranks x {per_rank} a rank")
        want = c["single"](c["env"])["O"]
        got = outs[name]["O"]
        row["max_abs_err"] = _close(torch, got, want, f"phase 14 {name} mesh against single",
                                    MESH_RTOL)
        row["bit_equal"] = bool(torch.equal(got, want))
        counted = mesh_lower.count_collectives(meshed, c["env"])
        expected = mesh_lower.expected_primitive_counts_from_record(meshed.record.mesh)
        if counted != expected:
            raise AssertionError(f"phase 14 {name}: collective sites {dict(counted)}, "
                                 f"the plan's {expected}")
        row["collective_sites"] = dict(counted)
        row["collective_trips"] = counted.trips
        row["ms"], row["single_ms"] = timer.turns(lambda: meshed(c["env"]),
                                                  lambda: c["single"](c["env"]))
        row["host_ms"] = _host_ms(torch, lambda: meshed(c["env"]), reps)
        row["single_host_ms"] = _host_ms(torch, lambda: c["single"](c["env"]), reps)
    if DEVICE == "cuda" and min(total[k]["launches"] for k in ("contraction", "windowed")) \
            < MESH_RANKS:
        raise AssertionError(f"phase 14: the contraction and windowed kernels must run on "
                             f"every rank: {total}")
    return {"rows": [c["row"] for c in cases.values()], "launches": total}


def zero1_shares(torch, gen, shape, n: int):
    """``n`` different gradient shares of ``shape`` stacked on a leading
    axis, and their sum: random multiples of 2**-22 below 2**-10, the
    last share the gradient less the others, so the sum in any order is
    exact and a reduce-scatter that does not sum the ranks' shares
    misses the gradient AdamW takes."""
    dev = gen.device
    g = torch.randint(-2 ** 12, 2 ** 12, shape, generator=gen, device=dev)
    parts = [torch.randint(-2 ** 12, 2 ** 12, shape, generator=gen, device=dev)
             for _ in range(n - 1)]
    parts.append(g - sum(parts))
    unit = 2.0 ** -22
    return torch.stack(parts).to(torch.float32) * unit, g.to(torch.float32) * unit


def collective_library(torch, api, timer) -> dict:
    """Phase 14 (b): the collective algorithms at llama3-8b's widths on
    ``MESH_RANKS`` ranks of the one card, each against its single-device
    reference."""
    from functools import partial

    from repro_torch.optim import compress, zero1
    from repro_torch.parallel import collective_matmul as cm
    from repro_torch.parallel import pipeline, sp_attention, spmd
    from repro_torch.parallel.spmd import Mesh, P

    cfg = api.configs.get("llama3-8b")
    d, ff = cfg.d_model, cfg.d_ff
    n = MESH_RANKS
    mesh = Mesh([_rank_device()] * n, ("x",))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * scale

    out = {}
    # both ring matmuls against the unoverlapped gather-then-multiply
    row_specs = (P("x", None), P(None, "x"))
    x, w = randn(RING_ROWS, d), randn(d, ff, scale=d ** -0.5)
    ag = spmd.shard_map(partial(cm.ring_allgather_matmul, axis="x"), mesh, row_specs,
                        P(None, "x"))
    base = spmd.shard_map(partial(cm.allgather_matmul_baseline, axis="x"), mesh, row_specs,
                          P(None, "x"))
    err = _close(torch, ag(x, w), base(x, w), "ring_allgather_matmul against the baseline")
    ms, base_ms = timer.turns(lambda: ag(x, w), lambda: base(x, w))
    out["ring_allgather_matmul"] = {"x": [RING_ROWS, d], "w": [d, ff], "max_abs_err": err,
                                    "ms": ms, "baseline_ms": base_ms}
    x2, w2 = randn(RING_ROWS, ff), randn(ff, d, scale=ff ** -0.5)
    rs = spmd.shard_map(partial(cm.ring_matmul_reduce_scatter, axis="x"), mesh,
                        (P(None, "x"), P("x", None)), P(None, "x"))
    err = _close(torch, rs(x2, w2), base(x2, w2),
                 "ring_matmul_reduce_scatter against the baseline")
    ms, base_ms = timer.turns(lambda: rs(x2, w2), lambda: base(x2, w2))
    out["ring_matmul_reduce_scatter"] = {"x": [RING_ROWS, ff], "w": [ff, d],
                                         "max_abs_err": err, "ms": ms, "baseline_ms": base_ms}
    del x, w, x2, w2

    # sequence-parallel decode attention over the KV positions
    b, hq, hkv, hd, s = SP_DECODE
    q = randn(b, hq, hd)
    k = randn(b, s, hkv, hd).repeat_interleave(hq // hkv, dim=2)
    v = randn(b, s, hkv, hd).repeat_interleave(hq // hkv, dim=2)
    valid = torch.tensor([s, s - s // 3, s // 2 + 1, 1], dtype=torch.int32, device=DEVICE)
    scale = hd ** -0.5

    def sp_body(q, k, v, valid):
        s_loc = k.shape[1]
        start = spmd.axis_index("x") * s_loc
        return sp_attention.sp_decode_attention(q, k, v, torch.clamp(valid - start, 0, s_loc),
                                                scale, axis="x")

    sp = spmd.shard_map(sp_body, mesh, (P(), P(None, "x"), P(None, "x"), P()), P())
    full = lambda: sp_attention.full_decode_attention_ref(q, k, v, valid, scale)  # noqa: E731
    err = _close(torch, sp(q, k, v, valid), full(), "sp_decode_attention against full")
    ms, full_ms = timer.turns(lambda: sp(q, k, v, valid), full)
    out["sp_decode_attention"] = {"B_Hq_Hkv_D_S": list(SP_DECODE), "valid": valid.tolist(),
                                  "max_abs_err": err, "ms": ms, "full_ms": full_ms}
    del q, k, v

    # the pipeline over MESH_RANKS stages of one d x d layer each
    ws = randn(n, d, d, scale=d ** -0.5)
    micro = randn(PIPE_MICRO, PIPE_ROWS, d)
    pipe = spmd.shard_map(
        lambda w, m: pipeline.pipeline_apply(lambda p, h: torch.tanh(h @ p), w[0], m, axis="x"),
        mesh, (P("x"), P()), P())

    def sequential():
        h = micro
        for i in range(n):
            h = torch.tanh(h @ ws[i])
        return h

    err = _close(torch, pipe(ws, micro), sequential(), "pipeline_apply against the loop")
    ms, seq_ms = timer.turns(lambda: pipe(ws, micro), sequential)
    out["pipeline_apply"] = {"stages": n, "micro": [PIPE_MICRO, PIPE_ROWS, d],
                             "bubble_fraction": pipeline.bubble_fraction(n, PIPE_MICRO),
                             "max_abs_err": err, "ms": ms, "sequential_ms": seq_ms}
    del ws, micro

    # ZeRO-1 on one llama3-8b layer's float32 parameters against AdamW
    shapes = {"wq": (d, cfg.n_heads * cfg.head_dim), "wk": (d, cfg.n_kv_heads * cfg.head_dim),
              "wv": (d, cfg.n_kv_heads * cfg.head_dim), "wo": (cfg.n_heads * cfg.head_dim, d),
              "w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d),
              "attn_norm": (d,), "mlp_norm": (d,)}
    params = {k_: randn(*sh, scale=0.02) for k_, sh in shapes.items()}
    shares, grads = {}, {}
    for k_, sh in shapes.items():
        shares[k_], grads[k_] = zero1_shares(torch, gen, sh, n)
    ocfg = api.adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    specs = {"m": P("x"), "v": P("x"), "step": P()}

    def z_body(p, sh, st):  # each rank's block of the leading axis is its share
        return zero1.zero1_update(p, {k_: v_[0] for k_, v_ in sh.items()}, st, ocfg, "x")

    z = spmd.shard_map(z_body, mesh, (P(), P("x"), specs), (P(), specs, P()))
    state = zero1.zero1_init_state(params, n)
    t0 = time.perf_counter()
    zp, zs, zinfo = z(params, shares, state)
    _sync(torch)
    z_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ap, _, ainfo = api.adamw.apply_updates(params, grads, api.adamw.init_state(params), ocfg)
    _sync(torch)
    a_ms = (time.perf_counter() - t0) * 1e3
    err = max(_close(torch, zp[k_], ap[k_], f"zero1 {k_} against adamw") for k_ in shapes)
    _close(torch, zinfo["grad_norm"], ainfo["grad_norm"], "zero1 grad norm against adamw")
    out["zero1_update"] = {"params": sum(p.numel() for p in params.values()),
                           "state_per_rank": sum(m.numel() for m in zs["m"].values()) // n,
                           "max_abs_err": err,
                           "bit_equal": all(torch.equal(zp[k_], ap[k_]) for k_ in shapes),
                           "host_ms": z_ms, "adamw_host_ms": a_ms}
    del params, grads, shares, state, zp, zs, ap

    # compressed_psum with error feedback: two rounds of w_gate's gradient
    g = randn(n, d * ff // 8, scale=0.1)
    cp = spmd.shard_map(lambda x_, r: compress.compressed_psum(x_, "x", r), mesh,
                        (P("x"), P("x")), (P("x"), P("x")))
    res = torch.zeros_like(g)
    want = g.sum(0, keepdim=True).expand_as(g)
    sums = []
    for rnd in range(2):
        vals = g + res
        deq = [compress.dequantize_int8(*compress.quantize_int8(vals[r:r + 1]),
                                        (1, g.shape[1]), torch.float32) for r in range(n)]
        exact = deq[0].clone()
        for dq in deq[1:]:
            exact = exact + dq
        got, res = cp(g, res)
        if not torch.equal(got, exact.expand_as(g)):
            raise AssertionError(f"compressed_psum round {rnd}: not the rank-order sum of "
                                 "the dequantized shards")
        sums.append(got)
    err1 = (sums[0] - want).abs().max().item()
    err2 = (sums[0] + sums[1] - 2 * want).abs().max().item()
    if not (err1 < 0.05 and err2 <= 2 * err1 + 1e-6):
        raise AssertionError(f"compressed_psum: error {err1} then {err2} over two rounds")
    out["compressed_psum"] = {"shape": list(g.shape), "round1_err": err1,
                              "two_round_err": err2,
                              "ratio": compress.compression_ratio(g.shape[1:])}
    return out


def mesh_without_cards(api) -> str:
    """Phase 14 (c): ``mesh=8`` on a machine with fewer cards must raise,
    never run on the CPU."""
    import torch

    if torch.cuda.device_count() >= 8:
        return "skipped: the machine has 8 cards"
    prog, hw = _mesh_programs(api)["ffn"]
    try:
        api.jit(prog, hw, "cuda", mesh=8)
    except ValueError as e:
        return str(e)
    raise AssertionError("phase 14: stripe_jit(mesh=8) ran on a machine with "
                         f"{torch.cuda.device_count()} card(s)")


# ------------------------------------------------------- the sharded step
def _mesh_names(shape) -> tuple:
    """A mesh's axes by its rank: ('data', 'model'), or the multi-pod
    ('pod', 'data', 'model')."""
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _card_mesh(shape):
    import numpy as np
    from repro_torch.parallel.spmd import Mesh

    return Mesh(np.array([_rank_device()] * math.prod(shape), dtype=object).reshape(shape),
                _mesh_names(shape))


def _timed(torch, fn) -> tuple:
    """``fn()`` once: its result, its CUDA-event ms (the ranks launch on
    the card's default stream, as the caller does) and its host ms, the
    card synchronized around it."""
    _sync(torch)
    if DEVICE == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    out = fn()
    if DEVICE == "cuda":
        b.record()
    _sync(torch)
    host = (time.perf_counter() - t0) * 1e3
    return out, (a.elapsed_time(b) if DEVICE == "cuda" else None), host


@contextlib.contextmanager
def collective_census():
    """Count rank 0's collectives of the sharded step inside the block, by
    kind, with the bytes each sends (its input): yields the dict that
    fills."""
    from repro_torch import tree as T
    from repro_torch.parallel import spmd

    out: dict = {}
    saved = {name: getattr(spmd, name) for name in ("psum", "pmax", "all_gather",
                                                     "psum_scatter")}

    def counted(name, fn):
        def call(x, *a, **kw):
            if spmd.current_rank() == 0:
                row = out.setdefault(name, {"calls": 0, "bytes": 0})
                row["calls"] += 1
                row["bytes"] += sum(t.numel() * t.element_size() for t in T.leaves(x))
            return fn(x, *a, **kw)
        return call

    for name, fn in saved.items():
        setattr(spmd, name, counted(name, fn))
    try:
        yield out
    finally:
        for name, fn in saved.items():
            setattr(spmd, name, fn)


def _free(torch) -> None:
    """Collect what an earlier case left (its autograd graphs hold
    reference cycles) and return the card's cached blocks."""
    import gc

    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def _peak_reset(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(torch):
    return torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else None


def _tree_gb(tree) -> float:
    """Bytes of a tree's tensors; a placed leaf's, summed over its shards."""
    from repro_torch import tree as T
    from repro_torch.parallel.spmd import Placed

    n = 0
    for leaf in T.leaves(tree):
        for t in (leaf.shards if isinstance(leaf, Placed) else [leaf]):
            n += t.numel() * t.element_size()
    return n / 1e9


def _leaf_err(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / (1.0 + want.abs().max()))


def _moe_drops(cfg, calls) -> int:
    """The (token, choice) pairs the capacity drops, over the recorded
    routing calls of one forward."""
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    out = 0
    for idx in calls:
        cap = max(int(math.ceil(cfg.moe.capacity_factor * idx.shape[0] * k / e)), 4)
        counts = idx.reshape(-1).bincount(minlength=e)
        out += int((counts - cap).clamp(min=0).sum())
    return out


def shard_train_case(torch, api, name: str, layers: int, shape=SHARD_MESH,
                     phase: int = 15) -> dict:
    """Phases 15 and 16 (a): ``sharded_loss_and_grads`` of ``name`` (full
    width, ``layers`` deep, an encoder-decoder's encoder too, float32) on
    ``shape`` against the single-device ``loss_and_grads`` on the same
    weights and batch."""
    from repro_torch import tree as T
    from repro_torch.nn import moe as moe_mod
    from repro_torch.parallel import sharded
    from repro_torch.train.loop import loss_and_grads

    cfg = api.configs.get(name)
    kw = {"n_layers": layers, "dtype": "float32"}
    if cfg.enc_dec:
        kw["n_enc_layers"] = layers
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, capacity_factor=SHARD_MOE_CAPACITY)
    cfg = dataclasses.replace(cfg, **kw)
    model = api.build_model(cfg)
    _peak_reset(torch)
    start = torch.cuda.memory_allocated() / 1e9 if DEVICE == "cuda" else None
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED + 15), device=DEVICE)
    batch = api.make_batch(cfg, "train", SHARD_BATCH, SHARD_SEQ, seed=SEED, device=DEVICE)
    mesh = _card_mesh(shape)
    placed = sharded.place_params(mesh, params)
    routed, route = [], moe_mod.route

    def recorded(p, x, c):
        probs, idx = route(p, x, c)
        routed.append(idx.detach())
        return probs, idx

    moe_mod.route = recorded
    try:
        (loss, grads), single_cold, _ = _timed(
            torch, lambda: loss_and_grads(model, params, batch, remat=False))
    finally:
        moe_mod.route = route
    with collective_census() as census:
        (sloss, sgrads), cold, _ = _timed(torch, lambda: sharded.sharded_loss_and_grads(
            model, mesh, placed, batch, timeout=SHARD_TIMEOUT))
    errs = {T.key_path(path): _leaf_err(g, want) for (path, _), g, want in
            zip(T.flatten_with_path(params)[0], sgrads, grads)}
    del grads, sgrads
    # the times: a second call of each (the first pays the card's warm-up)
    _, single_ev, single_host = _timed(torch, lambda: loss_and_grads(model, params, batch,
                                                                     remat=False)[0])
    _, ev, host = _timed(torch, lambda: sharded.sharded_loss_and_grads(
        model, mesh, placed, batch, timeout=SHARD_TIMEOUT)[0])
    row = {"config": name, "layers": layers, "mesh": list(shape), "dtype": "float32",
           "tokens": SHARD_BATCH * SHARD_SEQ, "loss": float(loss), "sharded_loss": float(sloss),
           "loss_rel_err": abs(float(sloss) - float(loss)) / abs(float(loss)),
           "single_gb": _tree_gb(params) * 2, "meshed_gb": _tree_gb(placed) * 2,
           "single_ms": single_ev, "single_host_ms": single_host, "sharded_ms": ev,
           "sharded_host_ms": host, "single_first_ms": single_cold, "sharded_first_ms": cold,
           "memory_at_start_gb": start, "peak_gb": _peak_gb(torch),
           "collectives_rank0": census}
    if cfg.moe:
        row["capacity_factor"] = cfg.moe.capacity_factor
        row["dropped_pairs"] = _moe_drops(cfg, routed)
        if row["dropped_pairs"] == 0:
            raise AssertionError(f"phase {phase} {name}: the capacity dropped no token")
    row["grad_err"] = max(errs.values())
    row["grad_err_by_leaf"] = errs
    if row["loss_rel_err"] > SHARD_LOSS_RTOL or row["grad_err"] > SHARD_GRAD_RTOL:
        raise AssertionError(f"phase {phase} {name} on {shape}: the sharded loss or gradients "
                             f"part from one device: {row}")
    return row


def shard_step_case(torch, api, layers: int = SHARD_STEP_LAYERS, shape=SHARD_MESH,
                    name: str = "llama3-8b", phase: int = 15) -> dict:
    """Phases 15 and 16 (a): one ``sharded_train_step`` of ``name`` (full
    width, float32) on ``shape`` against ``adamw.apply_updates_`` on one
    device, in that order of memory: the placed state first, the single
    step in place, its gradients freed, then the sharded step."""
    from repro_torch import tree as T
    from repro_torch.parallel import sharded
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.loop import loss_and_grads

    cfg = dataclasses.replace(api.configs.get(name), n_layers=layers, dtype="float32")
    model = api.build_model(cfg)
    ocfg = api.adamw.AdamWConfig()
    _peak_reset(torch)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED + 16), device=DEVICE)
    batch = api.make_batch(cfg, "train", SHARD_BATCH, SHARD_SEQ, seed=SEED, device=DEVICE)
    mesh = _card_mesh(shape)
    placed = sharded.place_params(mesh, params)
    pstate = sharded.place_opt_state(mesh, api.adamw.init_state(params))
    state = api.adamw.init_state(params)

    def single():
        loss, grads = loss_and_grads(model, params, batch, remat=False)
        return api.adamw.apply_updates_(params, T.unflatten(T.flatten(params)[1], grads),
                                        state, ocfg)

    info, single_ev, single_host = _timed(torch, single)
    del state
    sinfo, ev, host = _timed(torch, lambda: sharded.sharded_train_step(
        model, mesh, placed, pstate, batch, ocfg, timeout=SHARD_TIMEOUT))
    errs = [_leaf_err(shd.assemble(a), b) for a, b in zip(T.leaves(placed), T.leaves(params))]
    row = {"config": cfg.name, "layers": layers, "mesh": list(shape), "dtype": "float32",
           "grad_norm": float(info["grad_norm"]), "sharded_grad_norm": float(sinfo["grad_norm"]),
           "lr": float(sinfo["lr"]), "param_err": max(errs),
           "meshed_gb": _tree_gb(placed) + _tree_gb(pstate),
           "single_ms": single_ev, "single_host_ms": single_host, "sharded_ms": ev,
           "sharded_host_ms": host, "peak_gb": _peak_gb(torch)}
    gap = abs(row["sharded_grad_norm"] - row["grad_norm"]) / row["grad_norm"]
    if row["param_err"] > SHARD_PARAM_RTOL or gap > SHARD_GRAD_RTOL:
        raise AssertionError(f"phase {phase} {name}: the sharded AdamW step parts from one "
                             f"device: {row}")
    return row


def _row_held(a, b, vocab: int) -> float:
    """max |a - b| over each row of logits, over the row's largest |b|."""
    a, b = a[..., :vocab].float(), b[..., :vocab].float()
    return float(((a - b).abs().amax(dim=-1) / b.abs().amax(dim=-1)).max())


def _kv_spec(cache):
    """The placed KV cache's spec (an xLSTM, which has none: its first
    state's), as a list."""
    from repro_torch import tree as T

    pairs = T.flatten_with_path(cache)[0]
    leaf = next((leaf for path, leaf in pairs if path[-1] == "k"), pairs[0][1])
    return [list(e) if isinstance(e, tuple) else e for e in leaf.spec]


def shard_serve_case(torch, api, K, cfg, params, shape, batch_size: int, prompt: int,
                     steps: int, backend: str = "cuda", phase: int = 15) -> dict:
    """Phases 15 and 16 (b): ``sharded_prefill`` and ``steps``
    ``sharded_decode_step`` calls (greedy) on ``shape`` with oplib on
    ``backend``, B1's launches counted on ``cuda`` (every count set to 0
    just before, read just after; per rank from ``oplib.launches_by_rank``):
    one launch a projection of ``_model_ops`` a rank a call; then the
    single-device ``Model`` on the same tokens, each step's logits held
    within LOGIT_RTOL of the row's largest.  The hybrid's free logits are
    printed, not held (ROADMAP C10): the single-device run is repeated
    keeping each block's input and output, and a sharded replay feeds each
    rank's blocks those inputs, holding every block's output and then the
    logits (``hybrid_blocks``)."""
    from repro_torch.core import oplib
    from repro_torch.parallel import sharded

    model = api.build_model(cfg)
    mesh = _card_mesh(shape)
    placed = sharded.place_params(mesh, params)
    batch = api.make_batch(cfg, "prefill", batch_size, prompt, seed=SEED, device=DEVICE)
    old = oplib.get_backend()
    oplib.set_backend(backend)
    _peak_reset(torch)
    try:
        scache = sharded.init_cache(model, mesh, batch_size, SHARD_MAX_LEN)
        mods = _kernel_modules()
        _zero_counts(*mods.values())
        oplib.launches_by_rank.clear()
        oplib.rank_fallbacks.clear()
        with collective_census() as pre_census:
            (slog, scache), pre_ev, pre_host = _timed(
                torch, lambda: sharded.sharded_prefill(model, mesh, placed, batch, scache,
                                                       timeout=SHARD_TIMEOUT))
        pre_paths = dict(K.launches_by_path)
        pre_ranks = {r: dict(c) for r, c in oplib.launches_by_rank.items()}
        logits, toks, dec_ev, dec_host = [slog], [], [], []
        for j in range(steps):
            toks.append(logits[-1][:, -1:, :cfg.vocab].argmax(dim=-1).to(torch.int32))
            with collective_census() as census:
                (lg, scache), e, h = _timed(torch, lambda: sharded.sharded_decode_step(
                    model, mesh, placed, scache, toks[-1], timeout=SHARD_TIMEOUT))
            logits.append(lg)
            dec_ev.append(e)
            dec_host.append(h)
        counts = {name: mod.launches for name, mod in mods.items()}
        by_path = dict(K.launches_by_path)
        ranks = {r: dict(c) for r, c in oplib.launches_by_rank.items()}
        cache_spec = _kv_spec(scache)
        meshed_gb = _tree_gb(placed) + _tree_gb(scache)
        del scache

        def single(kept=None):
            """The single-device Model on ``toks`` (each hybrid block's input
            and output appended to ``kept``): its logits, call by call."""
            cache = model.init_cache(batch_size, SHARD_MAX_LEN, device=DEVICE)
            with hybrid_blocks(kept) if kept is not None else contextlib.nullcontext():
                (lg, cache), pre_t, pre_h = _timed(torch, lambda: model.prefill(params, batch,
                                                                                cache))
                out, dec_t, dec_h = [lg], [], []
                for j in range(steps):
                    (lg, cache), e, h = _timed(torch, lambda: model.decode_step(params, cache,
                                                                                toks[j]))
                    out.append(lg)
                    dec_t.append(e)
                    dec_h.append(h)
            return out, pre_t, pre_h, dec_t, dec_h

        # the hybrid's single run keeps each block's input and output
        kept = [] if cfg.family == "hybrid" else None
        ref, s_pre_ev, s_pre_host, s_dec_ev, s_dec_host = single(kept)
        held = [_row_held(a, b, cfg.vocab) for a, b in zip(logits, ref)]
        replay = {}
        if kept is not None:
            # C10: the free logits part; hold each block on the same input
            blocks = {"max": 0.0, "blocks": 0}

            def block_held(out, want):
                rel = ((out.float() - want.float()).abs().max()
                       / want.float().abs().max()).item()
                blocks["max"] = max(blocks["max"], rel)
                blocks["blocks"] += 1
                if not rel <= LOGIT_RTOL:
                    raise AssertionError(f"phase {phase} {cfg.name} on {shape}: a block of the "
                                         f"replay differs by {rel:.3e} of its largest output")

            rcache = sharded.init_cache(model, mesh, batch_size, SHARD_MAX_LEN)
            with hybrid_blocks(kept, block_held):
                rl, rcache = sharded.sharded_prefill(model, mesh, placed, batch, rcache,
                                                     timeout=SHARD_TIMEOUT)
                rlogits = [rl]
                for j in range(steps):
                    rl, rcache = sharded.sharded_decode_step(model, mesh, placed, rcache,
                                                             toks[j], timeout=SHARD_TIMEOUT)
                    rlogits.append(rl)
            del rcache, kept
            replay = {"free_held_max": max(held), "free_held_by_call": held,
                      "blocks_held": blocks["blocks"], "block_err_max": blocks["max"]}
            held = [_row_held(a, b, cfg.vocab) for a, b in zip(rlogits, ref)]
    finally:
        oplib.set_backend(old)
    per_rank = len(_model_ops(cfg)) if backend == "cuda" else 0
    row = {"config": cfg.name, "layers": cfg.n_layers, "mesh": list(shape), "dtype": cfg.dtype,
           "backend": backend, "batch": batch_size, "prompt": prompt, "decode_steps": steps,
           "cache_spec": cache_spec, "held_max": max(held), "held_by_call": held, **replay,
           "prefill_ms": pre_ev, "prefill_host_ms": pre_host,
           "single_prefill_ms": s_pre_ev, "single_prefill_host_ms": s_pre_host,
           "decode_step_ms_median": _median(dec_ev), "decode_step_host_ms_median":
               statistics.median(dec_host),
           "single_decode_step_ms_median": _median(s_dec_ev),
           "single_decode_step_host_ms_median": statistics.median(s_dec_host),
           "launches": counts, "contraction_by_path": {
               "prefill": pre_paths,
               "decode": {p: by_path[p] - pre_paths.get(p, 0) for p in by_path}},
           "launches_by_rank": {str(r): c for r, c in sorted(ranks.items())},
           "torch_units": dict(oplib.rank_fallbacks),
           "collectives_rank0": {"prefill": pre_census, "decode_step": census},
           "prefill_launches_by_rank": {str(r): c for r, c in sorted(pre_ranks.items())},
           "meshed_gb": meshed_gb, "peak_gb": _peak_gb(torch)}
    if row["held_max"] > LOGIT_RTOL:
        raise AssertionError(f"phase {phase} {cfg.name} serving on {shape}: logits part from "
                             f"one device: {held}")
    if DEVICE == "cuda" and backend == "cuda":
        # every projection a launch, but a unit the legality check sent to
        # torch (recorded, with its reason, in ``torch_units``)
        want = per_rank * (1 + steps)
        got = {r: sum(v for k, v in c.items() if k.startswith("contraction/"))
               + c.get("torch_units", 0) for r, c in ranks.items()}
        if sorted(got) != list(range(mesh.size)) or any(n != want for n in got.values()) \
                or by_path.get("general", 0):
            raise AssertionError(f"phase {phase} {cfg.name} serving on {shape}: B1 launches and "
                                 f"torch units by rank {got}, expected {want} on each of "
                                 f"{mesh.size} ranks and none on the general loop ({by_path}; "
                                 f"{ranks})")
    if backend != "cuda" and any(counts.values()):
        raise AssertionError(f"phase {phase} {cfg.name} on {backend} launched {counts}")
    return row


def _median(xs):
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def shard_restore_case(torch, api, workdir: Path) -> dict:
    """Phase 15 (c): a checkpoint saved from SHARD_MESH restores onto
    SHARD_SERVE_MESH bit-equal."""
    from repro_torch import tree as T
    from repro_torch.parallel import sharded
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import checkpoint as ckpt

    cfg = dataclasses.replace(api.configs.get("llama3-8b"), n_layers=SHARD_CKPT_LAYERS)
    params = api.build_model(cfg).init(torch.Generator(device=DEVICE).manual_seed(SEED + 17),
                                       device=DEVICE)
    src, dst = _card_mesh(SHARD_MESH), _card_mesh(SHARD_SERVE_MESH)
    placed = sharded.place_params(src, params)
    _, _, save_host = _timed(torch, lambda: ckpt.save(str(workdir), 1, {"params": placed}))
    sh = shd.make_sharding(dst, shd.param_specs(params, dict(dst.shape)))
    (step, out), _, restore_host = _timed(torch, lambda: ckpt.restore(
        str(workdir), {"params": params}, shardings={"params": sh}))
    equal = all(torch.equal(shd.assemble(a), b) for a, b in zip(T.leaves(out["params"]),
                                                                T.leaves(params)))
    row = {"config": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "gb": _tree_gb(params), "saved_from": list(SHARD_MESH),
           "restored_onto": list(SHARD_SERVE_MESH), "step": step, "bit_equal": equal,
           "save_host_ms": save_host, "restore_host_ms": restore_host}
    if not equal or step != 1:
        raise AssertionError(f"phase 15: restore(shardings=) is not bit-equal: {row}")
    return row


def sharded_phase(torch, api, K, card: str, layers: int | None) -> dict:
    """Phase 15: (a), (b) and (c) (see the module docstring)."""
    out = {"train": [], "memory_at_start_gb": (torch.cuda.memory_allocated() / 1e9
                                               if DEVICE == "cuda" else None)}
    print(f"sharded: {out['memory_at_start_gb']} GB allocated on the card at the start of "
          f"phase 15; card {card}", flush=True)
    for name, depth in SHARD_LAYERS.items():
        depth = min(depth, layers or depth)
        _free(torch)
        t0 = time.perf_counter()
        row = shard_train_case(torch, api, name, depth)
        row["wall_s"] = time.perf_counter() - t0
        out["train"].append(row)
        print("  sharded loss " + json.dumps({k: v for k, v in row.items()
                                               if k != "grad_err_by_leaf"}), flush=True)
    _free(torch)
    t0 = time.perf_counter()
    out["step"] = shard_step_case(torch, api)
    out["step"]["wall_s"] = time.perf_counter() - t0
    print("  sharded step " + json.dumps(out["step"]), flush=True)
    _free(torch)
    # (b) llama3-8b at full width and depth, bf16
    full = api.configs.get("llama3-8b")
    cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
    t0 = time.perf_counter()
    params = api.build_model(cfg).init(torch.Generator(device=DEVICE).manual_seed(SEED),
                                       device=DEVICE)
    _sync(torch)
    print(f"  sharded serve: {cfg.name} {cfg.n_layers} layers drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sp = dataclasses.replace(cfg, n_layers=min(SHARD_SP_LAYERS, cfg.n_layers))
    sp_params = dict(params, blocks={k: {n: t[:sp.n_layers] for n, t in v.items()}
                                     if isinstance(v, dict) else v[:sp.n_layers]
                                     for k, v in params["blocks"].items()})
    out["serve"] = []
    for c, p, shape, b in ((cfg, params, SHARD_SERVE_MESH, MODEL_BATCH),
                           (sp, sp_params, SHARD_SP_MESH, 1)):
        t0 = time.perf_counter()
        row = shard_serve_case(torch, api, K, c, p, shape, b, MODEL_PROMPT, MODEL_STEPS)
        row["wall_s"] = time.perf_counter() - t0
        out["serve"].append(row)
        print("  sharded serve " + json.dumps(row), flush=True)
    del params, sp_params
    _free(torch)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        out["restore"] = shard_restore_case(torch, api, Path(d))
    print("  sharded restore " + json.dumps(out["restore"]), flush=True)
    launches = {}
    for row in out["serve"]:
        for name, n in row["launches"].items():
            launches[name] = launches.get(name, 0) + n
    out["launches"] = launches
    return out


def family_phase(torch, api, K, card: str, layers: int | None) -> dict:
    """Phase 16: (a) and (b) (see the module docstring)."""
    out = {"train": [], "serve": [], "memory_at_start_gb": (torch.cuda.memory_allocated() / 1e9
                                                            if DEVICE == "cuda" else None)}
    print(f"sharded families: {out['memory_at_start_gb']} GB allocated on the card at the start "
          f"of phase 16; card {card}", flush=True)
    for name, depth in FAMILY_SHARD_LAYERS.items():
        depth = min(depth, layers or depth)
        _free(torch)
        t0 = time.perf_counter()
        row = shard_train_case(torch, api, name, depth, phase=16)
        row["wall_s"] = time.perf_counter() - t0
        out["train"].append(row)
        print("  sharded loss " + json.dumps({k: v for k, v in row.items()
                                               if k != "grad_err_by_leaf"}), flush=True)
    _free(torch)
    t0 = time.perf_counter()
    out["step"] = shard_step_case(torch, api, min(FAMILY_STEP_LAYERS, layers or 6),
                                  name="zamba2-2.7b", phase=16)
    out["step"]["wall_s"] = time.perf_counter() - t0
    print("  sharded step " + json.dumps(out["step"]), flush=True)
    # (b) serving, bf16, at full width
    sp_layers = min(FAMILY_SP_LAYERS, layers or FAMILY_SP_LAYERS)
    cases = [(name, None, SHARD_SERVE_MESH, MODEL_BATCH) for name in FAMILIES] + [
        ("zamba2-2.7b", sp_layers, SHARD_SP_MESH, 1)]
    for name, depth, shape, b in cases:
        _free(torch)
        full = api.configs.get(name)
        depth = depth or layers or full.n_layers
        kw = {"n_layers": depth, **({"n_enc_layers": depth} if full.enc_dec else {})}
        cfg = dataclasses.replace(full, **kw)
        t0 = time.perf_counter()
        params = api.build_model(cfg).init(torch.Generator(device=DEVICE).manual_seed(SEED),
                                           device=DEVICE)
        row = shard_serve_case(torch, api, K, cfg, params, shape, b, MODEL_PROMPT, MODEL_STEPS,
                               backend=oplib_backends(cfg)[0], phase=16)
        row["wall_s"] = time.perf_counter() - t0
        del params
        out["serve"].append(row)
        print("  sharded serve " + json.dumps(row), flush=True)
    _free(torch)
    launches = {}
    for row in out["serve"]:
        for name, n in row["launches"].items():
            launches[name] = launches.get(name, 0) + n
    out["launches"] = launches
    return out


def _dry_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    """One cell of ``dryrun_cells``, in a worker process."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    row = dryrun.run_cell(arch, shape, multi_pod=multi_pod)
    row["wall_s"] = time.perf_counter() - t0
    return row


def dryrun_cells(cells, multi_pod: bool = False, phase: str = "17 (a)") -> list:
    """Phases 17 (a) and 18 (d): ``dryrun.run_cell`` of each cell on the
    16 x 16 production mesh of meta devices (``multi_pod``: 2 x 16 x 16),
    rank 0 alone, in ``DRYRUN_WORKERS`` processes at once (started fresh:
    they touch no card); each row ``ok``, with FLOPs, argument bytes and
    collectives."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(DRYRUN_WORKERS, mp_context=ctx) as pool:
        rows = list(pool.map(_dry_cell, [a for a, _ in cells], [s for _, s in cells],
                             [multi_pod] * len(cells)))
    n, mesh = (512, "2x16x16") if multi_pod else (256, "16x16")
    for (arch, shape), row in zip(cells, rows):
        if not (row["ok"] and row["rank0_only"] and row["n_devices"] == n and row["mesh"] == mesh
                and row["cost"]["flops"] > 0 and row["memory"]["argument_size_in_bytes"] > 0
                and row["collective_bytes"] > 0):
            raise AssertionError(f"phase {phase} {arch} x {shape}: {row}")
        print("  dryrun " + json.dumps(row), flush=True)
    return rows


def _census_kinds(census) -> dict:
    """``collective_census``'s calls and bytes by the dry run's HLO kind."""
    from repro_torch.launch import dryrun

    out: dict = {}
    for name, row in census.items():
        kind = out.setdefault(dryrun.HLO_KIND[name], {"count": 0, "operand_bytes": 0})
        kind["count"] += row["calls"]
        kind["operand_bytes"] += row["bytes"]
    return out


def dryrun_against_card(torch, api, name: str = "llama3-8b",
                        layers: int = SHARD_STEP_LAYERS, shape=SHARD_MESH,
                        phase: str = "17 (b)") -> dict:
    """Phases 17 (b) and 18 (c): the dry run of a train-step case (``name``
    at full width, ``layers`` deep, float32, ``SHARD_BATCH`` x
    ``SHARD_SEQ`` tokens) on ``shape`` meta devices, rank 0 alone,
    against a ``sharded_train_step`` of it on as many ranks of the card:
    the argument bytes must equal those of rank 0's placed shards and
    batch block, and the collectives (kind, count, bytes sent) phase 15's
    ``collective_census`` of the card's first step; a second step is
    timed (the first pays the card's warm-up)."""
    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import dp_axes, make_mesh
    from repro_torch.parallel import sharded, spmd
    from repro_torch.parallel.spmd import Placed

    cfg = dataclasses.replace(api.configs.get(name), n_layers=layers, dtype="float32")
    spec = ShapeSpec("phase15", SHARD_SEQ, SHARD_BATCH, "train")
    t0 = time.perf_counter()
    row = dryrun.run_cell(name, spec, cfg=cfg, mesh=make_mesh(
        shape, _mesh_names(shape), ["meta"] * math.prod(shape)))
    meta_s = time.perf_counter() - t0
    model = api.build_model(cfg)
    _peak_reset(torch)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED + 17), device=DEVICE)
    batch = api.make_batch(cfg, "train", SHARD_BATCH, SHARD_SEQ, seed=SEED, device=DEVICE)
    mesh = _card_mesh(shape)
    placed = sharded.place_params(mesh, params)
    state = sharded.place_opt_state(mesh, api.adamw.init_state(params))
    del params
    card_bytes = sum(leaf.shards[0].numel() * leaf.shards[0].element_size()
                     for tree in (placed, state) for leaf in T.leaves(tree)
                     if isinstance(leaf, Placed))
    card_bytes += sum(spmd.block_of(mesh, 0, t, spmd.P(dp_axes(mesh))).numel()
                      * t.element_size() for t in batch.values())
    step = lambda: sharded.sharded_train_step(model, mesh, placed, state, batch,
                                              api.adamw.AdamWConfig(), timeout=SHARD_TIMEOUT)
    with collective_census() as census:
        info, first, _ = _timed(torch, step)
    _, ev, host = _timed(torch, step)
    card = _census_kinds(census)
    meta = {k: {"count": d["count"], "operand_bytes": d["operand_bytes"]}
            for k, d in row["collectives"].items()}
    out = {"config": name, "layers": layers, "mesh": list(shape), "dtype": "float32",
           "tokens": SHARD_BATCH * SHARD_SEQ,
           "predicted_argument_bytes": row["memory"]["argument_size_in_bytes"],
           "card_argument_bytes": card_bytes, "predicted_collectives": meta,
           "card_collectives": card, "rank0_flops": row["cost"]["flops"],
           "loss": float(info["loss"]), "trace_s": meta_s, "card_first_ms": first,
           "card_ms": ev, "card_host_ms": host, "peak_gb": _peak_gb(torch)}
    if card_bytes != out["predicted_argument_bytes"] or card != meta:
        raise AssertionError(f"phase {phase}: the dry run's prediction parts from the card: {out}")
    return out


def run_examples(env_dir: Path, args=()) -> list:
    """Phase 17 (d): each example twin at its default preset on the card
    (``args`` added to each command line), in its own process within
    ``EXAMPLE_TIMEOUT``; its exit code must be 0, and its kernels'
    launches are read from its last line."""
    import os

    rows = []
    env = dict(os.environ, PYTHONPATH=str(SRC), STRIPE_CACHE_DIR=str(env_dir / "cache"))
    for script in EXAMPLES:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", EXAMPLE_RUNNER,
                              str(ROOT / "examples" / script), *args],
                             env=env, cwd=str(env_dir), capture_output=True, text=True,
                             timeout=EXAMPLE_TIMEOUT)
        wall = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"phase 17 (d) {script} exited {run.returncode}:\n"
                                 f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
        last = run.stdout.strip().splitlines()[-1]
        if not last.startswith("example launches "):
            raise AssertionError(f"phase 17 (d) {script}: no launch counts: {last}")
        launches = json.loads(last[len("example launches "):])
        rows.append({"example": script, "rc": run.returncode, "wall_s": wall,
                     "launches": launches,
                     "tail": run.stdout.strip().splitlines()[-4:-1]})
        print("  example " + json.dumps(rows[-1]), flush=True)
    return rows


def dryrun_phase(torch, api, card: str) -> dict:
    """Phase 17: (a), (b), (c) and (d) (see the module docstring)."""
    from repro_torch.launch import roofline

    out = {}
    t0 = time.perf_counter()
    out["rows"] = dryrun_cells(DRYRUN_CELLS)
    out["cells_s"] = time.perf_counter() - t0
    print(f"dryrun: {len(out['rows'])} cells on the 16x16 mesh of meta devices, rank 0 "
          f"alone, in {out['cells_s']:.1f} s on the host", flush=True)
    _free(torch)
    t0 = time.perf_counter()
    out["card"] = dryrun_against_card(torch, api)
    out["card"]["wall_s"] = time.perf_counter() - t0
    print("  dryrun against the card " + json.dumps(out["card"]), flush=True)
    _free(torch)
    roof = roofline.analyze(out["rows"])
    print(roofline.markdown_table(roof), flush=True)
    print("dryrun: the five worst roofline fractions (H100 data-sheet figures):", flush=True)
    for r in roofline.worst(roof):
        print(f"  {r['arch']} x {r['shape']}: {r['roofline_fraction']:.3f} ({r['dominant']}) "
              f"-> {roofline.NOTES[r['dominant']]}", flush=True)
    out["roofline"] = roof
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        t0 = time.perf_counter()
        out["examples"] = run_examples(Path(d))
        out["examples_s"] = time.perf_counter() - t0
    launches: dict = {}
    for row in out["examples"]:
        for name, n in row["launches"].items():
            if isinstance(n, int):
                launches[name] = launches.get(name, 0) + n
    if not launches.get("contraction") or not launches.get("windowed"):
        raise AssertionError(f"phase 17 (d): the examples launched {launches}")
    out["launches"] = launches
    return out


# ------------------------------------------------------- the multi-pod mesh
def _pod_cfg(api, name: str, layers: int):
    """``name`` at full width, ``layers`` deep, float32 (a MoE at
    ``SHARD_MOE_CAPACITY``)."""
    cfg = api.configs.get(name)
    kw = {"n_layers": layers, "dtype": "float32"}
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, capacity_factor=SHARD_MOE_CAPACITY)
    return dataclasses.replace(cfg, **kw)


def _on_host(tensors) -> list:
    """Copies on the host: what a later hold reads while the card runs
    the next mesh."""
    return [t.detach().cpu() for t in tensors]


def _same_rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def pod_train_case(torch, api, name: str, layers: int) -> dict:
    """Phase 18 (a): ``sharded_loss_and_grads`` of ``name`` on POD_MESH
    against the single-device ``loss_and_grads`` (phase 15's holds) and
    against the same call on POD_DATA_MESH (``POD_SAME_RTOL``); each run's
    gradients kept on the host while the next one runs."""
    from repro_torch import tree as T
    from repro_torch.nn import moe as moe_mod
    from repro_torch.parallel import sharded
    from repro_torch.train.loop import loss_and_grads

    cfg = _pod_cfg(api, name, layers)
    model = api.build_model(cfg)
    _peak_reset(torch)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED + 18), device=DEVICE)
    batch = api.make_batch(cfg, "train", SHARD_BATCH, SHARD_SEQ, seed=SEED, device=DEVICE)
    routed, route = [], moe_mod.route

    def recorded(p, x, c):
        probs, idx = route(p, x, c)
        routed.append(idx.detach())
        return probs, idx

    moe_mod.route = recorded
    try:
        (loss, grads), single_ms, single_host = _timed(
            torch, lambda: loss_and_grads(model, params, batch, remat=False))
    finally:
        moe_mod.route = route
    want = _on_host(grads)
    del grads
    runs = {}
    for shape in (POD_MESH, POD_DATA_MESH):
        mesh = _card_mesh(shape)
        placed = sharded.place_params(mesh, params)
        with collective_census() as census:
            (sloss, sgrads), ev, host = _timed(torch, lambda: sharded.sharded_loss_and_grads(
                model, mesh, placed, batch, timeout=SHARD_TIMEOUT))
        runs[shape] = {"loss": float(sloss), "grads": _on_host(sgrads), "ms": ev, "host_ms": host,
                       "collectives_rank0": census}
        del placed, sgrads
        _free(torch)
    pod, data = runs[POD_MESH], runs[POD_DATA_MESH]
    paths = [T.key_path(path) for path, _ in T.flatten_with_path(params)[0]]
    errs = {path: _leaf_err(g, w) for path, g, w in zip(paths, pod["grads"], want)}
    row = {"config": name, "layers": layers, "mesh": list(POD_MESH),
           "data_mesh": list(POD_DATA_MESH), "dtype": "float32",
           "tokens": SHARD_BATCH * SHARD_SEQ, "loss": float(loss), "pod_loss": pod["loss"],
           "loss_rel_err": _same_rel(pod["loss"], float(loss)),
           "grad_err": max(errs.values()),
           "data_mesh_loss_rel_err": _same_rel(pod["loss"], data["loss"]),
           "data_mesh_grad_err": max(_leaf_err(g, d) for g, d in zip(pod["grads"], data["grads"])),
           "single_first_ms": single_ms, "single_first_host_ms": single_host,
           "pod_first_ms": pod["ms"], "pod_first_host_ms": pod["host_ms"],
           "data_mesh_first_ms": data["ms"], "data_mesh_first_host_ms": data["host_ms"],
           "peak_gb": _peak_gb(torch), "collectives_rank0": pod["collectives_rank0"],
           "data_mesh_collectives_rank0": data["collectives_rank0"]}
    if cfg.moe:
        row["capacity_factor"] = cfg.moe.capacity_factor
        row["dropped_pairs"] = _moe_drops(cfg, routed)
        if row["dropped_pairs"] == 0:
            raise AssertionError(f"phase 18 {name}: the capacity dropped no token")
    if row["loss_rel_err"] > SHARD_LOSS_RTOL or row["grad_err"] > SHARD_GRAD_RTOL:
        raise AssertionError(f"phase 18 {name} on {POD_MESH}: the sharded loss or gradients part "
                             f"from one device: {row}, by leaf {errs}")
    if row["data_mesh_loss_rel_err"] > POD_SAME_RTOL or row["data_mesh_grad_err"] > POD_SAME_RTOL:
        raise AssertionError(f"phase 18 {name}: {POD_MESH} parts from {POD_DATA_MESH}: {row}")
    return row


def pod_step_case(torch, api, name: str, layers: int) -> dict:
    """Phase 18 (a): one ``sharded_train_step`` of ``name`` on its
    ``POD_STEP_MESH`` mesh against ``apply_updates_`` on one device and
    against the same step on the 'data' mesh of the same batch blocks.
    Each mesh's step runs first from the same weights (its parameters
    assembled onto the host, its placed state freed), then the
    single-device step in place."""
    from repro_torch import tree as T
    from repro_torch.parallel import sharded
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.loop import loss_and_grads

    cfg = _pod_cfg(api, name, layers)
    model = api.build_model(cfg)
    ocfg = api.adamw.AdamWConfig()
    _peak_reset(torch)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED + 19), device=DEVICE)
    batch = api.make_batch(cfg, "train", SHARD_BATCH, SHARD_SEQ, seed=SEED, device=DEVICE)
    runs = {}
    for shape in POD_STEP_MESH[name]:
        mesh = _card_mesh(shape)
        placed = sharded.place_params(mesh, params)
        pstate = sharded.place_opt_state(mesh, api.adamw.init_state(params))
        info, ev, host = _timed(torch, lambda: sharded.sharded_train_step(
            model, mesh, placed, pstate, batch, ocfg, timeout=SHARD_TIMEOUT))
        runs[shape] = {"grad_norm": float(info["grad_norm"]), "ms": ev, "host_ms": host,
                       "params": [shd.assemble(leaf).cpu() for leaf in T.leaves(placed)]}
        del placed, pstate
        _free(torch)
    state = api.adamw.init_state(params)

    def single():
        loss, grads = loss_and_grads(model, params, batch, remat=False)
        return api.adamw.apply_updates_(params, T.unflatten(T.flatten(params)[1], grads),
                                        state, ocfg)

    info, single_ev, single_host = _timed(torch, single)
    want = _on_host(T.leaves(params))
    mesh_shape, data_shape = POD_STEP_MESH[name]
    pod, data = runs[mesh_shape], runs[data_shape]
    row = {"config": name, "layers": layers, "mesh": list(mesh_shape),
           "data_mesh": list(data_shape), "dtype": "float32",
           "grad_norm": float(info["grad_norm"]), "pod_grad_norm": pod["grad_norm"],
           "param_err": max(_leaf_err(a, b) for a, b in zip(pod["params"], want)),
           "data_mesh_grad_norm_rel_err": _same_rel(pod["grad_norm"], data["grad_norm"]),
           "data_mesh_param_err": max(_leaf_err(a, b) for a, b in zip(pod["params"],
                                                                      data["params"])),
           "single_ms": single_ev, "single_host_ms": single_host, "pod_first_ms": pod["ms"],
           "pod_first_host_ms": pod["host_ms"], "data_mesh_first_ms": data["ms"],
           "peak_gb": _peak_gb(torch)}
    gap = _same_rel(row["pod_grad_norm"], row["grad_norm"])
    if row["param_err"] > SHARD_PARAM_RTOL or gap > SHARD_GRAD_RTOL:
        raise AssertionError(f"phase 18 {name}: the sharded AdamW step parts from one device: "
                             f"{row}")
    if row["data_mesh_param_err"] > POD_SAME_RTOL or \
            row["data_mesh_grad_norm_rel_err"] > POD_SAME_RTOL:
        raise AssertionError(f"phase 18 {name}: the step on {mesh_shape} parts from "
                             f"{data_shape}: {row}")
    return row


def pod_phase(torch, api, K, card: str, layers: int | None, single_pod_rows: list) -> dict:
    """Phase 18: (a), (b), (c) and (d) (see the module docstring);
    ``single_pod_rows``: phase 17 (a)'s, for the roofline of both
    meshes."""
    from repro_torch.launch import roofline

    out = {"train": [], "step": [], "memory_at_start_gb": (torch.cuda.memory_allocated() / 1e9
                                                           if DEVICE == "cuda" else None)}
    print(f"multi-pod: {out['memory_at_start_gb']} GB allocated on the card at the start of "
          f"phase 18; card {card}", flush=True)
    for name, depth in POD_LAYERS.items():
        depth = min(depth, layers or depth)
        for case, key in ((pod_train_case, "train"), (pod_step_case, "step")):
            _free(torch)
            t0 = time.perf_counter()
            row = case(torch, api, name, depth)
            row["wall_s"] = time.perf_counter() - t0
            out[key].append(row)
            print(f"  multi-pod {'loss' if key == 'train' else 'step'} " + json.dumps(row),
                  flush=True)
    _free(torch)
    # (b) llama3-8b at full width and depth, bf16
    full = api.configs.get("llama3-8b")
    cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
    params = api.build_model(cfg).init(torch.Generator(device=DEVICE).manual_seed(SEED),
                                       device=DEVICE)
    sp = dataclasses.replace(cfg, n_layers=min(SHARD_SP_LAYERS, cfg.n_layers))
    sp_params = dict(params, blocks={k: {n: t[:sp.n_layers] for n, t in v.items()}
                                     if isinstance(v, dict) else v[:sp.n_layers]
                                     for k, v in params["blocks"].items()})
    out["serve"] = []
    for c, p, shape, b in ((cfg, params, POD_SERVE_MESH, MODEL_BATCH),
                           (sp, sp_params, POD_SP_MESH, 1)):
        t0 = time.perf_counter()
        row = shard_serve_case(torch, api, K, c, p, shape, b, MODEL_PROMPT, MODEL_STEPS, phase=18)
        row["wall_s"] = time.perf_counter() - t0
        out["serve"].append(row)
        print("  multi-pod serve " + json.dumps(row), flush=True)
    del params, sp_params
    _free(torch)
    # (c) the dry run's prediction against the card on multi-pod meshes
    out["card"] = []
    for name, depth, shape in (("llama3-8b", POD_LAYERS["llama3-8b"],
                                POD_STEP_MESH["llama3-8b"][0]),
                               ("zamba2-2.7b", POD_LAYERS["zamba2-2.7b"], POD_MESH)):
        t0 = time.perf_counter()
        row = dryrun_against_card(torch, api, name, min(depth, layers or depth), shape,
                                  phase="18 (c)")
        row["wall_s"] = time.perf_counter() - t0
        out["card"].append(row)
        print("  multi-pod dryrun against the card " + json.dumps(row), flush=True)
        _free(torch)
    # (d) the multi-pod rows, and the roofline of both meshes
    t0 = time.perf_counter()
    out["rows"] = dryrun_cells(DRYRUN_CELLS, multi_pod=True, phase="18 (d)")
    out["cells_s"] = time.perf_counter() - t0
    print(f"multi-pod: {len(out['rows'])} cells on the 2x16x16 mesh of meta devices, rank 0 "
          f"alone, in {out['cells_s']:.1f} s on the host ({DRYRUN_WORKERS} processes)",
          flush=True)
    roof = roofline.analyze(single_pod_rows + out["rows"])
    print(roofline.markdown_table(roof), flush=True)
    print("multi-pod: the five worst single-pod roofline fractions (H100 data-sheet figures):",
          flush=True)
    for r in roofline.worst(roof):
        print(f"  {r['arch']} x {r['shape']}: {r['roofline_fraction']:.3f} ({r['dominant']})",
              flush=True)
    out["roofline"] = roof
    launches: dict = {}
    for row in out["serve"]:
        for name, n in row["launches"].items():
            launches[name] = launches.get(name, 0) + n
    out["launches"] = launches
    return out


def _scatter_dispatch(torch, xt, eid, e: int, k: int, cap: int):
    """The dispatch as ``moe_apply`` took it before the positions kernel:
    a running count (``cumsum``) of the pairs' one-hot, k copies of each
    token, the kept ones scatter-added into zeroed rows; returns the
    experts' rows (e * cap, d)."""
    t, d = xt.shape
    onehot = (eid[:, None] == torch.arange(e, device=eid.device)).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, eid[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, eid * cap + pos, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=xt.device).index_add_(
        0, slot, xt.repeat_interleave(k, dim=0) * keep[:, None].to(xt.dtype))
    return buf[: e * cap]


def _sorted_positions(torch, eid, e: int, cap: int):
    """The positions kernel's ``(pair_of_slot, dropped)`` (one block, every
    expert) from a stable sort of the expert ids: each pair's position is
    its place in the sorted order less its expert's start (an exclusive
    running count of ``bincount``).  Timed in phase 19 as the simplest
    exact formulation without a (pairs x experts) tensor."""
    n = eid.numel()
    eid_sorted, order = torch.sort(eid, stable=True)
    counts = torch.bincount(eid, minlength=e)
    pos = torch.arange(n, device=eid.device) - (torch.cumsum(counts, 0) - counts)[eid_sorted]
    keep = pos < cap
    slot = torch.where(keep, eid_sorted * cap + pos, e * cap)
    pair_of_slot = torch.full((e * cap + 1,), n, dtype=torch.int64, device=eid.device).scatter_(
        0, slot, torch.where(keep, order, n))[: e * cap]
    return pair_of_slot, (~keep).sum()


def moe_dispatch_phase(torch, timer) -> dict:
    """Phase 19: the MoE dispatch's positions kernel (``csrc/moe_dispatch.cu``)
    and the gather of the experts' rows at ``MOE_DISPATCH_SHAPES``, on
    routing drawn from the seed (each token's k experts distinct).  The
    kernel's ``pair_of_slot`` and drop count must equal its plain
    version's (the ``cumsum`` formulation, run on the card) and the stable
    sort's (``_sorted_positions``) exactly, and the gathered rows the rows
    of the dispatch before it (``_scatter_dispatch``) bit for bit.  Timed
    with CUDA events (median, L2 flushed): the positions alone, as the
    kernel's two launches (``ms``), the plain version (``plain_ms``) and
    the sort (``sort_ms``); the gather; and the whole new dispatch (the
    kernel, the slots' tokens, the zero row, the gather: ``whole_ms``) in
    turns with the whole dispatch before it (``before_ms``).  Bounds by
    bytes at ``HBM_BYTES_PER_S``, each input read once and each output
    written once: the positions' (``bound_ms``: the ids and
    ``pair_of_slot``) and the whole dispatch's (``whole_bound_ms``: the
    ids, the tokens and the experts' rows)."""
    import numpy as np
    from repro_torch.kernels import moe_dispatch as MD

    rows = []
    MD.launches = 0
    for t, k, e, cap, d in MOE_DISPATCH_SHAPES:
        rng = np.random.RandomState(SEED + t)
        ids = np.argsort(-rng.randn(t, e), axis=1, kind="stable")[:, :k]
        eid = torch.from_numpy(ids.reshape(-1).copy()).to(DEVICE)
        xt = torch.from_numpy(rng.randn(t, d).astype(np.float32)).to(
            device=DEVICE, dtype=torch.bfloat16)
        n = t * k
        before = MD.launches
        got = MD.dispatch(eid, e, cap)
        _sync(torch)
        if MD.launches != before + 2:
            raise AssertionError(f"moe_dispatch: {MD.launches - before} launches a call, want 2")
        for name, want in (("plain version", MD.dispatch_plain(eid, e, cap, (0, e))),
                           ("stable sort", _sorted_positions(torch, eid, e, cap))):
            for g, w, what in zip(got, want, ("pair_of_slot", "dropped")):
                if not torch.equal(g, w):
                    raise AssertionError(f"moe_dispatch t={t}: the kernel's {what} differs "
                                         f"from the {name}'s")
        tok = got[0] // k

        def new():
            pair_of_slot = MD.dispatch(eid, e, cap)[0]
            xz = torch.cat([xt, torch.zeros((1, d), dtype=xt.dtype, device=xt.device)])
            return xz[pair_of_slot // k]

        def old():
            return _scatter_dispatch(torch, xt, eid, e, k, cap)

        if not torch.equal(new(), old()):
            raise AssertionError(f"moe_dispatch t={t}: the gathered rows differ from the "
                                 f"scatter's")
        xz = torch.cat([xt, torch.zeros((1, d), dtype=xt.dtype, device=xt.device)])
        ms = timer(lambda: MD.dispatch(eid, e, cap))
        plain_ms = timer(lambda: MD.dispatch_plain(eid, e, cap, (0, e)))
        sort_ms = timer(lambda: _sorted_positions(torch, eid, e, cap))
        gather_ms = timer(lambda: xz[tok])
        whole_ms, before_ms = timer.turns(new, old)
        positions_bytes = 8 * (n + e * cap)
        whole_bytes = 8 * n + t * d * 2 + e * cap * d * 2
        bound_ms = positions_bytes / HBM_BYTES_PER_S * 1e3
        rows.append({"unit": f"moe_dispatch/t{t}_k{k}_e{e}_cap{cap}", "pairs": n,
                     "dropped": int(got[1]), "ms": ms, "plain_ms": plain_ms, "sort_ms": sort_ms,
                     "bound_ms": bound_ms, "t_bytes_ms": bound_ms, "t_ops_ms": 0.0,
                     "bound_by": "bytes", "library_ms": None, "max_abs_err": 0.0,
                     "gather_ms": gather_ms, "whole_ms": whole_ms, "before_ms": before_ms,
                     "whole_bound_ms": whole_bytes / HBM_BYTES_PER_S * 1e3})
    return {"rows": rows, "launches": MD.launches}


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
                    help="depth of llama3-8b, qwen3-moe-30b-a3b and phase 12's models "
                         "(default: each model's full depth; internvl2-26b runs at most 4)")
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
    from repro_torch.kernels import moe_dispatch

    for name, mod in {**_kernel_modules(), "moe_dispatch": moe_dispatch}.items():
        mod.load_library()
        info = _build.BUILD_INFO[name]
        print(f"build {name}: {info['path']} (cached={info['cached']})", flush=True)
        for line in str(info.get("ptxas", "")).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build: {len(_build.SOURCES)} kernels in {time.perf_counter() - t0:.2f} s", flush=True)

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
    from bench import harness
    from bench.reference import granite_hybrid_lm

    wv = {}
    cases = []
    for name, max_len, layers in ((WAVE_MOE, WAVE_MOE_MAX_LEN, args.layers),
                                  (WAVE_VLM, WAVE_VLM_MAX_LEN,
                                   min(WAVE_VLM_LAYERS, args.layers or WAVE_VLM_LAYERS))):
        wcfg = api.configs.get(name)
        cases.append((dataclasses.replace(wcfg, n_layers=layers or wcfg.n_layers), max_len, None))
    arch = json.loads((ROOT / "bench" / "configs" / f"{GRANITE}.json").read_text())
    arch.update(n_layers=len(GRANITE_LAYERS), layer_types=list(GRANITE_LAYERS))
    cases.append((harness.arch_config(arch), GRANITE_MAX_LEN, (granite_hybrid_lm, arch)))
    for wcfg, max_len, reference in cases:
        name = wcfg.name
        t0 = time.perf_counter()
        wv[name] = w = wave(torch, api, K, wcfg, max_len, args.new_tokens, reference)
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

    # phase 19: the MoE dispatch's positions kernel and the gather
    t0 = time.perf_counter()
    mdp = moe_dispatch_phase(torch, timer)
    print(f"moe dispatch: phase 19 in {time.perf_counter() - t0:.1f} s; kernel equal to its "
          f"plain version and the sort, the gathered rows to the scatter's; launches {mdp['launches']}; "
          f"card {card}", flush=True)
    for r in mdp["rows"]:
        print("  unit " + json.dumps(r), flush=True)

    # phase 12: the hybrid, ssm and audio families through the wave
    # engine at full width and depth
    fam = {}
    for name in FAMILIES:
        fcfg = api.configs.get(name)
        fcfg = dataclasses.replace(fcfg, n_layers=args.layers or fcfg.n_layers)
        t0 = time.perf_counter()
        fam[name] = w = wave(torch, api, K, fcfg, FAMILY_MAX_LEN, args.new_tokens)
        print(f"families: {name} {fcfg.n_layers} layers, d_model {fcfg.d_model}, WaveEngine "
              f"{WAVE_SLOTS} slots, prompts {PROMPT_LENS}, {args.new_tokens} new tokens, oplib "
              f"{' against '.join(w['backends'])}, in {time.perf_counter() - t0:.1f} s; "
              f"card {card}: "
              + json.dumps({k: v for k, v in w.items() if not k.endswith("decode_step_ms")}),
              flush=True)
        for b in w["backends"]:
            print(f"families: {name} [{b}] prefill {w[f'{b}_prefill_ms']:.3f} ms, decode step "
                  f"median {w[f'{b}_decode_step_ms_median']:.3f} ms, "
                  f"{w[f'{b}_tok_per_s']:.2f} tokens/s, peak "
                  f"{w[f'{b}_max_memory_allocated_gb']:.2f} GB, host clock with "
                  f"torch.cuda.synchronize(); steps {json.dumps(w[f'{b}_decode_step_ms'])}"
                  + (f"; launches {w['launches_per_call']} a call, by call "
                     f"{json.dumps(w['launches_by_call'])}, {w['launches']} in all"
                     if b == "cuda" else "")
                  + (f"; oplib torch only, cuda refused: {w['c9']}" if "c9" in w else "")
                  + f"; card {card}", flush=True)

    # phase 13: training on the card, on oplib's torch backend: it must
    # launch none of the kernels, which have no backward (ROADMAP C11)
    mods = _kernel_modules()
    _zero_counts(*mods.values())
    t0 = time.perf_counter()
    train(torch, api, card, args.layers)
    train_launches = {name: mod.launches for name, mod in mods.items()}
    if any(train_launches.values()):
        raise AssertionError(f"phase 13 launched kernels: {train_launches}")
    print(f"train: phase 13 in {time.perf_counter() - t0:.1f} s launched none of the six "
          f"kernels ({json.dumps(train_launches)}; stripe_matmul rides on contraction): "
          f"the train step differentiates through oplib's torch backend, since the "
          f"hand-written kernels have no backward (ROADMAP C11), as the reference's Pallas "
          f"kernels have none", flush=True)

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

    # phase 14: the multi-device compile path and the collective library,
    # MESH_RANKS ranks emulated on the one card
    t0 = time.perf_counter()
    mesh = mesh_cases(torch, api, timer, args.reps)
    print(f"mesh: {len(mesh['rows'])} programs through api.jit(..., 'cuda', mesh=Mesh(['cuda:0'] "
          f"* {MESH_RANKS})), each held against its single-device compile within "
          f"{MESH_RTOL}*(1+max|single|); launches {json.dumps(mesh['launches'])}; times of "
          f"{MESH_RANKS} ranks on one card are the emulation's (one stream, the ranks' host "
          f"threads), not an interconnect's; card {card}", flush=True)
    for r in mesh["rows"]:
        print("  mesh " + json.dumps(r), flush=True)
    lib = collective_library(torch, api, timer)
    for name, r in lib.items():
        print(f"  collective {name}: " + json.dumps(r), flush=True)
    print(f"mesh: stripe_jit(mesh=8) on {torch.cuda.device_count()} card(s) raised: "
          f"{mesh_without_cards(api)}", flush=True)
    print(f"mesh: phase 14 in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 15: the LM family's sharded step (what the JAX package leaves
    # to GSPMD), ranks emulated on the one card
    t0 = time.perf_counter()
    shard = sharded_phase(torch, api, K, card, args.layers)
    print(f"sharded: phase 15 in {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(shard['launches'])}; the times of {SHARD_MESH[0] * SHARD_MESH[1]} or "
          f"{SHARD_SERVE_MESH[1]} ranks on one card are the emulation's (one stream, the "
          f"ranks' host threads), not NVLink's; card {card}", flush=True)

    # phase 16: the hybrid, ssm and audio families' sharded step
    t0 = time.perf_counter()
    fam_shard = family_phase(torch, api, K, card, args.layers)
    print(f"sharded families: phase 16 in {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(fam_shard['launches'])}; ranks on one card, as phase 15; card {card}",
          flush=True)

    # phase 17: the dry run on a mesh of meta devices, its prediction
    # against the card, the roofline, and the example twins
    t0 = time.perf_counter()
    dry = dryrun_phase(torch, api, card)
    print(f"dryrun: phase 17 in {time.perf_counter() - t0:.1f} s (cells "
          f"{dry['cells_s']:.1f} s, against the card {dry['card']['wall_s']:.1f} s, examples "
          f"{dry['examples_s']:.1f} s); launches {json.dumps(dry['launches'])}; card {card}",
          flush=True)

    # phase 18: the multi-pod mesh ('pod', 'data', 'model'), ranks on the
    # one card
    t0 = time.perf_counter()
    pod = pod_phase(torch, api, K, card, args.layers, dry["rows"])
    print(f"multi-pod: phase 18 in {time.perf_counter() - t0:.1f} s (cells "
          f"{pod['cells_s']:.1f} s); launches {json.dumps(pod['launches'])}; ranks on one card, "
          f"as phase 15; card {card}", flush=True)

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
        + sum(w["launches"] for w in (*wv.values(), *fam.values()))
        + tn["launches"]["contraction"] + mesh["launches"]["contraction"]["launches"]
        + shard["launches"]["contraction"] + fam_shard["launches"]["contraction"]
        + dry["launches"].get("contraction", 0) + pod["launches"]["contraction"], decode,
        max([r["max_abs_err"] for r in rows]
            + [r["max_abs_err"] for r in new_rows if r["kernel"] == ["contraction"]]
            + [mm_err, md["max_abs_err"]]
            + [w["max_abs_err"] for w in (*wv.values(), *fam.values()) if "max_abs_err" in w]))
    contraction["general_ms"] = sum(r["general_ms"] for r in decode)
    contraction["launches_by_path"] = {"serve": runs["cuda"][2]["launches_by_path"],
                                       "sweep": sw["launches_by_path"],
                                       "model": md["launches_by_call"],
                                       "wave": {n: w["launches_by_call"] for n, w in wv.items()},
                                       "families": {n: w["launches_by_call"]
                                                    for n, w in fam.items()
                                                    if "launches_by_call" in w},
                                       "tune": tn["launches_by_path"],
                                       "mesh": mesh["launches"]["contraction"]["by_path"],
                                       "sharded": {f"{r['mesh'][0]}x{r['mesh'][1]}": {
                                           "by_path": r["contraction_by_path"],
                                           "by_rank": r["launches_by_rank"]}
                                           for r in shard["serve"]},
                                       "sharded_families": {
                                           f"{r['config']} {r['mesh'][0]}x{r['mesh'][1]}": {
                                               "by_path": r["contraction_by_path"],
                                               "by_rank": r["launches_by_rank"]}
                                           for r in fam_shard["serve"]
                                           if r["backend"] == "cuda"},
                                       "examples": {r["example"]: r["launches"][
                                           "contraction_by_path"] for r in dry["examples"]},
                                       "multi_pod": {"x".join(map(str, r["mesh"])): {
                                           "by_path": r["contraction_by_path"],
                                           "by_rank": r["launches_by_rank"]}
                                           for r in pod["serve"]}}
    windowed = _kernel_entry(
        "windowed", "src/repro_torch/csrc/windowed.cu", "src/repro/core/lower_pallas.py:812",
        sw["launches"]["windowed"] + rn["launches"] + tn["launches"]["windowed"]
        + mesh["launches"]["windowed"]["launches"] + shard["launches"]["windowed"]
        + fam_shard["launches"]["windowed"] + dry["launches"].get("windowed", 0)
        + pod["launches"]["windowed"], conv,
        max(r["max_abs_err"] for r in new_rows if r["kernel"] == ["windowed"]))
    windowed["general_ms"] = sum(r["general_ms"] for r in conv)
    windowed["launches_by_path"] = {"sweep": sw["windowed_launches_by_path"],
                                    "resnet": rn["launches_by_path"],
                                    "tune": tn["windowed_launches_by_path"],
                                    "mesh": mesh["launches"]["windowed"]["by_path"],
                                    "examples": {r["example"]: r["launches"]["windowed"]
                                                 for r in dry["examples"]}}
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
                                sw["launches"]["elementwise"] + tn["launches"]["elementwise"]
                                + mesh["launches"]["elementwise"]["launches"]
                                + shard["launches"]["elementwise"]
                                + fam_shard["launches"]["elementwise"]
                                + dry["launches"].get("elementwise", 0)
                                + pod["launches"]["elementwise"],
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
        "mesh": mesh["launches"]["elementwise"]["by_path"],
        "phase4": {p: phase4.count(p) for p in ("vec", "general")}}
    elementwise["empty_kernel_ms"] = empty_ms
    # the MoE dispatch's positions: replaces no TPU kernel; its launches
    # the wave's (the model's own path), its times the positions' at phase
    # 19's two shapes against the plain version's, the whole dispatch's
    # (the kernel and the gather) beside the one before it
    moe_wave = wv[WAVE_MOE]["dispatch_launches"]
    granite = wv[GRANITE]["dispatch_launches"]
    dispatch = _kernel_entry("moe_dispatch", "src/repro_torch/csrc/moe_dispatch.cu",
                             "none (the JAX package's dispatch is jnp.cumsum: "
                             "src/repro/nn/moe.py::moe_apply)", moe_wave + granite, mdp["rows"],
                             0.0)
    dispatch["launches_by_path"] = {"wave": moe_wave, "wave_granite": granite}
    dispatch["launches_phase19"] = mdp["launches"]
    for key in ("sort_ms", "gather_ms", "whole_ms", "whole_bound_ms", "before_ms"):
        dispatch[key] = sum(r[key] for r in mdp["rows"])
    summary = {"kernels": [
        contraction,
        elementwise,
        windowed,
        flash,
        gla,
        matmul_entry,
        dispatch,
    ]}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
