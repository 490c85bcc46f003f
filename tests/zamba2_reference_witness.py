#!/usr/bin/env python3
"""zamba2-2.7b's bf16 forward in the JAX package and in the port, block by
block, on the CPU: how fast the reference's own blocks part under a
rounding difference, and how far the port's blocks are from the
reference's on the same inputs.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tests/zamba2_reference_witness.py

Full width (d 2560, 80 SSD heads of 64, the shared block's 32 heads and
gelu GLU of 10240), cut to 12 Mamba2 layers: 2 groups, so 14 blocks a
call (the shared block, then 6 Mamba2 layers, twice).  Seeded weights
from the reference's ``init_params`` in bf16, carried to the port with
``params_from_jax``; the wave's prefill (4 prompts of 17, 40, 64 and 100
tokens, left-padded to 100) and one decode step, 28 blocks in all.  The
reference's blocks are its own ``_shared_block`` and ``mamba2_apply``
(each under ``jax.jit``), called in ``_forward``'s order on the slices of
its stacked parameters and cache; the port's are patched through
``chip_smoke.hybrid_blocks``.  Runs, each against ``ref`` (the reference
on ``oplib``'s ``jnp`` backend):

* ``ref_split``: the reference with every projection summed in float32
  over the two halves of K, added, rounded to bf16 once, then its
  activation (the same products, another order of the sums);
* ``port``: the port's ``Model.prefill`` and ``decode_step`` on
  ``torch``;
* ``ref_prefill``: the reference's own ``prefill`` (its scans under one
  ``jax.jit``; logits only).

A free run feeds each block the previous block's output; a replayed run
feeds each block ``ref``'s input to it.  One JSON line a pair: each
block's largest difference over the largest element of ``ref``'s output
(``block_rel``, prefill then decode), the growth a block over the
prefill (``scripts/hybrid_divergence.py``'s ``growth_a_block``), and the
logits' difference.  Exits non-zero unless the reference parts from
itself by more than 1.25 times a block (free ``ref_split``), and the
port's replayed blocks stay within ``chip_smoke.LOGIT_RTOL`` of
``ref``'s.  About 4 GB and 1 minute; pytest does not collect this file
(it is no ``test_*.py``), because the tier-1 run keeps to small shapes.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

PROMPT_LENS = (17, 40, 64, 100)
SLOTS, MAX_LEN, LAYERS, SEED = 4, 128, 12, 0


def _split_linear(jnp, act_fns):
    """The reference's ``jnp`` projection with the sums in another order:
    K in two halves, each summed in float32, added, rounded once, then
    the activation."""
    def linear(x, w, bias=None, act=None):
        assert bias is None, "the hybrid's projections have no bias"
        h = w.shape[0] // 2
        out = (jnp.einsum("...k,kn->...n", x[..., :h], w[:h], preferred_element_type=jnp.float32)
               + jnp.einsum("...k,kn->...n", x[..., h:], w[h:],
                            preferred_element_type=jnp.float32)).astype(x.dtype)
        return act_fns[act](out) if act else out
    return linear


def _reference_blocks(jax, cfg, params, tokens, step, feed=None):
    """The reference's prefill of ``tokens`` and decode of ``step``, one
    block at a time, in ``_forward``'s order: returns every block's
    ``(input, output)`` and the two calls' logits.  With ``feed`` (a list
    of pairs) each block takes ``feed[i][0]`` as its input."""
    from repro.models import hybrid
    from repro.nn import ssm
    from repro.nn.core import embed_lookup

    tree = jax.tree.map
    shared = jax.jit(lambda p, x, c: hybrid._shared_block(p, x, cfg, c))
    mamba = jax.jit(lambda p, x, st: ssm.mamba2_apply(p, x, cfg, state=st))
    groups, per_group = hybrid._n_groups(cfg), cfg.hybrid.shared_attn_every
    cache = hybrid.init_cache(cfg, SLOTS, MAX_LEN, params["embed"].dtype)
    pairs, logits = [], []

    def block(fn, p, x, c):
        if feed is not None:
            x = feed[len(pairs)][0]
        out, new = fn(p, x, c)
        pairs.append((x, out))
        return out, new

    for toks in (tokens, step):
        x = embed_lookup(params["embed"], toks)
        attn, states = [], []
        for g in range(groups):
            x, c = block(shared, params["shared"], x, tree(lambda a: a[g], cache["attn"]))
            attn.append(c)
            for j in range(per_group):
                x, st = block(mamba, tree(lambda a: a[g, j], params["mamba"]), x,
                              tree(lambda a: a[g, j], cache["mamba"]))
                states.append(st)
        stack = lambda *a: jax.numpy.stack(a)  # noqa: E731
        cache = {"attn": tree(stack, *attn),
                 "mamba": tree(lambda *a: stack(*a).reshape(groups, per_group, *a[0].shape),
                               *states)}
        logits.append(hybrid._logits(params, cfg, x[:, -1:]))
    return pairs, logits


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke
    from hybrid_divergence import growth_a_block
    from repro import configs as j_configs
    from repro.core import oplib as j_oplib
    from repro.models import hybrid as j_hybrid
    from repro.nn import attention as j_attention
    from repro.nn import core as j_core
    from repro.nn import ssm as j_ssm
    from repro_torch import api
    from repro_torch.convert import params_from_jax
    from repro_torch.core import oplib

    jcfg = dataclasses.replace(j_configs.get("zamba2-2.7b"), n_layers=LAYERS)
    tcfg = dataclasses.replace(api.configs.get("zamba2-2.7b"), n_layers=LAYERS)
    j_oplib.set_backend("jnp")
    oplib.set_backend("torch")
    jp = j_hybrid.init_params(jcfg, jax.random.PRNGKey(SEED))
    rng = np.random.RandomState(SEED)
    toks = np.zeros((SLOTS, max(PROMPT_LENS)), np.int32)
    for i, n in enumerate(PROMPT_LENS):
        toks[i, -n:] = rng.randint(1, jcfg.vocab, size=n)
    step = rng.randint(1, jcfg.vocab, size=(SLOTS, 1)).astype(np.int32)

    def f32(a):
        return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)

    def rel(a, b) -> float:
        a, b = f32(a), f32(b)
        return float(np.abs(a - b).max() / np.abs(b).max())

    ref, ref_logits = _reference_blocks(jax, jcfg, jp, toks, step)
    saved = [(m, m.linear) for m in (j_core, j_attention, j_ssm)]
    split = _split_linear(jnp, j_core._ACT)
    for m, _ in saved:
        m.linear = split
    try:
        runs = {"ref_split": _reference_blocks(jax, jcfg, jp, toks, step),
                "ref_split_replay": _reference_blocks(jax, jcfg, jp, toks, step, feed=ref)}
    finally:
        for m, fn in saved:
            m.linear = fn
    whole = jax.jit(lambda p, b, c: j_hybrid.prefill(p, jcfg, b, c))(
        jp, {"tokens": jnp.asarray(toks)},
        j_hybrid.init_cache(jcfg, SLOTS, MAX_LEN, jp["embed"].dtype))[0]

    model = api.build_model(tcfg)
    tp = params_from_jax(jp, "cpu")
    del jp
    batch, tstep = {"tokens": torch.from_numpy(toks)}, torch.from_numpy(step)

    def port(kept, hold=None):
        with chip_smoke.hybrid_blocks(kept, hold), torch.no_grad():
            logits, cache = model.prefill(tp, batch, model.init_cache(SLOTS, MAX_LEN, device="cpu"))
            return [logits, model.decode_step(tp, cache, tstep)[0]]

    kept, outs = [], []
    runs["port"] = (kept, port(kept))
    feed = [(params_from_jax(x, "cpu"), params_from_jax(y, "cpu")) for x, y in ref]
    logits = port(feed, lambda out, want: outs.append(out))
    runs["port_replay"] = ([(None, out) for out in outs], logits)

    blocks = len(ref) // 2
    report = {}
    for name, (pairs, logits) in runs.items():
        per_block = [rel(out, want) for (_, out), (_, want) in zip(pairs, ref)]
        report[name] = row = {
            "pair": f"{name} against ref", "model": jcfg.name, "layers": LAYERS,
            "blocks_a_call": blocks, "growth_a_block": growth_a_block(per_block[:blocks]),
            "max_block_rel": max(per_block),
            "logits_rel": [rel(a, b) for a, b in zip(logits, ref_logits)],
            "block_rel": per_block}
        print(json.dumps(row), flush=True)
    print(json.dumps({"pair": "ref_prefill against ref", "model": jcfg.name, "layers": LAYERS,
                      "logits_rel": [rel(whole, ref_logits[0])]}), flush=True)
    growth = report["ref_split"]["growth_a_block"]
    if growth is None or growth <= 1.25:
        sys.exit(f"zamba2_reference_witness: ref_split grows {growth} a block, not over 1.25")
    worst = report["port_replay"]["max_block_rel"]
    if not worst <= chip_smoke.LOGIT_RTOL:
        sys.exit(f"zamba2_reference_witness: a replayed port block differs by {worst:.3e} "
                 f"(tolerance {chip_smoke.LOGIT_RTOL})")


if __name__ == "__main__":
    main()
