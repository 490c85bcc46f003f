"""The plain references against the port at tiny sizes of each
configuration, on the CPU: the port's own forward (``Model.prefill`` and
``decode_step`` in float32 on ``oplib``'s ``torch`` backend) and every
cell's whole run (engine, driver, sample, check)."""
import numpy as np
import pytest
import torch

import bench_tiny
from bench import harness, spec, weights


def _port(cell, dtype="float32"):
    from repro_torch import api

    ov = bench_tiny.overrides(cell)
    arch = dict(ov["config"], dtype=dtype)
    return api, arch, api.build_model(harness.arch_config(arch))


@pytest.mark.parametrize("cell", ["chatglm3-6b.chat", "qwen3-moe-30b-a3b.docs"])
def test_reference_follows_the_port_through_prefill_and_decode(cell):
    from repro_torch.core import oplib

    api, arch, model = _port(cell)
    ref = spec.reference(arch["reference"])
    w = weights.make(model, 11, "cpu")
    rng = np.random.default_rng(0)
    b, t = 3, 12          # 36 tokens, 2 choices each, over 8 experts: capacity 12
    toks = torch.from_numpy(rng.integers(0, arch["vocab"], (b, t)))
    old = oplib.get_backend()
    oplib.set_backend("torch")
    try:
        with torch.no_grad():
            logits, cache = model.prefill(w, {"tokens": toks.int()}, model.init_cache(b, 16,
                                                                                   device="cpu"))
            nxt = logits[:, -1, : arch["vocab"]].argmax(-1)
            logits2, _ = model.decode_step(w, cache, nxt[:, None].int())
    finally:
        oplib.set_backend(old)
    full = torch.cat([toks, nxt[:, None]], 1)
    at = torch.tensor([[i, t - 1] for i in range(b)] + [[i, t] for i in range(b)])
    got = ref.logits_at(w, arch, full, at, groups=[(0, t), (t, t + 1)])
    want = torch.cat([logits[:, -1, : arch["vocab"]], logits2[:, -1, : arch["vocab"]]])
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * scale


@pytest.mark.parametrize("cell", bench_tiny.CELLS)
def test_a_whole_run_reads_correct(cell):
    r = harness.run_cell(cell, 2**31 + 99, 3.0, False, device="cpu",
                         overrides=bench_tiny.overrides(cell))
    assert r["correct"], r["checks"]
    assert r["checks"]["tokens_checked"]["value"] >= 10
    names = [m["name"] for m in spec.resolve(cell).end_to_end]
    assert set(r["metrics"]) == set(names)
    assert list(r)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", bench_tiny.CELLS)
def test_a_whole_run_reads_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = harness.run_cell(cell, 2**31 + 98, 1.0, True, overrides=bench_tiny.overrides(cell))
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
