"""The cell of granite-4.0-h-small (a layered hybrid: Mamba2 and
attention mixers, a MoE with a shared expert in every layer), at tiny
sizes on the CPU: the plain reference against the port, its chunked
state-space scan against the recurrence token by token, a whole run of
the cell, the float8 control and three faults under the cell's own
limits."""
import numpy as np
import pytest
import torch

import bench_tiny
from bench import harness, spec, weights
from bench.reference import granite_hybrid_lm

GRANITE = "granite-4.0-h-small.extract"
CELLS = (GRANITE,)


def overrides(cell: str):
    """Tiny sizes of the cell: 4 layers (mamba, attention, mamba, mamba),
    8 experts top-2 and a shared expert, float32 (bf16's router near-ties
    would flip experts at these widths)."""
    ov = bench_tiny.overrides(cell)
    arch = dict(ov["config"], head_dim=32, layer_types=["mamba", "attention", "mamba", "mamba"],
                n_layers=4, dtype="float32",
                ssm=dict(spec.resolve(cell).config["ssm"], d_state=16, head_dim=16,
                         n_ssm_heads=16),
                moe=dict(ov["config"]["moe"], d_ff_shared=96))
    return {"config": arch, "traffic": ov["traffic"]}


def _model(arch):
    from repro_torch import api

    return api.build_model(harness.arch_config(arch))


def test_reference_follows_the_port_through_prefill_and_decode():
    """Prefill of 300 tokens (past one chunk of the scan, by a ragged
    part) and two decode steps of the port, float32 on ``oplib``'s
    ``torch`` backend, against one forward of the reference with the
    same calls' groups, on the benchmark's seeded weights."""
    from repro_torch.core import oplib

    arch = overrides(GRANITE)["config"]
    model = _model(arch)
    w = weights.make(model, 11, "cpu")
    rng = np.random.default_rng(0)
    b, t = 3, 300
    toks = torch.from_numpy(rng.integers(0, arch["vocab"], (b, t)))
    old = oplib.get_backend()
    oplib.set_backend("torch")
    try:
        with torch.no_grad():
            logits, cache = model.prefill(w, {"tokens": toks.int()},
                                          model.init_cache(b, t + 2, device="cpu"))
            fed, want = [], [logits[:, -1, : arch["vocab"]]]
            for _ in range(2):
                fed.append(want[-1].argmax(-1))
                logits, cache = model.decode_step(w, cache, fed[-1][:, None].int())
                want.append(logits[:, -1, : arch["vocab"]])
    finally:
        oplib.set_backend(old)
    full = torch.cat([toks] + [f[:, None] for f in fed], 1)
    at = torch.tensor([[i, t - 1 + j] for j in range(3) for i in range(b)])
    got = granite_hybrid_lm.logits_at(w, arch, full, at,
                                      groups=[(0, t), (t, t + 1), (t + 1, t + 2)])
    want = torch.cat(want)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_the_chunked_scan_equals_the_recurrence():
    """The reference's dual form, in blocks that do not divide the
    sequence, against ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``,
    ``y_t = h_t C_t`` taken a token at a time, in float64."""
    g = torch.Generator().manual_seed(5)
    b, t, h, p, n = 2, 37, 3, 4, 5
    x = torch.randn(b, t, h, p, generator=g, dtype=torch.float64)
    dt = torch.rand(b, t, h, generator=g, dtype=torch.float64)
    A = -torch.rand(h, generator=g, dtype=torch.float64) * 2
    Bm = torch.randn(b, t, n, generator=g, dtype=torch.float64)
    Cm = torch.randn(b, t, n, generator=g, dtype=torch.float64)
    state = torch.zeros(b, h, p, n, dtype=torch.float64)
    want = []
    for i in range(t):
        decay = torch.exp(dt[:, i] * A)[..., None, None]
        state = decay * state + dt[:, i, :, None, None] * x[:, i, :, :, None] * Bm[:, i, None, None]
        want.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, i]))
    want = torch.stack(want, 1)
    for block in (1, 8, 37, 64):
        got = granite_hybrid_lm.ssd(x, dt, A, Bm, Cm, block=block).double()
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), block


@pytest.mark.parametrize("cell", CELLS)
def test_a_whole_run_reads_correct(cell):
    r = harness.run_cell(cell, 2**31 + 99, 2.0, False, device="cpu", overrides=overrides(cell))
    assert r["correct"], r["checks"]
    assert r["checks"]["tokens_checked"]["value"] >= 10
    assert set(r["metrics"]) == {m["name"] for m in spec.resolve(cell).end_to_end}


def _published_depth(cell: str):
    """The cell's tiny sizes at the configuration's own depth and layer
    pattern (40 layers, attention at 5, 15, 25 and 35)."""
    ov = overrides(cell)
    arch = spec.resolve(cell).config
    ov["config"] = dict(ov["config"], n_layers=arch["n_layers"], layer_types=arch["layer_types"])
    return ov


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_not_correct(cell):
    """The float8 control fails the cell's own limits where the program
    passes them, on every seed.  Both numbers compare logits relative to
    their own norm, so the LM head's width does not move them; the
    control's error grows with depth, as at full size, so granite runs
    its published 40 layers here (at 4 its control reads 0.09-0.12,
    under the limit that 40 layers set)."""
    for seed in (1, 2, 3):
        r = harness.run_cell(cell, seed, 1.0, False, device="cpu",
                             overrides=_published_depth(cell), control=True)
        c = r["checks"]
        assert r["correct"], c
        assert not r["control_correct"], c


def _token_altered(monkeypatch, mod):
    real = mod._logits
    # the least likely token comes first where the logits are produced
    monkeypatch.setattr(mod, "_logits", lambda *a, **kw: -real(*a, **kw))


def _half_rows_altered(monkeypatch, mod):
    real = mod._logits

    def half(*a, **kw):
        # in every batched call, the second half of the rows is served the
        # least likely token
        out = real(*a, **kw)
        return torch.cat([out[: out.shape[0] // 2], -out[out.shape[0] // 2:]])
    monkeypatch.setattr(mod, "_logits", half)


def _state_unchanged(monkeypatch, mod):
    """A decode step that hands back the Mamba2 states (conv window and
    SSD state) as it found them."""
    real = mod.decode_step

    def decode_step(p, cfg, cache, tokens, *rest):
        keep = {k: v.clone() for k, v in cache["mamba"].items()}
        logits, new = real(p, cfg, cache, tokens, *rest)
        return logits, dict(new, mamba=keep)
    monkeypatch.setattr(mod, "decode_step", decode_step)


FAULTS = {"token_altered": _token_altered, "half_rows_altered": _half_rows_altered,
          "state_unchanged": _state_unchanged}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_timed_path_reads_not_correct(cell, fault, monkeypatch):
    from repro_torch.models import layered

    ov = overrides(cell)
    sound = harness.run_cell(cell, 21, 1.0, False, device="cpu", overrides=ov)
    assert sound["correct"], sound["checks"]
    FAULTS[fault](monkeypatch, layered)
    with torch.no_grad():
        broken = harness.run_cell(cell, 21, 1.0, False, device="cpu", overrides=ov)
    over = [n for n, c in broken["checks"].items()
            if n != "tokens_checked" and c["value"] > c["limit"]]
    assert not broken["correct"] and over, broken["checks"]
