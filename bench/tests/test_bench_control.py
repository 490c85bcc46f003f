"""The check's control and its faults, at tiny sizes on the CPU.

The control, the plain reference computed through float8 products, put
in the program's place, reads not correct under the cells' own limits.
And a run with its timed path broken underneath (the card's look
skipped, the rest of the run as it is) comes out not correct under the
cell's own limit, for each fault a serving cell can have: a token
altered where it is produced, half of a batch's rows served wrong, and a
decode step that returns its state (the KV cache) unchanged."""
import math

import pytest
import torch

import bench_tiny
from bench import harness, spec, weights


@pytest.fixture
def full_width_logits(monkeypatch):
    """The tiny model's LM head widened by sqrt(full width / tiny width),
    so that its logits spread as the full model's do (a logit is the
    LM head's column against the normed state, whose norm grows as the
    square root of the width)."""
    def widen(cell):
        scale = math.sqrt(spec.resolve(cell).config["d_model"]
                          / bench_tiny.overrides(cell)["config"]["d_model"])
        real = weights.make

        def make(model, seed, device):
            p = real(model, seed, device)
            p["unembed"].mul_(scale)
            return p
        monkeypatch.setattr(weights, "make", make)
    return widen


@pytest.mark.parametrize("cell", bench_tiny.CELLS)
def test_the_control_reads_wider_gaps_than_the_program(cell, full_width_logits):
    """With logits as wide as the full model's, the control fails the
    cell's own limits (``control_correct`` false) where the program
    passes them, on every seed."""
    full_width_logits(cell)
    for seed in (1, 2, 3):
        r = harness.run_cell(cell, seed, 4.0, False, device="cpu",
                             overrides=bench_tiny.overrides(cell), control=True)
        c = r["checks"]
        assert r["correct"], c
        assert c["tokens_checked"]["value"] >= bench_tiny.overrides(cell)["traffic"]["check_tokens"]
        assert not r["control_correct"], c
        for name in spec.resolve(cell).limits:
            assert c[f"control.{name}"]["value"] > max(3 * c[name]["value"], 1e-4), c


def _token_altered(monkeypatch):
    from repro_torch.models import lm

    real = lm._logits
    # the least likely token comes first where the logits are produced
    monkeypatch.setattr(lm, "_logits", lambda *a, **kw: -real(*a, **kw))


def _half_rows_altered(monkeypatch):
    from repro_torch.models import lm

    real = lm._logits

    def half(*a, **kw):
        # in every batched call, the second half of the rows is served
        # the least likely token
        out = real(*a, **kw)
        if out.shape[0] > 1:
            out = torch.cat([out[: out.shape[0] // 2], -out[out.shape[0] // 2:]])
        return out
    monkeypatch.setattr(lm, "_logits", half)


def _state_unchanged(monkeypatch):
    from repro_torch.models import lm
    from repro_torch.serving import engine

    real_make = engine.make_decode_step

    def make(*a, **kw):
        step = real_make(*a, **kw)

        def unchanged(params, pages_k, pages_v, *rest):
            keep_k, keep_v = pages_k.clone(), pages_v.clone()
            nxt, pk, pv = step(params, pages_k, pages_v, *rest)
            return nxt, pk.copy_(keep_k), pv.copy_(keep_v)
        return unchanged

    real_decode = lm.decode_step

    def decode_step(p, cfg, cache, tokens, dist=None):
        keep = {k: v.clone() for k, v in cache.items()}
        logits, _ = real_decode(p, cfg, cache, tokens, dist)
        return logits, keep

    monkeypatch.setattr(engine, "make_decode_step", make)
    monkeypatch.setattr(lm, "decode_step", decode_step)


FAULTS = {"token_altered": _token_altered, "half_rows_altered": _half_rows_altered,
          "state_unchanged": _state_unchanged}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", bench_tiny.CELLS)
def test_a_fault_in_the_timed_path_reads_not_correct(cell, fault, monkeypatch):
    ov = bench_tiny.overrides(cell)
    sound = harness.run_cell(cell, 21, 1.0, False, device="cpu", overrides=ov)
    assert sound["correct"], sound["checks"]
    FAULTS[fault](monkeypatch)
    with torch.no_grad():
        broken = harness.run_cell(cell, 21, 1.0, False, device="cpu", overrides=ov)
    over = [n for n, c in broken["checks"].items()
            if n != "tokens_checked" and c["value"] > c["limit"]]
    assert not broken["correct"] and over, broken["checks"]
    if fault == "half_rows_altered" and "docs" in cell:
        # the stages' low quantile reads the sound half; the share of far tokens does not
        assert "error_share" in over, broken["checks"]
