"""The readers of the program's spans inside the wave engine, the MoE
dispatch and the block programs, at tiny sizes on the CPU: each cell run
once with ``trace``, the readers against what the driver saw, and the
served tokens and the check's reading the same with tracing on and off."""
import dataclasses
import types

import numpy as np
import pytest

import bench_tiny
from bench import check, harness, spec, traffic, weights
from bench.served import one_sequence

SEED = 2**31 + 77
NEW = ("moe.dispatch_ms_per_ktok", "moe.drop_pct", "wave.waste_pct",
       "engine.cast_ms_per_step", "engine.decode_launch_pct")


def _read(name, ctx):
    return spec.metric_reader(name).read(ctx)


@pytest.fixture(scope="module")
def runs():
    """Each cell's traced run: its result line and the readers' context."""
    out = {}
    real = harness.Context
    for cell in ("qwen3-moe-30b-a3b.docs", "chatglm3-6b.chat"):
        seen = []

        @dataclasses.dataclass
        class Context(real):
            def __post_init__(self):
                seen.append(self)

        harness.Context = Context
        try:
            r = harness.run_cell(cell, SEED, 2.0, True, device="cpu",
                                 overrides=bench_tiny.overrides(cell))
        finally:
            harness.Context = real
        out[cell] = r, seen[0]
    return out


def test_waste_is_the_padding_and_the_dead_rows(runs):
    r, ctx = runs["qwen3-moe-30b-a3b.docs"]
    assert r["correct"], r["checks"]
    assert ctx.waves
    slots = ctx.mix["slots"]
    rows = waste = 0
    for w in ctx.waves:
        rows += slots * w.width
        waste += slots * w.width - sum(s.plen for s in w.members)
        # decode call j serves the rows whose request has a token after j + 1
        for j in range(len(w.decode_inputs)):
            rows += slots
            waste += slots - sum(len(s.tokens) - 1 > j for s in w.members)
    want = 100.0 * waste / rows
    assert r["metrics"]["wave.waste_pct"]["value"] == pytest.approx(want, rel=1e-12)
    assert 0 < want < 100


def test_moe_readers_on_the_cpu(runs):
    r, ctx = runs["qwen3-moe-30b-a3b.docs"]
    spans = [s for s in ctx.spans if s.name == "moe.dispatch"]
    calls = sum(1 + len(w.decode_inputs) for w in ctx.waves)
    assert len(spans) == calls * ctx.arch["n_layers"]
    drop = r["metrics"]["moe.drop_pct"]["value"]
    assert 0 <= drop <= 100
    assert drop == pytest.approx(100.0 * sum(s.attrs["dropped"] for s in spans)
                                 / sum(s.attrs["pairs"] for s in spans))
    # the device's clock exists only on the card
    assert _read("moe.dispatch_ms_per_ktok", ctx) is None
    assert "moe.dispatch_ms_per_ktok" not in r["metrics"]


def test_engine_readers_on_the_cpu(runs):
    r, ctx = runs["chatglm3-6b.chat"]
    assert r["correct"], r["checks"]
    pct = r["metrics"]["engine.decode_launch_pct"]["value"]
    assert 0 < pct <= 100
    # every decode step holds its launch, and the block programs' casts
    steps = [s for s in ctx.spans if s.name == "serve.decode_step"]
    launches = [s for s in ctx.spans if s.name == "serve.decode_launch"]
    assert len(launches) == len(steps) > 0
    assert any(s.name == "block.cast" and s.parent == "serve.decode_launch" for s in ctx.spans)
    assert _read("engine.cast_ms_per_step", ctx) is None
    assert "engine.cast_ms_per_step" not in r["metrics"]


def test_readers_read_nothing_without_the_spans():
    """A program without these spans (the parent of this change) leaves
    every new metric out; its span records have no ``device_dur``."""
    step = types.SimpleNamespace(name="serve.decode_step", ts=1.0, dur=0.1, tid=1,
                                 attrs={"step": 0, "n_live": 4})
    ctx = harness.Context({}, {"slots": 4}, ({}, {}), [step], [], [], None)
    assert [_read(n, ctx) for n in NEW] == [None] * len(NEW)


def _serve(cell, traced, steps):
    """The cell's driver at tiny size for ``steps`` loop steps after its
    start, the program's tracing on or off: its finished requests by
    index, and the weights and configuration."""
    from repro_torch import api
    from repro_torch.obs import trace as obs_trace

    ov = bench_tiny.overrides(cell)
    arch, mix = ov["config"], ov["traffic"]
    model = api.build_model(harness.arch_config(arch))
    params = weights.make(model, SEED, "cpu")
    drv = spec.driver(mix["engine"]).Driver(api, model, params, arch, mix,
                                            traffic.requests(mix, arch["vocab"], SEED), "cpu",
                                            traced)
    if hasattr(drv, "warm"):
        drv.warm(api)
    if traced:
        obs_trace.clear()
        obs_trace.enable()
    try:
        drv.start()
        for _ in range(steps):
            drv.step()
    finally:
        obs_trace.disable()
    done = {s.index: s for s in drv.requests() if s.finish and s.status == "ok"}
    waves = (drv.jobs(np.random.default_rng(0), 10**9, 0.0, float("inf"))
             if mix["engine"] == "wave" else None)
    drv.close()
    return done, waves, params, arch


@pytest.mark.parametrize("cell,steps", [("chatglm3-6b.chat", 16), ("qwen3-moe-30b-a3b.docs", 3)])
def test_tracing_changes_no_served_token(cell, steps):
    """The casts hoisted into their spans, the dispatch's count and the
    device events change no arithmetic: the same requests serve the same
    tokens, and the check reads the same numbers.  (The continuous
    engine's admissions follow its prep thread, so the two runs may
    finish different requests: the requests both finished are compared;
    the wave engine's waves are fixed, and whole waves are compared.)"""
    off_done, off_waves, params, arch = _serve(cell, False, steps)
    on_done, on_waves, _, _ = _serve(cell, True, steps)
    both = sorted(set(off_done) & set(on_done))
    assert len(both) >= 4
    assert [off_done[i].tokens for i in both] == [on_done[i].tokens for i in both]
    ref = spec.reference(arch["reference"])
    if off_waves is None:
        readings = [check.read(ref, params, arch, [one_sequence(d[i]) for i in both], "cpu")
                    for d in (off_done, on_done)]
    else:
        assert sorted(off_done) == sorted(on_done)
        for a, b in zip(off_waves, on_waves):
            assert np.array_equal(a.tokens, b.tokens) and a.logits.equal(b.logits)
        readings = [check.read(ref, params, arch, w, "cpu", over=0.12)
                    for w in (off_waves, on_waves)]
    assert readings[0]["tokens_checked"] > 0
    assert readings[0] == pytest.approx(readings[1], rel=0, abs=0, nan_ok=True)
