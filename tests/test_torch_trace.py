"""The port's tracer (``repro_torch.obs.trace``) and the spans inside the
program, on the CPU (the device's clock on the card).

* With tracing off and no profiler, ``span(..., device=True)`` is the
  shared no-op; under ``torch.profiler`` every span is mirrored as a
  ``record_function`` of the same name, tracing on or off, nested in the
  ranges around it.
* A 0-d tensor attribute is read as a number when the spans are read;
  ``device_dur`` is ``None`` off the card, and on the card it is the
  CUDA events' time of the work inside the span.
* ``moe.dispatch`` counts the (token, choice) pairs that the capacity
  drops, as the numpy dispatch of ``tests/test_torch_moe.py`` counts
  them over the same routing, and tracing leaves the output bit for bit;
  on a mesh the ranks count the pairs of the tokens they route.
* ``wave.prefill`` and ``wave.decode_step`` carry the wave's rows, its
  padded width, its real prompt tokens and the rows still being served.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.core import oplib  # noqa: E402
from repro_torch.nn import moe  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402


@pytest.fixture
def tracer():
    """A fresh default tracer, off; the old one back after the test."""
    old = obs_trace.get_tracer()
    obs_trace.set_tracer(obs_trace.Tracer(enabled=False))
    yield obs_trace.get_tracer()
    obs_trace.set_tracer(old)


def test_span_off_is_the_shared_noop(tracer):
    assert obs_trace.span("moe.dispatch", device=True, tokens=3) is obs_trace._NULL
    with obs_trace.span("block.cast", device=True) as sp:
        sp.set(dropped=torch.tensor(1))
    assert tracer.spans() == []


@pytest.mark.parametrize("on", [False, True], ids=["tracing-off", "tracing-on"])
def test_profiler_sees_program_spans(tracer, tmp_path, on):
    from torch.profiler import ProfilerActivity, profile, record_function

    if on:
        tracer.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer.range"):
            with obs_trace.span("moe.dispatch", device=True, tokens=4) as sp:
                sp.set(dropped=torch.tensor(0))
                torch.ones(64).cumsum(0)
    if not on:
        assert obs_trace.span("after.profile") is obs_trace._NULL
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    inner, outer = ranges["moe.dispatch"], ranges["outer.range"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # the cumsum launched inside the span lies inside its range
    ops = [e for e in events if e.get("cat") == "cpu_op" and "cumsum" in e["name"]]
    assert ops and all(inner["ts"] <= e["ts"] <= inner["ts"] + inner["dur"] for e in ops)
    assert [s.name for s in tracer.spans()] == (["moe.dispatch"] if on else [])


def test_tensor_attributes_are_read_with_the_spans(tracer):
    tracer.enable()
    with obs_trace.span("moe.dispatch", pairs=8, dropped=torch.tensor(3)) as sp:
        sp.set(share=torch.tensor(0.25))
    rec, = tracer.spans()
    assert rec.attrs == {"pairs": 8, "dropped": 3, "share": 0.25}
    assert isinstance(rec.attrs["dropped"], int)
    args = tracer.chrome_trace()["traceEvents"][-1]["args"]
    assert args == {"pairs": 8, "dropped": 3, "share": 0.25}


def test_device_time_is_none_off_the_card(tracer):
    tracer.enable()
    with obs_trace.span("block.cast", device=True):
        torch.ones(8, dtype=torch.bfloat16).float()
    with obs_trace.span("serve.decode_launch"):
        pass
    recs = tracer.spans()
    assert [r.device_dur for r in recs] == [None, None]
    assert [r.to_json()["device_dur"] for r in recs] == [None, None]
    assert all("device_dur_us" not in e["args"]
               for e in tracer.chrome_trace()["traceEvents"] if e["ph"] == "X")


@pytest.mark.cuda
def test_device_time_on_the_card_is_the_events_time(tracer, monkeypatch):
    """A span around 20 bf16 products of 4096 x 4096 reads within 10% of
    CUDA events around the same launches, and 2000 device spans in steps
    of 100 take few events: they go back to the pool as they complete."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)

    def work():
        for _ in range(20):
            a @ b

    work()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    events_ms = []
    for _ in range(5):
        e0.record()
        work()
        e1.record()
        e1.synchronize()
        events_ms.append(e0.elapsed_time(e1))
    tracer.enable()
    for _ in range(5):
        with obs_trace.span("bench.matmul", device=True):
            work()
        torch.cuda.synchronize()
    span_ms = [r.device_dur * 1e3 for r in tracer.spans()]
    assert abs(np.median(span_ms) / np.median(events_ms) - 1) <= 0.10, (span_ms, events_ms)

    made = []
    real = torch.cuda.Event

    def counted(*a, **kw):
        made.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(torch.cuda, "Event", counted)
    tracer.clear()
    x = torch.ones(1024, device="cuda")
    for i in range(2000):
        with obs_trace.span("block.cast", device=True):
            x.add_(1)
        if i % 100 == 99:
            torch.cuda.synchronize()
    recs = tracer.spans()
    assert len(recs) == 2000 and all(r.device_dur is not None and r.device_dur > 0
                                     for r in recs)
    assert len(made) <= 2 * 100 + obs_trace.EVENT_POOL, len(made)


# ------------------------------------------------------------------ the MoE
def _moe_case(capacity):
    cfg = api.configs.get("qwen3-moe-30b-a3b").scaled()
    cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 16, cfg.d_model).astype(np.float32))
    return cfg, p, x


@pytest.mark.parametrize("capacity", [1.25, 0.25])
def test_moe_dispatch_counts_the_dropped_pairs(tracer, capacity):
    from test_torch_moe import _np_dispatch

    cfg, p, x = _moe_case(capacity)
    off, _ = moe.moe_apply(p, x, cfg)
    tracer.enable()
    on, _ = moe.moe_apply(p, x, cfg)
    assert torch.equal(on, off)
    rec, = [r for r in tracer.spans() if r.name == "moe.dispatch"]
    t, k = 32, cfg.moe.top_k
    assert rec.attrs["tokens"] == t and rec.attrs["pairs"] == t * k
    # the numpy dispatch over the router's own choice
    _, idx = moe.route(p, x.reshape(t, -1), cfg)
    _, keep = _np_dispatch({n: v.numpy() for n, v in p.items()}, x.numpy(), cfg,
                           idx=idx.numpy())
    assert rec.attrs["dropped"] == int((~keep).sum())
    if capacity < 1:
        assert rec.attrs["dropped"] > 0


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_dispatch_counts_on_the_ranks_of_a_mesh(tracer, shape):
    """The ranks of the sharded forward count the pairs of the tokens
    they route: ranks that split the tokens ('data') sum to the layer's
    count, and the ranks of one 'model' group route the same tokens, so
    dropped and pairs both come ``model`` times and their share holds."""
    from repro_torch.parallel import sharded
    from repro_torch.parallel.spmd import Mesh

    base = api.configs.get("qwen3-moe-30b-a3b").scaled()
    model = api.build_model(base.scaled(moe=dataclasses.replace(base.moe, capacity_factor=0.5)))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = api.make_batch(model.cfg, "train", 8, 8, device="cpu")
    tracer.enable()
    with torch.no_grad():
        model.loss(params, batch, remat=False)
    one = [r for r in tracer.spans() if r.name == "moe.dispatch"][0]
    assert one.attrs["dropped"] > 0
    tracer.clear()
    sharded.sharded_loss(model, Mesh(np.array(["cpu"] * int(np.prod(shape)), dtype=object)
                                     .reshape(shape), ("data", "model")), params, batch)
    first = {}
    for r in tracer.spans():
        if r.name == "moe.dispatch":
            first.setdefault(r.tid, r)            # each rank's first layer
    assert len(first) == shape[0] * shape[1]
    m = shape[1]
    assert sum(r.attrs["pairs"] for r in first.values()) == m * one.attrs["pairs"]
    assert sum(r.attrs["dropped"] for r in first.values()) == m * one.attrs["dropped"]


# ------------------------------------------------------------ the wave engine
def test_wave_spans_carry_padding_and_live_rows(tracer):
    cfg = api.configs.get("qwen3-moe-30b-a3b").scaled()
    model = api.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    # waves of 2: prompts 5 and 11 (width 11), then 3 and a filler row
    plens, news = [5, 11, 3], [4, 2, 3]
    reqs = [api.Request(uid=i, prompt=rng.randint(1, cfg.vocab, n).astype(np.int32),
                        sampling=api.SamplingParams(max_new_tokens=m, eos_id=-1))
            for i, (n, m) in enumerate(zip(plens, news))]
    eng = api.WaveEngine(model, 2, 32, device="cpu")
    for r in reqs:
        eng.submit(r)
    old = oplib.get_backend()
    oplib.set_backend("torch")
    tracer.enable()
    try:
        eng.run(params)
    finally:
        oplib.set_backend(old)
    recs = tracer.spans()
    prefill = [r.attrs for r in recs if r.name == "wave.prefill"]
    assert prefill == [{"rows": 2, "width": 11, "real": 16}, {"rows": 2, "width": 3, "real": 3}]
    # a request that served n tokens was live in the wave's first n - 1 decode calls
    want = []
    for wave in (reqs[:2], reqs[2:]):
        served = [len(r.out_tokens) for r in wave]
        want += [{"rows": 2, "live": sum(n - 1 > j for n in served)}
                 for j in range(max(served) - 1)]
    assert [r.attrs for r in recs if r.name == "wave.decode_step"] == want
    assert want[0]["live"] == 2 and want[-1]["live"] == 1
    # the prefill's MoE layers route every row of the call, padding and the
    # filler row too
    assert [r.attrs["tokens"] for r in recs if r.name == "moe.dispatch"][:cfg.n_layers] == \
        [2 * 11] * cfg.n_layers
