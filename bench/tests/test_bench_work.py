"""The roofline and model-FLOPs arithmetic on shapes worked by hand, and
the trace reading that the device metrics take their times from."""
import pytest

import bench_tiny  # noqa: F401
from bench import devtrace, harness, peaks, spec, work

TOY = {"d_model": 4, "n_heads": 2, "n_kv_heads": 1, "head_dim": 2, "d_ff": 8, "vocab": 10,
       "n_layers": 1, "act": "silu_glu", "dtype": "bfloat16"}


def test_matmul_bound_by_bytes_then_by_operations():
    # 128 x 4096 @ 4096 x 4096 in bf16: 2 * (16777216 + 524288 + 524288) bytes
    assert work.matmul_bound_s(128, 4096, 4096, "bfloat16") == pytest.approx(
        2 * 17825792 / 3.35e12)
    # 4096 rows: 2 * 4096^3 operations over 989 TFLOP/s outweigh 100.7 MB
    assert work.matmul_bound_s(4096, 4096, 4096, "bfloat16") == pytest.approx(
        2 * 4096 ** 3 / 989e12)


def test_model_flops_of_a_toy_model():
    # attention 4*4 + 2*(4*2) + 4*4 = 48, MLP 3*4*8 = 96: 2 * 144 a token
    assert work.token_flops(TOY, 3) == 288 + 4 * 2 * 2 * 3
    assert work.head_flops(TOY) == 80
    assert work.prefill_flops(TOY, 3) == 288 * 3 + 4 * 2 * 2 * 6 + 80
    assert work.served_flops(TOY, 3, 0, 2) == (work.prefill_flops(TOY, 3)
                                               + work.token_flops(TOY, 4) + 80)
    moe = dict(TOY, moe={"n_experts": 4, "top_k": 2, "d_ff_expert": 8})
    assert work.ffn_active_params(moe) == 2 * 3 * 4 * 8 + 4 * 4


def _trace():
    ev = [{"cat": "user_annotation", "name": "bench.slice", "ts": 0.0, "dur": 100.0},
          {"cat": "user_annotation", "name": "bench.proj", "ts": 10.0, "dur": 5.0},
          {"cat": "user_annotation", "name": "bench.decode_step", "ts": 5.0, "dur": 60.0}]
    for c, (launch, ts, dur) in enumerate([(11.0, 20.0, 10.0), (30.0, 25.0, 10.0),
                                           (70.0, 80.0, 10.0)]):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch, "dur": 1,
                   "args": {"correlation": c}})
        ev.append({"cat": "kernel", "name": f"k{c}", "ts": ts, "dur": dur,
                   "args": {"correlation": c}})
    return devtrace.Trace(ev)


def test_trace_busy_ranges_and_gaps():
    t = _trace()
    assert t.busy_us() == pytest.approx(25.0)          # [20, 35) and [80, 90)
    assert [e["name"] for e in t.launched_in("bench.proj")] == ["k0"]
    gaps = t.idle_gaps()
    assert gaps[0] == ["bench.decode_step", pytest.approx(45e-6)]   # [35, 80), middle 57.5
    assert gaps[1] == ["bench.proj", pytest.approx(20e-6)]           # [0, 20), middle 10
    assert gaps[2] == ["host outside the harness's ranges", pytest.approx(10e-6)]
    assert t.top_ops(1) == [["k0", pytest.approx(10e-6)]]


def test_device_readers_on_a_hand_made_trace():
    t = _trace()
    ctx = harness.Context(dict(TOY), {}, ({}, {}), [], [], [], t, slice_s=2.0,
                          slice_flops=0.5 * 2.0 * peaks.PEAK_FLOPS["bfloat16"],
                          products=[(128, 4096, 4096)])
    assert spec.metric_reader("mfu_pct.out").read(ctx) == pytest.approx(50.0)
    assert spec.metric_reader("device.idle_pct.out").read(ctx) == pytest.approx(75.0)
    bound = work.matmul_bound_s(128, 4096, 4096, "bfloat16")
    assert spec.metric_reader("proj_roofline.out").read(ctx) == pytest.approx(
        100.0 * bound / 10e-6)
    ctx.trace = None
    assert spec.metric_reader("mfu_pct.out").read(ctx) is None
    assert spec.metric_reader("moe.device_pct").read(ctx) is None
