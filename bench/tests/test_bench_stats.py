"""The window's statistics: a nearest-rank p95 over every request, and
rates over the whole window, which a stall lowers."""
import time

import numpy as np
import pytest

import bench_tiny
from bench import harness, stats
from bench.served import Served


def _req(i, submit, first, finish, n):
    return Served(i, np.zeros(8, np.int32), n, submit=submit, first=first, finish=finish,
                  tokens=list(range(n)), status="ok")


def test_p95_is_the_nearest_rank_over_all_requests():
    assert stats.p95(list(range(1, 101))) == 95
    assert stats.p95(list(range(1, 21))) == 19
    assert stats.p95([5.0]) == 5.0
    assert stats.p95([]) is None
    # one slow request in twenty sets the p95 only if it is past the rank
    assert stats.p95([1.0] * 19 + [100.0]) == 1.0
    assert stats.p95([1.0] * 18 + [100.0] * 2) == 100.0


def test_tails_take_every_request_in_the_window():
    window = (10.0, 20.0)
    served = [_req(i, 10.0 + i * 0.1, 10.1 + i * 0.1, 11.0 + i * 0.1, 9) for i in range(19)]
    served.append(_req(19, 12.0, 15.0, 19.0, 9))          # a slow first token
    served.append(_req(20, 1.0, 2.0, 3.0, 9))             # before the window: not counted
    ttft = harness.end_to_end("ttft_p95_ms", served, ({}, {}), window, 0.0)
    assert ttft == pytest.approx(100.0)                   # 19 of 20 at 100 ms: rank 19
    served.append(_req(21, 12.0, 16.0, 19.5, 9))
    # 21 requests: rank 20 is the second slow one, 3000 ms
    assert harness.end_to_end("ttft_p95_ms", served, ({}, {}), window, 0.0) == pytest.approx(3000.0)
    # first token in set-up, finished in the window: not served wholly in it
    served.append(_req(22, 8.0, 9.0, 19.0, 2))
    tpot = harness.end_to_end("tpot_p95_ms", served, ({}, {}), window, 0.0)
    assert tpot == pytest.approx(3500.0 / 8)


def test_rates_are_over_the_whole_window():
    before, after = {1: 2, 2: 0}, {1: 10, 2: 4, 3: 6}
    assert harness.end_to_end("output_tokens_per_s", [], (before, after), (5.0, 7.0),
                              0.0) == pytest.approx(9.0)
    served = [_req(1, 5.0, 6.0, 0.0, 1), _req(2, 4.0, 4.5, 0.0, 1)]
    assert harness.end_to_end("prompt_tokens_per_s", served, ({}, {}), (5.0, 7.0),
                              0.0) == pytest.approx(4.0)


def test_a_stall_in_the_window_lowers_the_rate(monkeypatch):
    from bench.drivers import continuous

    ov = bench_tiny.overrides("chatglm3-6b.chat")
    clean = harness.run_cell("chatglm3-6b.chat", 5, 2.0, False, device="cpu", overrides=ov)
    real = continuous.Driver.step
    stalled = {"done": False, "steps": 0}

    def step(self):
        real(self)
        # the first step is the set-up's; the third is inside the window
        stalled["steps"] += 1
        if stalled["steps"] == 3:
            stalled["done"] = True
            time.sleep(2.0)

    monkeypatch.setattr(continuous.Driver, "step", step)
    slow = harness.run_cell("chatglm3-6b.chat", 5, 2.0, False, device="cpu", overrides=ov)
    assert stalled["done"]
    a = clean["metrics"]["output_tokens_per_s"]["value"]
    b = slow["metrics"]["output_tokens_per_s"]["value"]
    assert b < 0.7 * a, (a, b)
