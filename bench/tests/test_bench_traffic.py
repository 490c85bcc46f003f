"""The traffic generator: the same seed gives the same requests; another
seed gives the same sizes, block by block, in another order."""
from collections import Counter

import numpy as np

import bench_tiny  # noqa: F401  (puts the repository on the path)
from bench import spec, traffic

BIG_SEED = 2**31 + 12345


def _sig(reqs):
    return [(r.max_new_tokens, r.prompt.tolist()) for r in reqs]


def test_same_seed_same_traffic():
    for name in ("chat", "docs", "rag"):
        mix = spec.resolve({"chat": "chatglm3-6b.chat", "docs": "qwen3-moe-30b-a3b.docs",
                            "rag": "chatglm3-6b.rag"}[name]).traffic
        a = traffic.take(mix, 65024, BIG_SEED, 40)
        b = traffic.take(mix, 65024, BIG_SEED, 40)
        assert _sig(a) == _sig(b)
        assert _sig(a) != _sig(traffic.take(mix, 65024, BIG_SEED + 1, 40))


def test_every_seed_serves_the_same_sizes_per_block():
    """Past the clients' first requests, every block of ``block``
    requests holds the mix's stratified sizes; the first requests, caught
    in flight, hold the residual answer lengths, the same set for every
    seed."""
    mix = spec.resolve("chatglm3-6b.chat").traffic
    n, c = mix["block"], mix["clients"]
    assert mix["in_flight"] and c % n == 0
    firsts = set()
    for seed in (0, 7, BIG_SEED):
        reqs = traffic.take(mix, 65024, seed, c + 2 * n)
        assert Counter(r.max_new_tokens for r in reqs[:c]) == Counter(
            traffic.residual_sizes(mix["output_tokens"], c))
        firsts.add(tuple(r.max_new_tokens for r in reqs[:c]))
        for blk in [reqs[i:i + n] for i in range(0, c + 2 * n, n)]:
            assert Counter(r.plen for r in blk) == Counter(traffic.sizes(mix["prompt_tokens"], n))
        for blk in (reqs[c:c + n], reqs[c + n:]):
            assert Counter(r.max_new_tokens for r in blk) == Counter(
                traffic.sizes(mix["output_tokens"], n))
    assert len(firsts) == 3


def test_residual_answer_lengths():
    """The residual life of a length: P(R = r) = P(L >= r) / E[L]."""
    dist = {"min": 2, "max": 2, "median": 2, "sigma": 0.5}      # L is always 2
    assert traffic.residual_sizes(dist, 4) == [1, 1, 2, 2]
    dist = {"min": 1, "max": 3, "median": 2, "sigma": 50.0}     # L is 1 or 3, evenly
    # P(R=1) = 1/2, P(R=2) = P(R=3) = 1/4
    assert traffic.residual_sizes(dist, 8) == [1, 1, 1, 1, 2, 2, 3, 3]


def test_sizes_follow_the_mix():
    mix = spec.resolve("chatglm3-6b.rag").traffic
    s = traffic.sizes(mix["prompt_tokens"], 1000)
    assert min(s) >= 1024 and max(s) <= 4096
    assert abs(np.median(s) - 2048) <= 8
    ids = np.concatenate([r.prompt for r in traffic.take(mix, 65024, 3, 16)])
    assert ids.min() >= 0 and ids.max() < 65024
