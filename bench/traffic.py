"""The one traffic generator: a mix's parameters in, requests out.

A mix file (``bench/traffic/<mix>.json``) gives the prompt and output
lengths as clipped lognormals (``min``, ``max``, ``median``, ``sigma``)
and a ``block``.  The lengths of each block of ``block`` consecutive
requests are the same fixed set for every seed: the lognormal's
quantiles at (i + 0.5) / block, clipped.  The seed only orders them
(prompt and output lengths each in an order of their own) and draws the
token ids, uniform over the vocabulary.  So two seeds give the same work
in another order, and a window that covers whole blocks sees the same
sizes.

With ``"in_flight": true`` the first ``clients`` requests, one a client,
stand for requests already being served when the loop starts, as in a
service that has run for a while: their output lengths are the
``clients`` quantiles of the residual life of the output length (the
tokens still to come of a request caught at a random step of its
decode, P(R = r) = P(L >= r) / E[L]), again one fixed set ordered by the
seed.  Without it every client starts a fresh request at once, and
requests of equal length, one from each block, finish at the same step.
Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Any, Dict, Iterator, List

import numpy as np


@dataclasses.dataclass
class Spec:
    """One request as a client sends it."""

    index: int            # its place in the sequence
    prompt: np.ndarray    # (plen,) int32 token ids
    max_new_tokens: int   # tokens to serve, the prefill's first token included

    @property
    def plen(self) -> int:
        return int(self.prompt.size)


def sizes(dist: Dict[str, Any], n: int) -> List[int]:
    """The ``n`` stratified lengths of a clipped lognormal, ascending."""
    nd = NormalDist()
    lo, hi = int(dist["min"]), int(dist["max"])
    mu, sigma = math.log(float(dist["median"])), float(dist["sigma"])
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        out.append(min(hi, max(lo, int(round(math.exp(mu + sigma * z))))))
    return out


def residual_sizes(dist: Dict[str, Any], n: int, grid: int = 4096) -> List[int]:
    """The ``n`` stratified quantiles of the residual life of a length
    drawn from ``dist`` (itself taken at ``grid`` quantiles), ascending."""
    lengths = np.array(sizes(dist, grid), np.int64)
    top = int(lengths.max())
    # P(L >= r) for r = 1 .. top, and the residual's distribution function
    survive = np.array([(lengths >= r).mean() for r in range(1, top + 1)])
    cdf = np.cumsum(survive) / survive.sum()
    q = (np.arange(n) + 0.5) / n
    return [int(np.searchsorted(cdf, x) + 1) for x in q]


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent stream of draws for ``seed`` (any whole number ≥ 0)."""
    return np.random.default_rng([int(seed) % (1 << 64), sum(map(ord, stream))])


def requests(mix: Dict[str, Any], vocab: int, seed: int) -> Iterator[Spec]:
    """The mix's requests in the order clients send them, without end."""
    n = int(mix["block"])
    p_sizes = np.array(sizes(mix["prompt_tokens"], n), np.int64)
    o_sizes = np.array(sizes(mix["output_tokens"], n), np.int64)
    order = rng_for(seed, "order")
    ids = rng_for(seed, "tokens")
    first: List[int] = []
    if mix.get("in_flight"):
        c = int(mix["clients"])
        first = list(np.array(residual_sizes(mix["output_tokens"], c),
                              np.int64)[rng_for(seed, "in_flight").permutation(c)])
    i = 0
    while True:
        ps = p_sizes[order.permutation(n)]
        os_ = o_sizes[order.permutation(n)]
        for j in range(n):
            prompt = ids.integers(0, vocab, size=int(ps[j]), dtype=np.int64).astype(np.int32)
            out = int(first[i]) if i < len(first) else int(os_[j])
            yield Spec(index=i, prompt=prompt, max_new_tokens=out)
            i += 1


def take(mix: Dict[str, Any], vocab: int, seed: int, n: int) -> List[Spec]:
    it = requests(mix, vocab, seed)
    return [next(it) for _ in range(n)]
