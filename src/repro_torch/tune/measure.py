"""Noise-robust measurement harness: min of interleaved rounds.

Single-shot wall times on a shared CPU host are dominated by scheduling
noise.  The estimator used throughout the benches (and now everywhere a
measurement feeds the tuning DB) is:

* run several **rounds**; each round times every candidate once (a short
  burst of ``calls`` dispatches, averaged);
* **interleave**: alternate the candidate order per round, so a
  contention burst lands on different candidates in different rounds
  instead of biasing whoever runs last;
* take the per-candidate **minimum** across rounds — contention only
  ever *adds* time (timeit's rationale), so the minimum is the
  noise-robust location estimate.

The timer is injectable: the default is the host's wall clock, and a
thunk that runs on the card ends in ``torch.cuda.synchronize()`` (the
caller bakes it in, as the JAX package's thunks end in
``jax.block_until_ready``), so each call is timed to the card's finish.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Hashable, Mapping, Optional

DEFAULT_ROUNDS = 4
DEFAULT_CALLS = 2


@dataclasses.dataclass
class Measurement:
    """One candidate's estimate: best per-call seconds and how it was
    taken (recorded into the tuning DB next to the value)."""

    min_s: float
    rounds: int
    calls: int
    all_rounds_s: tuple = ()

    def to_json(self) -> Dict[str, Any]:
        return {"min_s": self.min_s, "rounds": self.rounds,
                "calls": self.calls,
                "all_rounds_s": list(self.all_rounds_s)}


def measure_interleaved(thunks: Mapping[Hashable, Callable[[], Any]], *,
                        rounds: int = DEFAULT_ROUNDS,
                        calls: int = DEFAULT_CALLS, warmup: int = 1,
                        timer: Optional[Callable[[], float]] = None,
                        ) -> Dict[Hashable, Measurement]:
    """Measure every zero-arg thunk (one dispatch per call, including any
    device sync — the caller bakes in ``torch.cuda.synchronize()``) and return
    per-key :class:`Measurement`.  A thunk that raises is simply absent
    from the result (one broken candidate must not sink the batch)."""
    clock = timer if timer is not None else time.perf_counter
    keys = [k for k in thunks]
    alive: Dict[Hashable, list] = {}
    for k in keys:
        try:
            for _ in range(max(int(warmup), 0)):
                thunks[k]()
            alive[k] = []
        except Exception:
            continue
    n_calls = max(int(calls), 1)
    for r in range(max(int(rounds), 1)):
        order = [k for k in keys if k in alive]
        if r % 2:
            order.reverse()
        for k in order:
            fn = thunks[k]
            try:
                t0 = clock()
                for _ in range(n_calls):
                    fn()
                alive[k].append((clock() - t0) / n_calls)
            except Exception:
                del alive[k]
    return {k: Measurement(min_s=min(ts), rounds=len(ts), calls=n_calls,
                           all_rounds_s=tuple(ts))
            for k, ts in alive.items() if ts}
