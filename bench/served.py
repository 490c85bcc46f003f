"""What a driver hands back: each request as the client saw it, and the
jobs that the reference recomputes to judge the served tokens."""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Served:
    index: int                  # its place in the traffic sequence
    prompt: np.ndarray          # (plen,) int32
    max_new_tokens: int
    submit: float = 0.0         # the client's send, time.perf_counter
    first: float = 0.0          # its first token (0: none yet)
    finish: float = 0.0         # its last token (0: not finished)
    tokens: List[int] = dataclasses.field(default_factory=list)
    status: str = ""            # the engine's, once finished
    group: int = -1             # the wave it ran in (wave drivers)

    @property
    def plen(self) -> int:
        return int(self.prompt.size)


@dataclasses.dataclass
class Job:
    """One forward of the reference: ``tokens`` (B, T), the logits at
    ``at`` (N, 2: row, column) judged against ``served`` (N,), the tokens
    the program served there; ``groups`` are the column ranges that were
    one call of the model (a MoE layer's capacity is per call);
    ``logits`` (N, vocab), where the program hands them out, are the
    logits it served each token from, and ``stage`` (N,) which call served
    it: 0 a prefill, 1 the first decode step (it reads only what the
    prefill wrote), 2 a later one."""

    tokens: np.ndarray
    at: np.ndarray
    served: np.ndarray
    groups: Optional[Sequence[Tuple[int, int]]] = None
    logits: Optional[Any] = None
    stage: Optional[np.ndarray] = None


def one_sequence(r: Served) -> Job:
    """A request served alone: its prompt and every served token but the
    last, fed in order; the logits at the prompt's last position and at
    each fed token predict the next served one."""
    toks = np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int32)])[None]
    cols = np.arange(r.plen - 1, r.plen - 1 + len(r.tokens))
    at = np.stack([np.zeros_like(cols), cols], axis=1)
    return Job(tokens=toks, at=at, served=np.asarray(r.tokens, np.int64))


def sample(rng: np.random.Generator, done: Sequence[Served], target: int) -> List[Served]:
    """Finished requests to check: the one with the most served tokens,
    then others drawn from ``rng`` until ``target`` served tokens."""
    pool = [r for r in done if r.tokens]
    if not pool:
        return []
    longest = max(pool, key=lambda r: (len(r.tokens), -r.index))
    out, total = [longest], len(longest.tokens)
    rest = [r for r in pool if r is not longest]
    for i in rng.permutation(len(rest)):
        if total >= target:
            break
        out.append(rest[i])
        total += len(rest[i].tokens)
    return out
