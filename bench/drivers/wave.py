"""A closed loop of clients on the port's wave engine (``WaveEngine``),
with the model's projections on ``oplib``'s ``cuda`` backend.

The engine takes ``slots`` requests a wave, prefills them in one call
(left-padded to the longest prompt) and decodes them in lockstep until
the last one finishes.  The driver hands it one wave at a time, the
longest-waiting ``slots`` requests of its clients; the clients of a
finished wave send again at once, behind the others.  So wave k holds
requests k * slots .. (k + 1) * slots - 1 of the traffic sequence, and
the shapes that a window can reach are known before it opens.

The driver hands the engine the model with its ``prefill`` and
``decode_step`` wrapped: every decode call's input tokens (one a row,
the rows past their request's end too) and every call's last-position
logits (which the engine takes its greedy tokens from) are kept for the
check, and
with ``trace`` each call is timed by the host clock after
``torch.cuda.synchronize()`` and run inside a ``bench.prefill`` /
``bench.decode_step`` range; ``bench.proj`` ranges wrap the attention's
projections (``nn.attention.linear``, recording each (m, k, n) while
``recording`` is set) and a ``bench.moe`` range each ``moe_apply``.  A
recorded m counts the rows of work, not of the call: a prefill's real
prompt tokens (not the left padding) and a decode step's rows still
being served (not those decoded past their request's end)."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from bench.served import Job, Served
from bench.traffic import Spec

Product = Tuple[int, int, int]


@dataclasses.dataclass
class Wave:
    members: List[Served]
    width: int                                   # the padded prompt length
    decode_inputs: List[np.ndarray] = dataclasses.field(default_factory=list)
    logits: List[torch.Tensor] = dataclasses.field(default_factory=list)  # each call's, (slots, vocab)
    prefill_s: float = 0.0                       # with ``trace``: the prefill call
    decode_s: List[float] = dataclasses.field(default_factory=list)  # each decode call
    start: float = 0.0
    end: float = 0.0


class Driver:
    def __init__(self, api, model, params, arch, mix, specs: Iterator[Spec], device: str,
                 trace: bool):
        self.api = api
        self.model = model
        self.params = params
        self.arch = arch
        self.mix = mix
        self.specs = specs
        self.device = device
        self.trace = trace
        self.recording = False
        self.products: List[Product] = []
        self._rows = 0                   # the rows of work of the call in progress
        self.slots = mix["slots"]
        api.set_backend("cuda")
        self.eng = api.WaveEngine(dataclasses.replace(model, prefill=self._prefill,
                                                      decode_step=self._decode),
                                  self.slots, mix["max_len"], device=device)
        self.waiting: deque = deque()
        self.waves: List[Wave] = []
        self._wave: Wave = None
        self._stack = contextlib.ExitStack()
        self._lookahead: List[Spec] = []
        if trace:
            self._hook()

    # ------------------------------------------------------------ hooks
    def _sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def _timed(self, kind: str, fn, *a):
        out = self._call(kind, fn, *a)
        # the logits the engine takes its greedy tokens from, kept for the check
        self._wave.logits.append(out[0][:, -1, : self.arch["vocab"]].to("cpu"))
        return out

    def _call(self, kind: str, fn, *a):
        if not self.trace:
            return fn(*a)
        with torch.profiler.record_function(f"bench.{kind}" if kind == "prefill"
                                            else "bench.decode_step"):
            t0 = time.perf_counter()
            out = fn(*a)
            self._sync()
            dt = time.perf_counter() - t0
        if kind == "prefill":
            self._wave.prefill_s = dt
        else:
            self._wave.decode_s.append(dt)
        return out

    def _prefill(self, p, batch, cache):
        self._rows = sum(s.plen for s in self._wave.members)
        return self._timed("prefill", self.model.prefill, p, batch, cache)

    def _decode(self, p, cache, tok):
        # decode call j serves token j + 1 of each request
        j = len(self._wave.decode_inputs)
        self._rows = sum(s.max_new_tokens > j + 1 for s in self._wave.members)
        self._wave.decode_inputs.append(tok.cpu().numpy()[:, 0].astype(np.int64))
        return self._timed("decode", self.model.decode_step, p, cache, tok)

    def _hook(self) -> None:
        from repro_torch.models import lm
        from repro_torch.nn import attention

        real_linear, real_moe = attention.linear, lm.moe_apply

        def linear(x, w, *a, **kw):
            if self.recording:
                self.products.append((self._rows, int(w.shape[0]), int(w.shape[1])))
            with torch.profiler.record_function("bench.proj"):
                return real_linear(x, w, *a, **kw)

        def moe_apply(*a, **kw):
            with torch.profiler.record_function("bench.moe"):
                return real_moe(*a, **kw)

        self._stack.enter_context(_patch(attention, "linear", linear))
        self._stack.enter_context(_patch(lm, "moe_apply", moe_apply))

    # ------------------------------------------------------------- loop
    def _next_spec(self) -> Spec:
        if self._lookahead:
            return self._lookahead.pop(0)
        return next(self.specs)

    def widths(self, waves: int) -> List[int]:
        """The padded prompt length of each of the next ``waves`` waves."""
        while len(self._lookahead) < waves * self.slots:
            self._lookahead.append(next(self.specs))
        specs = list(self.waiting) + self._lookahead
        return [max(s.plen for s in specs[i * self.slots:(i + 1) * self.slots])
                for i in range(waves)]

    def warm(self, api) -> None:
        """Compile every projection shape the next waves reach (the
        prefill's rows are slots x the padded prompt length)."""
        d, h, kv = self.arch["d_model"], self.arch["n_heads"], self.arch["n_kv_heads"]
        hd = int(self.arch.get("head_dim") or d // h)
        dtype = getattr(torch, self.arch["dtype"])
        for width in sorted(set(self.widths(int(self.mix["warm_waves"])))):
            m = self.slots * width
            for k, n in ((d, h * hd), (d, kv * hd), (h * hd, d)):
                api.linear(torch.zeros((m, k), dtype=dtype, device=self.device),
                           torch.zeros((k, n), dtype=dtype, device=self.device))

    def start(self) -> None:
        """Every client sends its first request, and one wave runs."""
        for _ in range(self.mix["clients"]):
            self.waiting.append(self._new_served())
        self.step()

    def _new_served(self) -> Served:
        spec = self._next_spec()
        return Served(spec.index, spec.prompt, spec.max_new_tokens, submit=time.perf_counter())

    def step(self) -> None:
        members = [self.waiting.popleft() for _ in range(self.slots)]
        wave = self._wave = Wave(members, max(s.plen for s in members))
        reqs = []
        for s in members:
            s.group = len(self.waves)
            reqs.append(self.api.Request(uid=s.index, prompt=s.prompt,
                                         sampling=self.api.SamplingParams(
                                             max_new_tokens=s.max_new_tokens, eos_id=-1)))
            self.eng.submit(reqs[-1])
        wave.start = time.perf_counter()
        with (torch.profiler.record_function("bench.run") if self.trace
              else contextlib.nullcontext()):
            finished = self.eng.run(self.params, max_steps=1 << 30)
        wave.end = time.perf_counter()
        if len(finished) != len(members):
            raise RuntimeError(f"wave of {len(members)} finished {len(finished)}")
        for s, r in zip(members, reqs):
            s.first, s.finish = r.first_token_time, r.finish_time
            s.tokens, s.status = list(r.out_tokens), r.status if r.done else "unfinished"
        self.waves.append(wave)
        for _ in members:
            self.waiting.append(self._new_served())

    def counters(self) -> Dict[str, float]:
        return {"waves": len(self.waves)}

    def progress(self) -> Dict[int, int]:
        return {s.index: len(s.tokens) for w in self.waves for s in w.members}

    def requests(self) -> List[Served]:
        """Every request of the waves run (a wave's requests finish with it)."""
        return [s for w in self.waves for s in w.members]

    def jobs(self, rng: np.random.Generator, target: int, t0: float, t1: float) -> List[Job]:
        """Whole waves: the reference recomputes each wave's prefill and
        decode calls, every row, since a MoE layer's capacity is shared by
        all the tokens of a call.  The wave of the longest request, then
        waves drawn from ``rng`` until ``target`` served tokens."""
        done = [g for g, w in enumerate(self.waves) if t0 <= w.end <= t1]
        if not done:
            return []
        count = {g: sum(len(s.tokens) for s in self.waves[g].members) for g in done}
        longest = max(done, key=lambda g: (max(len(s.tokens) for s in self.waves[g].members), -g))
        chosen, total = [longest], count[longest]
        rest = [g for g in done if g != longest]
        for i in rng.permutation(len(rest)):
            if total >= target:
                break
            chosen.append(rest[i])
            total += count[rest[i]]
        out = []
        for g in sorted(chosen):
            w = self.waves[g]
            width, steps = w.width, len(w.decode_inputs)
            toks = np.zeros((self.slots, width + steps), np.int64)
            for i, s in enumerate(w.members):
                toks[i, width - s.plen:width] = s.prompt
            for j, fed in enumerate(w.decode_inputs):
                toks[:, width + j] = fed
            at, served, logits = [], [], []
            for i, s in enumerate(w.members):
                for j, tok in enumerate(s.tokens):
                    at.append((i, width - 1 + j))
                    served.append(tok)
                    logits.append(w.logits[j][i])
                    # a live row's fed token is the one it was served
                    if j + 1 < len(s.tokens) and toks[i, width + j] != s.tokens[j]:
                        raise RuntimeError(f"wave {g} row {i}: fed {toks[i, width + j]}, "
                                           f"served {s.tokens[j]}")
            groups = [(0, width)] + [(width + j, width + j + 1) for j in range(steps)]
            at = np.asarray(at, np.int64)
            out.append(Job(tokens=toks, at=at, served=np.asarray(served, np.int64),
                           groups=groups, logits=torch.stack(logits),
                           stage=np.minimum(at[:, 1] - (width - 1), 2)))
        return out

    def close(self) -> None:
        self._stack.close()


@contextlib.contextmanager
def _patch(mod, name: str, value):
    old = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, old)
