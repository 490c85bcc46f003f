"""A closed loop of clients on the port's continuous-batching engine
(``ServingEngine``): each client sends its next request as soon as its
last one finishes.

The loop calls ``run(max_steps=1)``: the engine admits what it can (one
batch-1 prefill a request), runs one decode step over every slot, and
returns the requests that finished; their clients send again before the
next call.  Timestamps are the engine's own (``submit_time``,
``first_token_time``, ``finish_time``: ``time.perf_counter``).

With ``trace`` the driver opens ``torch.profiler`` ranges around the
calls into each layer: ``bench.run`` (one loop step), ``bench.prefill``
and ``bench.decode_step`` (the engine's two steps), and ``bench.proj``
around each of the block programs' projection calls (``paged._qkv``,
``_attn_out``, ``_mlp``), recording each product's (m, k, n) while
``recording`` is set.  Its m counts the rows of work, not of the call: a
prefill's prompt tokens (the call runs its power-of-two bucket) and a
decode step's live slots (the call runs every slot)."""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from bench.served import Job, Served, one_sequence, sample
from bench.traffic import Spec

Product = Tuple[int, int, int]


class Driver:
    def __init__(self, api, model, params, arch, mix, specs: Iterator[Spec], device: str,
                 trace: bool):
        self.api = api
        self.params = params
        self.arch = arch
        self.mix = mix
        self.specs = specs
        self.trace = trace
        self.recording = False
        self.products: List[Product] = []
        self._rows = 0                   # the rows of work of the call in progress
        self.eng = api.ServingEngine(model, api.EngineConfig(
            slots=mix["slots"], max_len=mix["max_len"], page_size=mix["page_size"],
            device=device, backend="cuda", hw="h100", use_disk_cache=True))
        self.served: Dict[int, Served] = {}
        self._live: Dict[int, object] = {}
        self._stack = contextlib.ExitStack()
        if trace:
            self._hook()

    # ------------------------------------------------------------ hooks
    def _hook(self) -> None:
        from repro_torch.serving import paged

        eng = self.eng
        decode, get_prefill = eng._decode_fn, eng._get_prefill

        def decode_fn(*a, **kw):
            self._rows = sum(r is not None for r in eng._slot_req)
            with torch.profiler.record_function("bench.decode_step"):
                return decode(*a, **kw)

        def prefill_for(bucket, params, warm=False):
            fn = get_prefill(bucket, params, warm=warm)

            def prefill_fn(params, tokens, length, *rest):
                self._rows = int(length)
                with torch.profiler.record_function("bench.prefill"):
                    return fn(params, tokens, length, *rest)
            return prefill_fn

        eng._decode_fn = decode_fn
        eng._get_prefill = prefill_for
        d, h, kv, hd = (self.arch["d_model"], self.arch["n_heads"], self.arch["n_kv_heads"],
                        int(self.arch.get("head_dim") or self.arch["d_model"] // self.arch["n_heads"]))
        f = self.arch["d_ff"]

        def shapes_of(name) -> List[Product]:
            m = self._rows
            if name == "_qkv":
                return [(m, d, h * hd), (m, d, kv * hd), (m, d, kv * hd)]
            if name == "_attn_out":
                return [(m, h * hd, d)]
            return [(m, d, f), (m, d, f), (m, f, d)]

        for name in ("_qkv", "_attn_out", "_mlp"):
            real = getattr(paged, name)

            def wrapped(*a, _real=real, _name=name, **kw):
                if self.recording:
                    self.products.extend(shapes_of(_name))
                with torch.profiler.record_function("bench.proj"):
                    return _real(*a, **kw)

            self._stack.enter_context(_patch(paged, name, wrapped))

    # ------------------------------------------------------------- loop
    def _send(self) -> None:
        spec = next(self.specs)
        req = self.api.Request(uid=spec.index, prompt=spec.prompt,
                               sampling=self.api.SamplingParams(
                                   max_new_tokens=spec.max_new_tokens, eos_id=-1))
        self.eng.submit(req)
        self.served[spec.index] = Served(spec.index, spec.prompt, spec.max_new_tokens,
                                         submit=req.submit_time)
        self._live[spec.index] = req

    def start(self) -> None:
        """Every client sends its first request; one call admits them
        all, so the window opens on full slots, every prompt bucket and
        the decode step already run once."""
        for _ in range(self.mix["clients"]):
            self._send()
        self.step()

    def step(self) -> None:
        with (torch.profiler.record_function("bench.run") if self.trace
              else contextlib.nullcontext()):
            finished = self.eng.run(self.params, max_steps=1)
        for r in finished:
            self._record(r)
            del self._live[r.uid]
            self._send()

    def _record(self, r) -> None:
        s = self.served[r.uid]
        s.first, s.finish = r.first_token_time, r.finish_time
        s.tokens, s.status = list(r.out_tokens), r.status

    def counters(self) -> Dict[str, float]:
        m = self.eng.metrics()
        slots = self.mix["slots"]
        return {"tokens_out": m["tokens_out"], "decode_steps": m["decode_steps"],
                "live_slot_steps": m["slot_utilization"] * max(m["decode_steps"], 1) * slots,
                "compiles": len(self.eng.compile_log())}

    def progress(self) -> Dict[int, int]:
        """Tokens served so far by every request sent."""
        out = {i: len(s.tokens) for i, s in self.served.items()}
        for i, r in self._live.items():
            out[i] = len(r.out_tokens)
            s = self.served[i]
            s.first = r.first_token_time
            s.tokens = list(r.out_tokens)
        return out

    def requests(self) -> List[Served]:
        """Every request sent, as far as it has been served."""
        self.progress()
        return list(self.served.values())

    def jobs(self, rng: np.random.Generator, target: int, t0: float, t1: float) -> List[Job]:
        done = [s for s in self.served.values() if s.finish and t0 <= s.finish <= t1]
        return [one_sequence(r) for r in sample(rng, done, target)]

    def close(self) -> None:
        self.eng.close()
        self._stack.close()


@contextlib.contextmanager
def _patch(mod, name: str, value):
    old = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, old)
