"""The legacy wave-batched engine, kept as the serving baseline.

Requests are grouped into fixed-size waves; each wave's prompts are
left-padded to a common length, prefilled in one call, then decoded in
lockstep (one token per engine step for every sequence).  Finished
sequences are masked out; **the wave retires only when all of its
sequences finish**, and only then is the next wave admitted — the slot
bubbles this creates under mixed generation lengths are exactly what the
continuous-batching :class:`~repro_torch.serving.engine.ServingEngine`
removes.  It is the one serving path of every family but the dense one
(moe, vlm, hybrid, ssm, audio): the model's cache goes through as the
model made it (a dict of stacked tensors, xLSTM's list of per-layer
states, the encoder-decoder's ``memory`` that the prefill fills).

The JAX package jits the model's ``prefill`` and ``decode_step``; here
they run eagerly on ``device`` (``"cuda"`` by default; with no card that
raises, it never falls back), with no ``torch.compile`` and no CUDA
graph.  The (slots, prompt length) buckets are still recorded in the
compilation cache, so ``compile_log`` and ``cache_stats`` read as the
JAX package's: the first call of each bucket and its time.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import cache as stripe_cache
from ..core.lower_torch import torch_dtype
from ..obs import trace as obs_trace
from .request import Request


class WaveEngine:
    """Lockstep wave engine over the model's own ``prefill`` / ``decode_step``."""

    def __init__(self, model, batch_slots: int, max_len: int,
                 compile_cache: Optional[stripe_cache.CompilationCache] = None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"WaveEngine(device={device!r}) but no CUDA device is "
                               "available; pass device='cpu' to serve on the CPU")
        self.model = model
        self.cfg = model.cfg
        self.slots = batch_slots
        self.max_len = max_len
        self._queue: List[Request] = []
        self._queue_lock = threading.Lock()  # open-loop drivers submit from a feeder thread
        self._decode = model.decode_step
        self._prefill = model.prefill
        # (batch, length) buckets: real entries (first-call records) are
        # keyed in the compilation cache so hit/miss stats reflect bucket
        # traffic
        self._compile_cache = (compile_cache if compile_cache is not None
                               else stripe_cache.CompilationCache(capacity=64, use_disk=False))
        self._compile_log: List[Dict[str, Any]] = []

    def submit(self, req: Request) -> None:
        req.submit_time = time.perf_counter()
        with self._queue_lock:
            self._queue.append(req)

    def cache_stats(self) -> stripe_cache.CacheStats:
        """Hit/miss stats over (batch, length) buckets."""
        return self._compile_cache.stats

    def compile_log(self) -> List[Dict[str, Any]]:
        """One record per cold bucket: shapes + first-call time."""
        return list(self._compile_log)

    def _bucket(self, plen: int) -> str:
        return stripe_cache.content_key(
            "serve_bucket", getattr(self.cfg, "name", ""), self.slots, plen)

    def _next_wave(self) -> List[Request]:
        with self._queue_lock:
            wave = self._queue[: self.slots]
            self._queue = self._queue[self.slots:]
        return wave

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _greedy(self, logits: torch.Tensor) -> np.ndarray:
        # the first index of the largest logit over the real vocabulary
        return logits[:, -1, : self.cfg.vocab].argmax(dim=-1).cpu().numpy()

    def run(self, params, max_steps: int = 256) -> List[Request]:
        finished: List[Request] = []
        steps = 0
        dtype = torch_dtype(self.cfg.dtype)
        while self._queue and steps < max_steps:
            wave = self._next_wave()
            # pad the wave to full slots by repeating the last request's
            # prompt (masked out of results)
            prompts = [r.prompt for r in wave]
            while len(prompts) < self.slots:
                prompts.append(prompts[-1])
            plen = max(len(p) for p in prompts)
            toks = np.zeros((self.slots, plen), np.int32)
            for i, p in enumerate(prompts):
                toks[i, plen - len(p):] = p  # left-align end-of-prompt
            cache = self.model.init_cache(self.slots, self.max_len, device=self.device)
            batch = {"tokens": torch.from_numpy(toks).to(self.device)}
            if self.cfg.frontend == "patches":
                batch["patches"] = torch.zeros((self.slots, self.cfg.frontend_len, self.cfg.d_model),
                                               dtype=dtype, device=self.device)
            if self.cfg.frontend == "frames":
                batch["frames"] = torch.zeros((self.slots, plen, self.cfg.d_model), dtype=dtype,
                                              device=self.device)
            bucket = self._bucket(plen)
            cold = self._compile_cache.get_memory(bucket) is None
            t0 = time.perf_counter()
            # ``real``: the prompt tokens of the wave's requests; the rest of
            # rows x width (left padding, filler rows) serves no request
            with obs_trace.span("wave.prefill", rows=self.slots, width=plen,
                                real=sum(len(r.prompt) for r in wave)):
                logits, cache = self._prefill(params, batch, cache)
                self._sync()
            if cold:
                rec = {"slots": self.slots, "plen": plen,
                       "first_call_s": time.perf_counter() - t0}
                self._compile_cache.put_memory(bucket, rec)
                self._compile_log.append(rec)
            last = self._greedy(logits)
            live = np.array([i < len(wave) for i in range(self.slots)])
            now = time.perf_counter()
            for i, r in enumerate(wave):
                r.out_tokens.append(int(last[i]))
                r.first_token_time = now

            while any(live[: len(wave)]) and steps < max_steps:
                steps += 1
                tok = torch.from_numpy(last[:, None].astype(np.int32)).to(self.device)
                with obs_trace.span("wave.decode_step", rows=self.slots,
                                    live=int(live.sum())):
                    logits, cache = self._decode(params, cache, tok)
                    last = self._greedy(logits)
                now = time.perf_counter()
                for i, r in enumerate(wave):
                    if not live[i]:
                        continue
                    tok = int(last[i])
                    r.out_tokens.append(tok)
                    if tok == r.sampling.eos_id or len(r.out_tokens) >= r.sampling.max_new_tokens:
                        r.done = True
                        r.finish_time = now
                        live[i] = False
                        finished.append(r)
        return finished
