"""Continuous-batching serving engine over a paged KV cache, with decode
compiled through ``stripe_jit``.

Architecture (one PR-sized tour; DESIGN.md §9 has the long form):

* **Slots, not waves.**  The decode step always runs ``slots`` sequences;
  a finished sequence is evicted *that step* and the freed slot is
  refilled from the queue in the same admission phase, so the batch never
  drains to let stragglers finish.
* **Paged KV** (:mod:`repro_torch.serving.paged`): fixed-size pages in one
  static physical store, a per-slot page table, pages recycled on
  eviction.  Admission blocks only when the *pool* (not a dense
  per-slot allocation) is exhausted.
* **Stripe-compiled decode** (:mod:`repro_torch.serving.stripe_decode`): the
  dense blocks of both prefill and decode are Tile programs compiled
  via ``stripe_jit`` — fusion grouping, memory planning, per-block
  hybrid backend fallback — with every :class:`CompileRecord` surfaced
  through :meth:`ServingEngine.compile_records`.  With the default
  ``backend="cuda"`` every fusion group is one launch of the hand-written
  CUDA contraction kernel.
* **Eager steps on one device.**  The decode and prefill steps are plain
  Python over tensors on ``EngineConfig.device`` (``"cuda"`` by default;
  the engine raises when that device is missing, it never moves to the
  CPU); the page store is updated in place.
* **Genuine compile buckets.**  Prefill compiles per power-of-two prompt
  bucket; each bucket's compiled step is a *real entry* in the
  :class:`~repro_torch.core.cache.CompilationCache` keyed by a content hash,
  so ``cache_stats()`` counts true bucket hit/miss traffic (the old
  engine only logged buckets).  With a disk-backed cache the engine
  writes a bucket *manifest* and warm-starts every previously seen
  bucket at boot, while the stripe tilings replay from the on-disk
  store.
* **Async host prep.**  ``submit()`` hands the raw request to a
  background thread that pads and buckets it while the device is busy
  decoding; admission drains the prepared queue (deterministically —
  single FIFO worker) at each step boundary.
* **Resilience** (:mod:`repro_torch.reliability.faults` names the injection
  sites; DESIGN.md §10 has the long form).  The engine survives every
  registered serve-time fault site:

  - *prep-thread supervision* — a request whose prep raises becomes a
    failed request (``status == "failed"``); a dying worker hands its
    exception back under the condition variable (no 10s stall) and is
    restarted, its in-flight request requeued (prep is side-effect-free;
    bounded by ``max_retries``);
  - *compile quarantine* — a prompt bucket whose compiled-step build
    raises serves through the plain-torch prefill instead (same tokens),
    and the bucket is negative-cached with exponential backoff
    (``quarantine``/``quarantine_expired``/``quarantine_clear`` events);
  - *deadlines* — ``SamplingParams.ttl_s`` / ``EngineConfig.default_ttl_s``
    bound each request's life; expired requests are evicted (queued ones
    never occupy a slot) with ``status == "deadline_exceeded"``;
  - *load shedding* — with ``EngineConfig.max_queue`` set, ``submit()``
    rejects excess requests (``status == "shed"``, a ``shed`` event)
    instead of growing the queue without bound;
  - *crash-safe decode* — a device-step failure evicts only the affected
    slots and requeues their requests (bounded by ``max_retries``); the
    retried incarnation regenerates the already-emitted prefix and
    *verifies* it token-for-token without re-emitting (exactly-once
    output), while healthy slots keep decoding;
  - *page-allocation failures* — a failed allocation defers the
    admission (``alloc_failed`` event) instead of crashing the engine.

Public contract
---------------
``ServingEngine(model, EngineConfig(...))`` (or the legacy
``ServingEngine(model, batch_slots=4, max_len=64)`` shim), then either

* batch: ``engine.submit(Request(...)); finished = engine.run(params)``;
* streaming: ``for uid, tok in engine.generate(prompts, params=params)``.

``submit()`` returns ``False`` when the bounded queue sheds the request.
``run()`` returns every request that reached a terminal state during the
call — check ``Request.status`` (``ok`` / ``deadline_exceeded`` /
``failed``); shed requests never enter the engine and are listed by
:meth:`ServingEngine.shed`.

Greedy decoding only (``SamplingParams.temperature == 0.0``); a request's
``out_tokens`` includes the token emitted by its prefill step.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import cache as stripe_cache
from ..core.driver import CompileRecord
from ..core.hwconfig import get_config as _get_hw
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..reliability import faults
from .paged import PagePool, init_pages, make_decode_step, make_prefill_step, pages_needed
from .request import EngineConfig, Request, SamplingParams
from .stripe_decode import EngineLikeConfig, build_programs

__all__ = ["ServingEngine", "Request", "SamplingParams", "EngineConfig"]

_STOP = object()


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class _Prepared:
    """A request after host-side prep (padding + bucketing), ready to admit."""

    req: Request
    order: int
    plen: int
    bucket: int
    tokens: np.ndarray  # (1, bucket) int32, right-padded
    n_pages: int
    eff_new: int        # max_new_tokens clipped to what max_len can hold


class ServingEngine:
    """Continuous-batching engine; see module docstring for the contract."""

    def __init__(self, model, config: Optional[EngineConfig] = None,
                 max_len: Optional[int] = None, *,
                 batch_slots: Optional[int] = None,
                 compile_cache: Optional[stripe_cache.CompilationCache] = None,
                 params: Any = None):
        # Legacy shim: ServingEngine(model, 4, 64) and
        # ServingEngine(model, batch_slots=4, max_len=64) both still work.
        if isinstance(config, int):
            batch_slots, config = config, None
        if config is None:
            config = EngineConfig(
                slots=batch_slots if batch_slots is not None else 8,
                max_len=max_len if max_len is not None else 256)
        config.validate()
        self.model = model
        self.cfg = model.cfg
        if getattr(self.cfg, "family", "dense") != "dense" or \
                getattr(self.cfg, "frontend", "none") != "none":
            raise ValueError(
                f"ServingEngine serves dense-attention LMs (family='dense', "
                f"frontend='none'); got family={self.cfg.family!r} "
                f"frontend={self.cfg.frontend!r}. Use WaveEngine for other families.")
        self._device = torch.device(config.device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"EngineConfig(device={config.device!r}) but no CUDA device is "
                "available; pass device='cpu' to serve on the CPU")
        self.config = config
        self.slots = config.slots
        self.max_len = config.max_len
        self._params = params

        self._compile_cache = (compile_cache if compile_cache is not None
                               else stripe_cache.CompilationCache(
                                   capacity=256, use_disk=config.use_disk_cache))
        self._tune_db = None
        if config.tune:
            # the tuning DB lives next to the disk compilation cache (or
            # the process default dir): bucket compiles consult it, and
            # profiled calls feed measurements back into it
            from ..tune.db import TuningDB

            self._tune_db = TuningDB(dir=self._compile_cache.disk_dir)
        self._jc = EngineLikeConfig(
            hw=_get_hw(config.hw), backend=config.backend,
            use_disk=self._compile_cache.disk_dir is not None,
            cache=self._compile_cache, profile=config.profile,
            tune=self._tune_db, device=self._device.type)

        # ---- paged KV state (static shapes; see paged.py for the layout)
        self._ps = config.page_size
        self._pps = config.pages_per_slot
        self._kv_window = self._pps * self._ps
        self._pool = PagePool(config.pool_pages, self.slots)
        self._pk, self._pv = init_pages(self.cfg, self._pool.total_pages, self._ps,
                                        self._device)
        self._garbage = np.array(
            [self._pool.garbage_page(s) for s in range(self.slots)], np.int32)
        self._page_table = np.tile(self._garbage[:, None], (1, self._pps)).astype(np.int32)
        self._pos = np.zeros(self.slots, np.int32)
        self._last = np.zeros(self.slots, np.int32)
        self._slot_req: List[Optional[Request]] = [None] * self.slots
        self._slot_pages: List[List[int]] = [[] for _ in range(self.slots)]
        self._slot_eff = np.zeros(self.slots, np.int64)
        self._free_slots = list(range(self.slots))

        # ---- compile identity: content keys shared across engine instances
        self._model_fp = stripe_cache.stable_hash(dataclasses.asdict(self.cfg))
        self._manifest_key = stripe_cache.content_key(
            "serve_manifest", self._model_fp, self._ps, self._pps,
            config.backend, config.use_stripe_decode)
        self._records: Dict[str, CompileRecord] = {}
        self._compile_log: List[Dict[str, Any]] = []
        self._pending_tuned: List[Dict[str, Any]] = []
        self._build_decode()

        # ---- async prep: submit() -> raw queue -> FIFO worker -> ready deque
        self._raw: "queue.Queue" = queue.Queue()
        self._ready: Deque[_Prepared] = deque()
        self._cond = threading.Condition()
        self._n_submitted = 0
        self._n_prepared = 0
        self._order = 0
        self._prep_thread: Optional[threading.Thread] = None
        # a dying prep worker leaves (in-flight request, exception) here and
        # notifies the condition variable so _drain_prep reacts immediately
        self._prep_exc: Optional[Tuple[Optional[Request], BaseException]] = None
        self._prep_restarts = 0

        # ---- resilience: bucket compile quarantine + retry/replay state
        self._quarantine = stripe_cache.QuarantineStore(
            base_backoff_s=config.quarantine_backoff_s,
            stats=self._compile_cache.stats)
        # per-slot exactly-once bookkeeping: tokens emitted by this
        # incarnation, and how many of them are replays of pre-failure output
        self._slot_emitted = np.zeros(self.slots, np.int64)
        self._slot_replay = np.zeros(self.slots, np.int64)
        # hot-path read: _surface_cache_errors runs every serve iteration,
        # so hold the registry counter itself rather than going through the
        # CacheStats attribute shim (and never copy a stats dict per step)
        self._disk_err_ctr = self._compile_cache.stats.registry.counter(
            "cache.disk_errors")
        self._disk_errors_seen = int(self._disk_err_ctr.value)

        # ---- bookkeeping + observability
        # the event log is a bounded ring buffer: long-running traffic
        # cannot grow it without bound; drops are counted and surfaced as
        # the serve.dropped_events metric
        self._next_uid = 0
        self._event_cap = config.event_log_size or None
        self._events: Deque[Dict[str, Any]] = deque(maxlen=self._event_cap)
        self._dropped_events = 0
        self._obs = obs_metrics.Registry()
        self._m_events = {}  # per-event-label counter cache (hot-path refs)
        self._finished: List[Request] = []
        self._shed_reqs: List[Request] = []
        self._steps = 0
        self._live_steps = 0
        self._tokens_out = 0
        self._retries_total = 0
        self._warmed = False
        self._decode_warm = False
        self._h_decode = self._obs.histogram("serve.decode_step_s")
        self._h_prefill = self._obs.histogram("serve.prefill_s")
        self._h_queue = self._obs.histogram("serve.queue_wait_s")
        self._h_request = self._obs.histogram("serve.request_s")
        for fields in self._pending_tuned:  # decode compiles pre-date the log
            self._event("tuned_replay", **fields)
        self._pending_tuned.clear()

    # -------------------------------------------------------------- events
    def _event(self, event: str, **fields) -> None:
        """Append one structured event to the bounded log, count it in the
        metrics registry, and (when tracing) mark it on the trace."""
        if self._event_cap is not None and len(self._events) == self._event_cap:
            self._dropped_events += 1
        self._events.append({"step": self._steps, "event": event, **fields})
        ctr = self._m_events.get(event)
        if ctr is None:
            ctr = self._m_events[event] = self._obs.counter(
                "serve.events", event=event)
        ctr.inc()
        obs_trace.instant(f"serve.{event}", **fields)

    def _finish_obs(self, r: Request) -> None:
        """Request-lifecycle observability at terminal time: total-latency
        histogram plus a retroactive ``serve.request`` span covering the
        request's whole life (submit -> terminal)."""
        if r.submit_time and r.finish_time:
            self._h_request.observe(r.finish_time - r.submit_time)
            obs_trace.span_at("serve.request", r.submit_time, r.finish_time,
                              uid=r.uid, status=r.status,
                              tokens=len(r.out_tokens))

    # ------------------------------------------------------------- compile
    def _build_decode(self) -> None:
        """Compile (or fetch) the decode-step programs + the step.

        The entry is a genuine compilation-cache record keyed by model
        fingerprint and engine geometry, so a second engine over the same
        model reuses the live compiled step (a memory hit in
        ``cache_stats()``)."""
        key = stripe_cache.content_key(
            "serve_decode", self._model_fp, self.slots, self._ps, self._pps,
            self.config.backend, self.config.hw, self.config.use_stripe_decode,
            # tuned replays lower different tilings (and per device: the DB
            # keeps plain-version and card timings apart), so a tuned bucket
            # never aliases an untuned one in a shared live cache
            self.config.tune, self._device.type)
        hit = self._compile_cache.get_memory(key)
        if hit is None:
            t0 = time.perf_counter()
            progs = (build_programs(self.cfg, self.slots, self._jc,
                                    kv_window=self._kv_window)
                     if self.config.use_stripe_decode else None)
            fn = make_decode_step(self.cfg, progs, self._ps)
            hit = (fn, progs)
            self._compile_cache.put_memory(key, hit)
            self._compile_log.append({
                "kind": "decode_programs", "slots": self.slots,
                "kv_window": self._kv_window,
                "first_call_s": time.perf_counter() - t0})
            if progs is not None:
                self._note_tuned("decode", progs.records)
        self._decode_fn, self._decode_progs = hit
        if self._decode_progs is not None:
            self._records.update(
                {f"decode/{k}": v for k, v in self._decode_progs.records.items()})

    def _note_tuned(self, kind: str, records) -> None:
        """Emit one ``tuned_replay`` event per freshly-compiled program
        whose tilings came from the tuning DB (decision provenance for
        the event log; replayed cache hits stay silent).  Decode compiles
        happen before the event log exists, so early events buffer in
        ``_pending_tuned`` and flush at the end of ``__init__``."""
        for name, rec in records.items():
            if (getattr(rec, "decision_source", "") == "tuned"
                    and not rec.cache_hit):
                tuned = getattr(rec, "tuned", None) or {}
                fields = dict(kind=kind, program=name,
                              candidate=str(tuned.get("candidate_id", "")),
                              measured_s=tuned.get("measured_s"),
                              source=str(tuned.get("source", "")))
                if getattr(self, "_obs", None) is None:
                    self._pending_tuned.append(fields)
                else:
                    self._event("tuned_replay", **fields)

    def _prefill_key(self, bucket: int) -> str:
        return stripe_cache.content_key(
            "serve_prefill", self._model_fp, self._ps, self._pps, bucket,
            self.config.backend, self.config.hw, self.config.use_stripe_decode,
            self.config.tune, self._device.type)

    def _get_prefill(self, bucket: int, params, warm: bool = False):
        """Fetch-or-compile the prefill step for one prompt bucket.

        Every admission routes through this lookup, so bucket traffic is
        counted by the compilation cache for real (``cache_stats()``), and
        every new bucket is added to the on-disk manifest for the next
        boot's warm start.

        A bucket whose compile *crashes* is quarantined (negative-cached
        with exponential backoff) and served through the plain-torch prefill
        fallback — same math, same tokens — on the very step the compile
        failed; when the embargo lapses the next admission re-attempts the
        real compile."""
        key = self._prefill_key(bucket)
        entry = self._quarantine.get(key)
        was_expired = entry.expired if entry is not None else None
        if self._quarantine.active(key):
            return self._prefill_fallback(bucket, params)
        if entry is not None and was_expired is False:
            # embargo just lapsed: one retry is permitted below
            self._event("quarantine_expired", bucket=bucket,
                        fail_count=entry.fail_count)
        fn = self._compile_cache.get_memory(key)
        if fn is not None:
            return fn
        t0 = time.perf_counter()
        try:
            faults.check("serve.prefill_compile", bucket=bucket)
            progs = (build_programs(self.cfg, bucket, self._jc)
                     if self.config.use_stripe_decode else None)
            fn = make_prefill_step(self.cfg, progs, self._ps, bucket)
        except Exception as e:  # noqa: BLE001 — any compile crash quarantines
            qe = self._quarantine.record_failure(key, repr(e))
            self._event("quarantine", bucket=bucket, reason=repr(e)[:200],
                        fail_count=qe.fail_count,
                        backoff_s=round(qe.backoff_s, 4))
            return self._prefill_fallback(bucket, params)
        if progs is not None:
            self._records.update(
                {f"prefill_L{bucket}/{k}": v for k, v in progs.records.items()})
            self._note_tuned(f"prefill_L{bucket}", progs.records)
        if entry is not None:
            # post-embargo retry succeeded: the bucket is healthy again
            self._quarantine.clear(key)
            self._event("quarantine_clear", bucket=bucket)
        self._compile_cache.put_memory(key, fn)
        self._compile_log.append({
            "kind": "prefill", "bucket": bucket, "slots": 1, "plen": bucket,
            "first_call_s": time.perf_counter() - t0, "warm_start": warm})
        self._touch_manifest(bucket)
        return fn

    def _prefill_fallback(self, bucket: int, params):
        """Degraded prefill for a quarantined bucket: plain torch, no stripe
        programs, cached under its own key.  Produces the same tokens as
        the stripe path, so a quarantined bucket degrades in *throughput*,
        never in output."""
        fkey = stripe_cache.content_key(
            "serve_prefill_fallback", self._model_fp, self._ps, self._pps, bucket)
        fn = self._compile_cache.get_memory(fkey)
        if fn is not None:
            return fn
        t0 = time.perf_counter()
        fn = make_prefill_step(self.cfg, None, self._ps, bucket)
        self._compile_cache.put_memory(fkey, fn)
        self._compile_log.append({
            "kind": "prefill_fallback", "bucket": bucket,
            "first_call_s": time.perf_counter() - t0})
        return fn

    def _touch_manifest(self, bucket: int) -> None:
        if self._compile_cache.disk_dir is None:
            return
        payload = self._compile_cache.get_disk(self._manifest_key) or {}
        buckets = sorted(set(payload.get("buckets", [])) | {int(bucket)})
        self._compile_cache.put_disk(self._manifest_key, {"buckets": buckets})

    def _warm_start(self, params) -> None:
        """At boot (first serve), replay the on-disk bucket manifest:
        every previously seen prefill bucket compiles now — with stripe
        tilings replayed from the disk cache — instead of stalling the
        first admission that needs it."""
        if self._warmed:
            return
        self._warmed = True
        if self._compile_cache.disk_dir is None:
            return
        payload = self._compile_cache.get_disk(self._manifest_key)
        if not payload:
            return
        buckets = [int(b) for b in payload.get("buckets", [])]
        for b in buckets:
            if b <= self.max_len:
                self._get_prefill(b, params, warm=True)
        self._event("warm_start", buckets=buckets)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._device)

    # ----------------------------------------------------------- admission
    def submit(self, req: Request) -> bool:
        """Enqueue a request.  Validation is synchronous (raises here);
        padding/bucketing happens on the prep thread.

        Returns ``False`` when the bounded queue (``EngineConfig.max_queue``)
        sheds the request instead of admitting it — the request is marked
        ``status == "shed"`` and never enters the engine."""
        req.submit_time = time.perf_counter()
        ttl = (req.sampling.ttl_s if req.sampling.ttl_s is not None
               else self.config.default_ttl_s)
        if ttl is not None:
            req.deadline = req.submit_time + ttl
        plen = int(req.prompt.size)
        if plen > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt length {plen} > max_len {self.max_len}")
        eff = min(req.sampling.max_new_tokens, self.max_len - plen + 1)
        if pages_needed(plen, eff, self._ps) > self._pool.pool_pages:
            raise ValueError(
                f"request {req.uid}: needs more pages than the whole pool "
                f"({self._pool.pool_pages}); raise EngineConfig.pages")
        if self.config.max_queue is not None:
            with self._cond:
                depth = (self._n_submitted - self._n_prepared) + len(self._ready)
            if depth >= self.config.max_queue:
                req.status = "shed"
                req.done = True
                req.finish_time = req.submit_time
                self._shed_reqs.append(req)
                self._event("shed", uid=req.uid, queue_depth=depth)
                return False
        self._next_uid = max(self._next_uid, req.uid + 1)
        self._ensure_prep_thread()
        with self._cond:
            self._n_submitted += 1
        self._event("enqueue", uid=req.uid)
        self._raw.put(req)
        return True

    def _ensure_prep_thread(self) -> None:
        if self._prep_thread is None or not self._prep_thread.is_alive():
            self._prep_thread = threading.Thread(
                target=self._prep_loop, daemon=True, name="serve-prep")
            self._prep_thread.start()

    def _prep_loop(self) -> None:
        item: Any = None
        try:
            while True:
                item = self._raw.get()
                if item is _STOP:
                    return
                try:
                    faults.check("serve.prep", uid=item.uid)
                    with obs_trace.span("serve.prep", uid=item.uid):
                        prep = self._prepare(item)
                except Exception as e:  # noqa: BLE001 — per-item failure:
                    # the request fails, the worker survives
                    with self._cond:
                        self._n_prepared += 1
                        self._fail_prep(item, e)
                        self._cond.notify_all()
                    continue
                # thread-level fault site: simulates the worker dying with
                # a prepared-but-unhanded item in flight
                faults.check("serve.prep_thread", uid=item.uid)
                with self._cond:
                    self._ready.append(prep)
                    self._n_prepared += 1
                    self._cond.notify_all()
        except BaseException as e:
            # dying: hand the exception (and the in-flight request) back to
            # the serving thread under the condition variable so _drain_prep
            # wakes immediately instead of stalling on its timeout; the
            # handoff is the report, so don't also re-raise into the void
            with self._cond:
                self._prep_exc = (item if isinstance(item, Request) else None, e)
                self._cond.notify_all()

    def _fail_prep(self, req: Request, exc: BaseException) -> None:
        """Terminal-fail a request that never made it past prep."""
        req.status = "failed"
        req.error = f"prep failed: {exc!r}"[:300]
        req.done = True
        req.finish_time = time.perf_counter()
        self._finished.append(req)
        self._event("prep_failed", uid=req.uid, error=req.error)

    def _prepare(self, req: Request) -> _Prepared:
        plen = int(req.prompt.size)
        bucket = max(plen, min(_next_pow2(plen), self.max_len))
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = req.prompt
        eff = min(req.sampling.max_new_tokens, self.max_len - plen + 1)
        with self._cond:
            order, self._order = self._order, self._order + 1
        return _Prepared(req=req, order=order, plen=plen, bucket=bucket,
                         tokens=toks, n_pages=pages_needed(plen, eff, self._ps),
                         eff_new=eff)

    def _drain_prep(self) -> None:
        """Barrier: wait until everything submitted so far is prepared.
        Keeps admission deterministic (pure arrival order) while the
        actual padding work overlapped with the previous device steps.

        Supervision: a dying worker notifies the condition variable with
        its exception attached (``self._prep_exc``), so thread death is
        detected immediately — not after a multi-second stall.  The worker
        is restarted and its in-flight request (if any) requeued — prep is
        side-effect-free, so the retry is safe — bounded by
        ``max_retries`` (exhaustion fails the request).  A worker found
        dead *without* a handoff is a fail-fast error."""
        with self._cond:
            while self._n_prepared < self._n_submitted:
                if self._prep_exc is not None:
                    item, exc = self._prep_exc
                    self._prep_exc = None
                    self._prep_restarts += 1
                    ev = {"restarts": self._prep_restarts,
                          "error": repr(exc)[:200]}
                    if item is not None:
                        item.retries += 1
                        self._retries_total += 1
                        if item.retries > self.config.max_retries:
                            self._n_prepared += 1
                            self._fail_prep(item, exc)
                            ev["failed_uid"] = item.uid
                        else:
                            # nothing happened to the request yet: retry it
                            # through the restarted worker
                            self._raw.put(item)
                            ev["requeued_uid"] = item.uid
                    self._event("prep_thread_restart", **ev)
                    self._prep_thread = None
                    self._ensure_prep_thread()
                    continue
                if not self._cond.wait(timeout=0.25):
                    if self._prep_exc is not None:
                        continue
                    if self._prep_thread is None or not self._prep_thread.is_alive():
                        raise RuntimeError(
                            "serving prep thread died without handing back its "
                            f"work ({self._n_submitted - self._n_prepared} "
                            "request(s) pending)")

    def close(self) -> None:
        """Stop the prep thread (idempotent; the engine stays usable —
        a later submit() restarts it)."""
        if self._prep_thread is not None and self._prep_thread.is_alive():
            self._raw.put(_STOP)
            self._prep_thread.join(timeout=5.0)
        self._prep_thread = None

    def _pick_candidate(self) -> Optional[int]:
        """Index into ``self._ready`` of the next request to admit, or
        None if nothing admissible (fcfs: strict head-of-line; sjf:
        shortest total job among prepared requests that fits)."""
        if not self._ready:
            return None
        if self.config.admission == "fcfs":
            return 0 if self._pool.can_alloc(self._ready[0].n_pages) else None
        best: Optional[Tuple[Tuple[int, int], int]] = None
        for i, p in enumerate(self._ready):
            if not self._pool.can_alloc(p.n_pages):
                continue
            k = (p.plen + p.eff_new, p.order)
            if best is None or k < best[0]:
                best = (k, i)
        return None if best is None else best[1]

    def _expire_queued(self) -> None:
        """Drop queued requests whose deadline passed — they never occupy
        a slot; whatever tokens they have (none, pre-admission) stand."""
        now = time.perf_counter()
        with self._cond:
            expired = [p for p in self._ready
                       if p.req.deadline and now > p.req.deadline]
            for p in expired:
                self._ready.remove(p)
        for p in expired:
            self._finish_terminal(p.req, "deadline_exceeded", where="queued")

    def _expire_slots(self) -> None:
        """Evict live requests whose deadline passed mid-decode; their
        partial output stands, the slot and pages recycle immediately."""
        now = time.perf_counter()
        for s in range(self.slots):
            r = self._slot_req[s]
            if r is not None and r.deadline and now > r.deadline:
                self._release_slot(s)
                self._finish_terminal(r, "deadline_exceeded", where="slot")

    def _finish_terminal(self, r: Request, status: str, *, where: str = "",
                         error: str = "") -> None:
        """Move a request to a non-ok terminal state."""
        r.status = status
        if error:
            r.error = error
        r.done = True
        r.finish_time = time.perf_counter()
        self._finished.append(r)
        self._finish_obs(r)
        ev = {"uid": r.uid, "tokens": len(r.out_tokens)}
        if where:
            ev["where"] = where
        if error:
            ev["error"] = error[:200]
        self._event(status, **ev)

    def _surface_cache_errors(self) -> None:
        """Turn disk-cache corruption the CompilationCache absorbed (torn
        or unreadable entries treated as misses) into engine events so
        every injected cache fault has a visible recovery record."""
        errs = int(self._disk_err_ctr.value)
        if errs > self._disk_errors_seen:
            self._event("cache_corruption_recovered",
                        count=errs - self._disk_errors_seen)
            self._disk_errors_seen = errs

    def _admit(self, params) -> List[Tuple[int, int]]:
        """Fill free slots from the prepared queue; returns the
        (uid, first_token) pairs emitted by the prefills (a retried
        request's replayed first token is verified, not re-emitted)."""
        emitted: List[Tuple[int, int]] = []
        self._drain_prep()
        self._expire_queued()
        self._surface_cache_errors()
        while self._free_slots:
            with self._cond:
                idx = self._pick_candidate()
                if idx is None:
                    break
                prep = self._ready[idx]
                del self._ready[idx]
            pages = self._pool.alloc(prep.n_pages)
            if pages is None:
                # allocation failed after can_alloc said yes (injected fault
                # or a raced pool): defer, don't crash — the request goes
                # back to the queue head and retries next admission phase
                with self._cond:
                    self._ready.appendleft(prep)
                self._event("alloc_failed", uid=prep.req.uid,
                            pages=prep.n_pages,
                            free_pages=self._pool.free_pages)
                break
            slot = self._free_slots.pop(0)
            r = prep.req
            r.slot = slot
            # queue wait closes at admission: stamped retroactively from
            # the submit-side timestamp (submit and admission run on
            # different threads, so this cannot be a ``with`` block)
            now = time.perf_counter()
            self._h_queue.observe(now - r.submit_time)
            obs_trace.span_at("serve.queue", r.submit_time, now, uid=r.uid)
            row = np.full(self._pps, self._garbage[slot], np.int32)
            row[: len(pages)] = pages
            self._page_table[slot] = row
            self._slot_pages[slot] = pages
            self._slot_req[slot] = r
            self._slot_eff[slot] = prep.eff_new
            with obs_trace.span("serve.prefill", uid=r.uid,
                                bucket=prep.bucket, slot=slot):
                t_pf = time.perf_counter()
                fn = self._get_prefill(prep.bucket, params)
                tok, self._pk, self._pv = fn(
                    params, self._tensor(prep.tokens), prep.plen,
                    self._tensor(row), self._pk, self._pv)
                first = int(tok)
            self._h_prefill.observe(time.perf_counter() - t_pf)
            self._pos[slot] = prep.plen
            self._last[slot] = first
            replay = r.replay_len
            if replay > 0:
                # retried incarnation: the prefill token was already emitted
                # before the failure — verify, don't re-emit (exactly-once)
                if first != r.out_tokens[0]:
                    raise RuntimeError(
                        f"exactly-once violated on retry of request {r.uid}: "
                        f"replayed prefill token {first} != recorded "
                        f"{r.out_tokens[0]}")
                self._slot_emitted[slot] = 1
                self._slot_replay[slot] = replay
                self._event("admit", uid=r.uid, slot=slot, bucket=prep.bucket,
                            retry=r.retries, replay=replay,
                            queue_depth=len(self._ready))
            else:
                r.first_token_time = time.perf_counter()
                r.out_tokens.append(first)
                self._tokens_out += 1
                self._slot_emitted[slot] = 1
                self._slot_replay[slot] = 0
                self._event("admit", uid=r.uid, slot=slot, bucket=prep.bucket,
                            queue_depth=len(self._ready))
                emitted.append((r.uid, first))
                if first == r.sampling.eos_id or len(r.out_tokens) >= prep.eff_new:
                    self._evict(slot)
        return emitted

    def _release_slot(self, slot: int) -> None:
        """Return a slot's pages to the pool and reset its decode state;
        says nothing about the request's fate (callers finish or requeue)."""
        self._pool.release(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._slot_req[slot] = None
        self._page_table[slot] = self._garbage[slot]
        self._pos[slot] = 0
        self._last[slot] = 0
        self._slot_eff[slot] = 0
        self._slot_emitted[slot] = 0
        self._slot_replay[slot] = 0
        self._free_slots.append(slot)
        self._free_slots.sort()

    def _evict(self, slot: int) -> None:
        r = self._slot_req[slot]
        r.done = True
        r.finish_time = time.perf_counter()
        self._release_slot(slot)
        self._finished.append(r)
        self._finish_obs(r)
        self._event("finish", uid=r.uid, slot=slot,
                    queue_depth=len(self._ready),
                    free_pages=self._pool.free_pages)

    def _on_step_failure(self, live: List[int], exc: BaseException) -> None:
        """Crash-safe decode recovery: release only the affected slots and
        requeue their requests (front of queue, bounded by ``max_retries``);
        healthy slots are untouched and simply redo the step.  Nothing was
        committed for the failed step — KV pages, positions and output all
        update only after a successful step — so the retried incarnation
        replays deterministically from its prefill."""
        payload = getattr(exc, "payload", None) or {}
        affected = payload.get("slots")
        affected = [s for s in (live if affected is None else affected)
                    if 0 <= s < self.slots and self._slot_req[s] is not None]
        self._event("device_step_failed", slots=list(affected),
                    error=repr(exc)[:200])
        for s in affected:
            r = self._slot_req[s]
            self._release_slot(s)
            r.retries += 1
            self._retries_total += 1
            if r.retries > self.config.max_retries:
                self._finish_terminal(
                    r, "failed",
                    error=f"retries exhausted after device-step failure: {exc!r}")
                self._event("retry_exhausted", uid=r.uid, retries=r.retries)
                continue
            r.replay_len = len(r.out_tokens)
            r.slot = -1
            prep = self._prepare(r)
            with self._cond:
                self._ready.appendleft(prep)
            self._event("requeue", uid=r.uid, retries=r.retries,
                        replay=r.replay_len)

    # ----------------------------------------------------------- the loop
    def _serve(self, params, max_steps: int) -> Iterator[Tuple[int, int]]:
        """The core loop, as a generator of (uid, token).  ``max_steps``
        bounds *decode steps* (legacy semantics)."""
        if params is None:
            raise ValueError("no params: pass params= to run()/generate() "
                             "or construct the engine with params=")
        if params["embed"].device.type != self._device.type:
            raise ValueError(f"params are on {params['embed'].device}, the engine "
                             f"serves on {self._device}")
        self._warm_start(params)
        steps = 0
        stall = 0
        while steps < max_steps:
            for out in self._admit(params):
                yield out
            self._expire_slots()
            live = [s for s in range(self.slots) if self._slot_req[s] is not None]
            if not live:
                with self._cond:
                    pending = bool(self._ready) or self._n_prepared < self._n_submitted
                if not pending:
                    break
                # nothing live but work queued: admission normally succeeds
                # next pass (submit() guarantees every request fits an empty
                # pool), but injected allocation faults can starve it — spin
                # with a tiny sleep and fail fast rather than hang forever
                stall += 1
                if stall > 20_000:
                    raise RuntimeError(
                        "admission stalled: queued work cannot be admitted "
                        f"(free_pages={self._pool.free_pages})")
                if stall > 1:
                    time.sleep(0.0002)
                continue
            stall = 0
            t0 = time.perf_counter()
            try:
                faults.check("serve.decode_step",
                             step=self._steps, n_live=len(live))
                with obs_trace.span("serve.decode_step", step=self._steps,
                                    n_live=len(live)):
                    nxt, pk, pv = self._decode_fn(
                        params, self._pk, self._pv,
                        self._tensor(self._page_table), self._tensor(self._pos),
                        self._tensor(self._last))
                    nxt = nxt.cpu().numpy()
            except Exception as e:  # noqa: BLE001 — device-step crash:
                # nothing was committed (pages/pos/output update below, only
                # on success); recover the affected slots and carry on
                self._on_step_failure(live, e)
                continue
            self._pk, self._pv = pk, pv
            self._h_decode.observe(time.perf_counter() - t0)
            steps += 1
            self._steps += 1
            self._live_steps += len(live)
            if not self._decode_warm:
                self._decode_warm = True
                self._compile_log.append({
                    "kind": "decode", "slots": self.slots,
                    "kv_window": self._kv_window,
                    "first_call_s": time.perf_counter() - t0})
            for s in live:
                r = self._slot_req[s]
                tok = int(nxt[s])
                self._pos[s] += 1
                self._last[s] = tok
                idx = int(self._slot_emitted[s])
                self._slot_emitted[s] = idx + 1
                if idx < self._slot_replay[s]:
                    # replaying pre-failure output on a retried request:
                    # greedy decode is deterministic, so the regenerated
                    # token must equal the recorded one — verify, suppress
                    if tok != r.out_tokens[idx]:
                        raise RuntimeError(
                            f"exactly-once violated on retry of request "
                            f"{r.uid}: replayed token {tok} at index {idx} "
                            f"!= recorded {r.out_tokens[idx]}")
                    continue
                r.out_tokens.append(tok)
                self._tokens_out += 1
                yield (r.uid, tok)
                if tok == r.sampling.eos_id or len(r.out_tokens) >= self._slot_eff[s]:
                    self._evict(s)

    def run(self, params=None, max_steps: int = 256) -> List[Request]:
        """Serve until the queue drains (or ``max_steps`` decode steps);
        returns the requests that finished during this call."""
        params = params if params is not None else self._params
        start = len(self._finished)
        for _ in self._serve(params, max_steps):
            pass
        return self._finished[start:]

    def generate(self, prompts: Iterable[Any], *, params=None,
                 sampling: Optional[SamplingParams] = None,
                 max_steps: int = 100_000) -> Iterator[Tuple[int, int]]:
        """Streaming API: submit ``prompts`` (token-id sequences) and
        return an iterator of (uid, token) pairs in emission order.
        Uids are assigned in prompt order starting from the engine's
        running counter; tokens include each request's prefill token."""
        params = params if params is not None else self._params
        for pr in prompts:
            sp = (dataclasses.replace(sampling) if sampling is not None
                  else SamplingParams())
            uid = self._next_uid
            self.submit(Request(uid=uid, prompt=np.asarray(pr, np.int32),
                                sampling=sp))
        return self._serve(params, max_steps)

    # ------------------------------------------------------- introspection
    def cache_stats(self) -> stripe_cache.CacheStats:
        """True hit/miss traffic over compile-bucket and stripe-program
        lookups (every admission does a real keyed cache lookup)."""
        return self._compile_cache.stats

    def compile_log(self) -> List[Dict[str, Any]]:
        """One record per cold compile: prefill buckets, decode program
        build, first decode call."""
        return list(self._compile_log)

    def compile_records(self) -> Dict[str, CompileRecord]:
        """Stripe ``CompileRecord`` per compiled block program (fusion
        groups, kernel counts, per-block backends and fallbacks), keyed
        ``decode/<block>`` and ``prefill_L<bucket>/<block>``."""
        return dict(self._records)

    def events(self) -> List[Dict[str, Any]]:
        """Admission/eviction/fault-recovery event log (used by tests and
        benches for slot-reuse, utilization and resilience accounting)."""
        return list(self._events)

    def shed(self) -> List[Request]:
        """Requests rejected by the bounded queue (``status == "shed"``);
        they never entered the engine and are not in ``run()``'s result."""
        return list(self._shed_reqs)

    def quarantine_entries(self) -> Dict[str, Dict[str, Any]]:
        """Active + historical compile-quarantine entries keyed by the
        prefill cache key (see ``QuarantineStore``)."""
        return {k: e.as_dict() for k, e in self._quarantine.entries().items()}

    def metrics(self) -> Dict[str, Any]:
        """Engine health summary (legacy dict shape, plus
        ``dropped_events`` — events lost to the bounded ring buffer)."""
        self._sync_registry()
        steps = max(self._steps, 1)
        by_status: Dict[str, int] = {}
        for r in self._finished:
            by_status[r.status] = by_status.get(r.status, 0) + 1
        return {
            "decode_steps": self._steps,
            "tokens_out": self._tokens_out,
            "finished": len(self._finished),
            "finished_by_status": by_status,
            "shed": len(self._shed_reqs),
            "retries": self._retries_total,
            "prep_restarts": self._prep_restarts,
            "quarantined": sum(1 for e in self._quarantine.entries().values()
                               if not e.expired),
            "slot_utilization": self._live_steps / (steps * self.slots),
            "free_pages": self._pool.free_pages,
            "queue_depth": len(self._ready),
            "dropped_events": self._dropped_events,
        }

    def _sync_registry(self) -> None:
        """Fold the plain-int hot-path counters into the obs registry so a
        snapshot reflects current state.  Hot paths deliberately bump bare
        ints; this reconciles them lazily at observation time."""
        reg = self._obs
        steps = max(self._steps, 1)
        reg.counter("serve.decode_steps").set(self._steps)
        reg.counter("serve.tokens_out").set(self._tokens_out)
        reg.counter("serve.retries").set(self._retries_total)
        reg.counter("serve.prep_restarts").set(self._prep_restarts)
        reg.counter("serve.shed").set(len(self._shed_reqs))
        by_status: Dict[str, int] = {}
        for r in self._finished:
            by_status[r.status] = by_status.get(r.status, 0) + 1
        for status, n in by_status.items():
            reg.counter("serve.finished", status=status).set(n)
        reg.gauge("serve.slot_utilization").set(
            self._live_steps / (steps * self.slots))
        reg.gauge("serve.free_pages").set(self._pool.free_pages)
        reg.gauge("serve.queue_depth").set(len(self._ready))
        reg.gauge("serve.dropped_events").set(self._dropped_events)

    def metrics_registry(self) -> obs_metrics.Registry:
        """The engine's private metrics registry (counters per event type,
        latency histograms ``serve.{queue_wait,prefill,decode_step,request}_s``)."""
        self._sync_registry()
        return self._obs

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Deterministic snapshot of the engine registry: event counters,
        gauges, and the four latency histograms."""
        self._sync_registry()
        return self._obs.snapshot()
