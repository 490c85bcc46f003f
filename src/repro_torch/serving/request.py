"""Serving request/config schema — the stable public contract.

``SamplingParams`` describes *how* to decode one request, ``EngineConfig``
describes the engine (slot count, paged-KV geometry, admission policy,
stripe backend), and ``Request`` carries one sequence through the engine.

``Request`` still accepts the pre-redesign flat fields
(``max_new_tokens=``, ``eos_id=``) as a thin deprecation shim — they are
folded into ``sampling`` at construction, so old call sites keep working
unchanged while new code passes ``SamplingParams`` explicitly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SamplingParams:
    """Per-request decode parameters.

    * ``max_new_tokens`` — tokens to generate, *including* the token
      emitted by the prefill step (the engine stops a sequence as soon as
      ``len(out_tokens) == max_new_tokens``).
    * ``eos_id`` — stop token; ``-1`` disables early stop.
    * ``temperature`` — placeholder for future stochastic sampling; only
      ``0.0`` (greedy argmax) is implemented, and the engine raises on
      anything else rather than silently ignoring it.
    * ``ttl_s`` — per-request deadline: seconds after submit by which the
      request must *finish*.  An expired request is evicted (or never
      admitted) with ``status == "deadline_exceeded"`` and whatever tokens
      it produced; ``None`` falls back to ``EngineConfig.default_ttl_s``
      (no deadline when that is also ``None``).
    """

    max_new_tokens: int = 16
    eos_id: int = -1
    temperature: float = 0.0
    ttl_s: Optional[float] = None

    def validate(self) -> None:
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.temperature != 0.0:
            raise NotImplementedError(
                "only greedy decoding (temperature=0.0) is implemented")
        if self.ttl_s is not None and self.ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {self.ttl_s}")


@dataclasses.dataclass
class EngineConfig:
    """Continuous-batching engine configuration.

    * ``slots`` — decode batch width; every decode step runs all slots.
    * ``max_len`` — maximum total sequence length (prompt + generated).
    * ``page_size`` — tokens per KV page; the logical KV window of one
      slot is ``ceil(max_len / page_size)`` pages.
    * ``pages`` — size of the shared physical page pool.  ``None`` sizes
      it at ``slots * ceil(max_len / page_size)`` (admission never blocks
      on pages); smaller pools create real paging pressure and may delay
      admission until evictions recycle pages.
    * ``admission`` — queue policy: ``"fcfs"`` (strict arrival order;
      head-of-line blocks when it doesn't fit) or ``"sjf"`` (shortest
      remaining job first among the prepared requests).
    * ``device`` — where the KV pages live and the steps run: ``"cuda"``
      by default (entry points run on the card unless the caller asks for
      the CPU; with no card, ``"cuda"`` raises instead of falling back).
    * ``backend`` / ``hw`` — the ``stripe_jit`` backend and hardware
      config name used to compile the decode-time attention/MLP blocks.
      The default ``"cuda"`` is the twin of the JAX package's ``"pallas"``:
      it is the kernel path, one hand-written CUDA kernel launch per fusion
      group (on CPU tensors the kernel's plain version runs).  ``"torch"``
      is the twin of ``"jnp"`` (plain PyTorch), ``"reference"`` the numpy
      interpreter.  ``hw="h100"`` is the card's config.
    * ``use_stripe_decode`` — route decode blocks through ``stripe_jit``
      (the default); ``False`` uses plain torch ops (same math, no compile
      records) for A/B measurement.
    * ``use_disk_cache`` — let the engine's compilation cache persist
      tilings + the bucket manifest to disk so the next boot warm-starts.
    * ``max_queue`` — bounded admission queue: when more than this many
      requests are pending (submitted but not yet admitted), ``submit()``
      sheds the request (returns ``False``, ``status == "shed"``, a
      ``shed`` event) instead of growing the queue without bound.
      ``None`` keeps the queue unbounded.
    * ``default_ttl_s`` — engine-wide deadline applied to requests whose
      ``SamplingParams.ttl_s`` is ``None``.
    * ``max_retries`` — how many times a request evicted by a device-step
      failure is requeued before it is failed (``retry_exhausted``).
    * ``quarantine_backoff_s`` — base backoff of the compile-failure
      quarantine (doubles per consecutive failure).
    * ``event_log_size`` — ring-buffer capacity of the engine event log;
      beyond it the oldest events drop (counted in the
      ``serve.dropped_events`` metric).  ``0`` keeps the log unbounded.
    * ``profile`` — compile the decode-time Stripe programs with
      ``stripe_jit(..., profile=True)``: per-unit measured latencies
      attach to each ``CompileRecord`` and (predicted, measured) rows
      land in the cost-model residual log.
    * ``tune`` — consult (and, with ``profile``, populate) the measured
      tuning DB next to the engine's compilation cache: bucket compiles
      go through ``stripe_jit(..., tune=..., device=device)``, so a
      workload measured by the explore sweep or a previous profiled run
      on the same device replays its measured-best tiling (a
      ``tuned_replay`` engine event; hit/miss counts in
      ``cache_stats()``).
    """

    slots: int = 8
    max_len: int = 256
    page_size: int = 16
    pages: Optional[int] = None
    admission: str = "fcfs"
    device: str = "cuda"
    backend: str = "cuda"
    hw: str = "h100"
    use_stripe_decode: bool = True
    use_disk_cache: bool = False
    max_queue: Optional[int] = None
    default_ttl_s: Optional[float] = None
    max_retries: int = 2
    quarantine_backoff_s: float = 0.25
    event_log_size: int = 10_000
    profile: bool = False
    tune: bool = False

    def validate(self) -> None:
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {self.max_len}")
        if self.backend not in ("cuda", "torch", "reference"):
            raise ValueError(f"unknown backend {self.backend!r}; "
                             "expected 'cuda', 'torch' or 'reference'")
        if self.admission not in ("fcfs", "sjf"):
            raise ValueError(f"unknown admission policy {self.admission!r}; "
                             "expected 'fcfs' or 'sjf'")
        if self.pages is not None and self.pages < self.pages_per_slot:
            raise ValueError(
                f"pages={self.pages} cannot hold even one full sequence "
                f"({self.pages_per_slot} pages)")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.default_ttl_s is not None and self.default_ttl_s <= 0:
            raise ValueError(f"default_ttl_s must be > 0, got {self.default_ttl_s}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.quarantine_backoff_s <= 0:
            raise ValueError(
                f"quarantine_backoff_s must be > 0, got {self.quarantine_backoff_s}")
        if self.event_log_size < 0:
            raise ValueError(
                f"event_log_size must be >= 0, got {self.event_log_size}")

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_len // self.page_size)

    @property
    def pool_pages(self) -> int:
        return (self.pages if self.pages is not None
                else self.slots * self.pages_per_slot)


@dataclasses.dataclass
class Request:
    """One sequence moving through the engine.

    Preferred construction is ``Request(uid, prompt, sampling=SamplingParams(...))``.
    The flat ``max_new_tokens`` / ``eos_id`` fields are a deprecation shim
    for the pre-``SamplingParams`` API; when ``sampling`` is not given they
    are folded into one.  ``out_tokens`` includes the token produced by the
    prefill step.
    """

    uid: int
    prompt: np.ndarray  # (plen,) int32
    max_new_tokens: int = 16       # deprecated: use sampling=
    eos_id: int = -1               # deprecated: use sampling=
    sampling: Optional[SamplingParams] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # terminal outcome: "ok" (finished normally), "shed" (rejected by the
    # bounded queue), "deadline_exceeded" (TTL expired queued or mid-
    # decode), "failed" (prep error / retries exhausted)
    status: str = "ok"
    retries: int = 0
    error: str = ""
    # engine-filled timing/placement (seconds on time.perf_counter's clock)
    submit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    deadline: float = 0.0  # absolute finish-by time; 0.0 = no deadline
    slot: int = -1
    # crash-safe retry bookkeeping: tokens already emitted to the caller
    # before the failure; the retried incarnation regenerates and verifies
    # them (greedy decode is deterministic) without re-emitting
    replay_len: int = 0

    def __post_init__(self) -> None:
        if self.sampling is None:
            self.sampling = SamplingParams(max_new_tokens=self.max_new_tokens,
                                           eos_id=self.eos_id)
        else:
            # keep the legacy mirror fields consistent for old readers
            self.max_new_tokens = self.sampling.max_new_tokens
            self.eos_id = self.sampling.eos_id
        self.sampling.validate()
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.uid}: empty prompt")

    @property
    def latency(self) -> float:
        return self.finish_time - self.submit_time
