"""Deterministic, seedable fault injection for the serving/compile stack.

Failures in this repo originate at a small number of places — the disk
cache, a ``stripe_jit`` compile, a per-bucket prefill compile, the decode
device step, the serving prep thread, page allocation, a train step.
Each of those places is a **named injection site**: production code calls
:func:`check` (or :func:`fires`) with the site name and a little context,
which is a no-op unless a :class:`FaultPlan` is installed.  Tests and
benchmarks script failure sequences by installing plans through the
:func:`inject` context manager:

    with faults.inject(faults.fail_nth("serve.decode_step", 3)) as plan:
        engine.run(params)
    assert plan.fired()          # what fired, in order, with context

Triggers compose (AND semantics within one rule): fail the Nth hit
(``nth=``), every K-th hit (``every=``), with probability ``p`` under a
seed (``prob=``/``seed=`` — the random stream is owned by the rule, so
the same plan over the same hit sequence fires identically every run),
under a context predicate (``when=``), and at most ``times`` total.

Two call styles at a site:

* :func:`check` **raises** :class:`InjectedFault` when a rule fires — for
  sites whose real failure mode is an exception (compile, device step).
* :func:`fires` **returns True** when a rule fires — for sites where the
  caller simulates a specific corruption instead of raising (e.g. the
  cache tearing a disk write).

Plans are process-global (a lock-guarded stack, *not* thread-local) so
that faults scripted by a test thread are observed by the engine's prep
thread and by pool workers in the same process.

``repro_torch.train.loop.FaultInjector`` is a thin compat shim over
:class:`FaultPlan`; training and serving share this one vocabulary.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import random
import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = ["SITES", "InjectedFault", "FaultRule", "FaultPlan", "inject",
           "check", "fires", "active_plans", "fail_nth", "fail_every",
           "fail_prob", "fail_when"]

# Registered injection sites: where failures actually originate.  check()
# rejects unknown site names so a typo'd site can never silently never
# fire; rules may use fnmatch patterns (e.g. "serve.*") over these names.
SITES: Dict[str, str] = {
    "cache.disk_read": "CompilationCache.get_disk: the entry read raises (I/O error)",
    "cache.disk_write": "CompilationCache.put_disk: the write raises; entry is lost",
    "cache.disk_write_torn": "CompilationCache.put_disk: a torn (truncated) entry "
                             "lands on disk, as a non-atomic writer would leave",
    "compile.stripe_jit": "driver._lower: the Pallas lowering of a stripe_jit "
                          "compile raises (quarantined by the driver)",
    "compile.stripe_jit_mesh": "driver._stripe_jit_mesh: shard planning raises "
                               "(the compile falls back to one device, reason recorded)",
    "serve.prefill_compile": "ServingEngine._get_prefill: building a prompt "
                             "bucket's compiled step raises (bucket quarantined)",
    "serve.decode_step": "ServingEngine._serve: the jitted decode step raises "
                         "(affected slots evicted + requeued)",
    "serve.prep": "ServingEngine._prep_loop: preparing one request raises "
                  "(that request fails; the thread survives)",
    "serve.prep_thread": "ServingEngine._prep_loop: the prep thread itself dies "
                         "(supervisor restarts it; in-flight request fails)",
    "paged.alloc": "PagePool.alloc: page allocation fails transiently "
                   "(admission retries later instead of crashing)",
    "train.step": "Trainer.run: a train step raises (simulated preemption)",
}


class InjectedFault(RuntimeError):
    """Raised by :func:`check` when a rule fires.  Subclasses
    ``RuntimeError`` so pre-framework handlers (``run_with_restarts``)
    keep working.  ``payload`` carries rule-scripted data the recovery
    path may consult (e.g. which slots a device fault affected)."""

    def __init__(self, site: str, ctx: Optional[Dict[str, Any]] = None,
                 payload: Optional[Dict[str, Any]] = None):
        super().__init__(f"injected fault at {site}")
        self.site = site
        self.ctx = dict(ctx or {})
        self.payload = dict(payload or {})


@dataclasses.dataclass
class FaultRule:
    """One scheduled trigger on one site (or fnmatch site pattern).

    All provided conditions must hold for a hit to fire; a rule with no
    conditions fires on every hit (bounded by ``times``).  ``nth`` is
    1-based over the rule's own hit count.
    """

    site: str
    nth: Optional[int] = None
    every: Optional[int] = None
    prob: Optional[float] = None
    seed: int = 0
    times: Optional[int] = 1
    when: Optional[Callable[[Dict[str, Any]], bool]] = None
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)
    hits: int = 0
    fired: int = 0

    def __post_init__(self) -> None:
        if not any(ch in self.site for ch in "*?[") and self.site not in SITES:
            raise KeyError(f"unknown injection site {self.site!r}; known sites: "
                           f"{sorted(SITES)}")
        if self.prob is not None and not (0.0 <= self.prob <= 1.0):
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        # The rule owns its random stream: deterministic under (seed, site)
        # regardless of what other rules/sites consume.
        self._rng = random.Random(f"{self.seed}:{self.site}")

    def matches(self, site: str) -> bool:
        return fnmatch.fnmatchcase(site, self.site)

    def should_fire(self, ctx: Dict[str, Any]) -> bool:
        """Advance this rule's hit counter and decide.  Callers hold the
        plan lock; the rule itself is not separately synchronized."""
        self.hits += 1
        # the probability stream advances on every hit, fired or not, so
        # later conditions cannot perturb it
        draw = self._rng.random() if self.prob is not None else None
        if self.times is not None and self.fired >= self.times:
            return False
        if self.nth is not None and self.hits != self.nth:
            return False
        if self.every is not None and self.hits % self.every != 0:
            return False
        if draw is not None and draw >= self.prob:
            return False
        if self.when is not None and not self.when(ctx):
            return False
        self.fired += 1
        return True


def fail_nth(site: str, nth: int, **kw: Any) -> FaultRule:
    """Fire on exactly the ``nth`` (1-based) hit of ``site``."""
    return FaultRule(site, nth=nth, **kw)


def fail_every(site: str, every: int, times: Optional[int] = None, **kw: Any) -> FaultRule:
    """Fire on every ``every``-th hit (unbounded unless ``times`` given)."""
    return FaultRule(site, every=every, times=times, **kw)


def fail_prob(site: str, prob: float, seed: int = 0,
              times: Optional[int] = None, **kw: Any) -> FaultRule:
    """Fire each hit with probability ``prob``, deterministically under
    ``seed`` (same plan + same hit order = same firings)."""
    return FaultRule(site, prob=prob, seed=seed, times=times, **kw)


def fail_when(site: str, when: Callable[[Dict[str, Any]], bool], **kw: Any) -> FaultRule:
    """Fire when ``when(ctx)`` is true for the hit's context."""
    return FaultRule(site, when=when, **kw)


class FaultPlan:
    """A set of rules plus the log of everything that fired.

    Thread-safe: the engine hits sites from the serve thread, the prep
    thread, and (for cache sites) pool workers concurrently.
    """

    def __init__(self, rules: Optional[List[FaultRule]] = None):
        self.rules: List[FaultRule] = list(rules or [])
        self._log: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def add(self, rule: FaultRule) -> "FaultPlan":
        with self._lock:
            self.rules.append(rule)
        return self

    def _decide(self, site: str, ctx: Dict[str, Any]) -> Optional[FaultRule]:
        with self._lock:
            for rule in self.rules:
                if rule.matches(site) and rule.should_fire(ctx):
                    self._log.append({
                        "seq": len(self._log), "site": site,
                        "ctx": {k: v for k, v in ctx.items()
                                if isinstance(v, (str, int, float, bool))},
                        "hit": rule.hits})
                    return rule
        return None

    def hit(self, site: str, **ctx: Any) -> None:
        """Raise :class:`InjectedFault` if any rule fires for this hit."""
        rule = self._decide(site, ctx)
        if rule is not None:
            raise InjectedFault(site, ctx, rule.payload)

    def query(self, site: str, **ctx: Any) -> bool:
        """Non-raising form of :meth:`hit` (for simulated-corruption sites)."""
        return self._decide(site, ctx) is not None

    def fired(self) -> List[Dict[str, Any]]:
        """Everything that fired, in order: {seq, site, ctx, hit}."""
        with self._lock:
            return [dict(e) for e in self._log]

    def fired_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for e in self.fired():
            counts[e["site"]] = counts.get(e["site"], 0) + 1
        return counts


# ------------------------------------------------------------- global stack
_ACTIVE: List[FaultPlan] = []
_STACK_LOCK = threading.Lock()


def active_plans() -> List[FaultPlan]:
    with _STACK_LOCK:
        return list(_ACTIVE)


@contextmanager
def inject(*rules_or_plan: Any) -> Iterator[FaultPlan]:
    """Install a plan (or build one from rules) for the dynamic extent of
    the ``with`` block.  Nested injections stack; every active plan sees
    every hit."""
    if len(rules_or_plan) == 1 and isinstance(rules_or_plan[0], FaultPlan):
        plan = rules_or_plan[0]
    else:
        plan = FaultPlan([r for r in rules_or_plan])
    with _STACK_LOCK:
        _ACTIVE.append(plan)
    try:
        yield plan
    finally:
        with _STACK_LOCK:
            _ACTIVE.remove(plan)


def check(site: str, **ctx: Any) -> None:
    """Injection-site hook (raising style).  No-op without active plans;
    with plans, unknown sites are rejected and each plan may raise."""
    plans = active_plans()
    if not plans:
        return
    if site not in SITES:
        raise KeyError(f"check() on unregistered site {site!r}")
    for plan in plans:
        plan.hit(site, **ctx)


def fires(site: str, **ctx: Any) -> bool:
    """Injection-site hook (querying style): True when any active plan's
    rule fires, without raising."""
    plans = active_plans()
    if not plans:
        return False
    if site not in SITES:
        raise KeyError(f"fires() on unregistered site {site!r}")
    return any(plan.query(site, **ctx) for plan in plans)
