"""Reliability: deterministic fault injection + the serving resilience
vocabulary shared by the engine, the compile driver, the cache, and the
training loop."""
from . import faults
from .faults import (FaultPlan, FaultRule, InjectedFault, fail_every,
                     fail_nth, fail_prob, fail_when, inject)

__all__ = ["faults", "FaultPlan", "FaultRule", "InjectedFault", "inject",
           "fail_nth", "fail_every", "fail_prob", "fail_when"]
