"""Optimization pass framework (paper §1.3: "selects and parameterizes a
list of optimization passes from a common pool; these passes are then
iteratively applied to the IR").

Passes are generic and hardware-agnostic; the hardware config selects and
parameterizes them.  Each pass maps Program -> Program.

The pass manager threads two compilation-cache hooks through the pipeline
(both injected into pass params under private ``_``-prefixed keys, which
are never part of a pass's own parameterization):

* a ``TilingOracle`` that records the autotiler's chosen tilings on a cold
  compile and replays them on a warm one, skipping the search entirely;
* an ``autotune_workers`` override enabling the parallel candidate search.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple

from ...obs import trace as obs_trace
from ..hwconfig import HardwareConfig
from ..ir import Program

PassFn = Callable[[Program, HardwareConfig, Mapping], Program]

_REGISTRY: Dict[str, PassFn] = {}


def register(name: str):
    def deco(fn: PassFn) -> PassFn:
        _REGISTRY[name] = fn
        return fn
    return deco


def get_pass(name: str) -> PassFn:
    if name not in _REGISTRY:
        from . import autotile, boundary, fuse, localize, partition, schedule, stencil, transpose  # noqa: F401
    return _REGISTRY[name]


class TilingOracle:
    """Record/replay store for autotile decisions, keyed by block name +
    content fingerprint (``autotile._oracle_key``) so a fused group's
    tiling replays for exactly the group it was chosen for.

    Cold compile: every searched tiling is recorded into ``chosen``.
    Warm compile: construct with ``known`` (e.g. loaded from the on-disk
    cache) and the autotile pass replays those tilings instead of
    searching, re-evaluating only the (cheap) cost of the known choice.
    """

    def __init__(self, known: Optional[Mapping[str, Mapping[str, int]]] = None):
        self.known: Dict[str, Dict[str, int]] = {
            name: {v: int(t) for v, t in tiles.items()}
            for name, tiles in (known or {}).items()
        }
        self.chosen: Dict[str, Dict[str, int]] = {}
        self.replays = 0
        self.searches = 0

    def lookup(self, block_name: str) -> Optional[Dict[str, int]]:
        return self.known.get(block_name)

    def record(self, block_name: str, tiles: Mapping[str, int]) -> None:
        self.chosen[block_name] = dict(tiles)


class PassManager:
    def __init__(self, hw: HardwareConfig, oracle: Optional[TilingOracle] = None,
                 autotune_workers: Optional[int] = None):
        self.hw = hw
        self.oracle = oracle
        self.autotune_workers = autotune_workers
        # (pass name, public params[, report]) in application order —
        # JSON-able, so the driver can persist it as the compile's pass
        # trace.  A pass can append structured decision records (e.g. the
        # fusion pass's accepted/rejected merges) to the injected
        # ``params["_report"]`` list; non-empty reports become the trace
        # entry's third element.
        self.trace: List[Tuple] = []

    def run(self, prog: Program) -> Program:
        import copy

        from . import autotile, boundary, fuse, localize, partition, schedule, stencil, transpose  # noqa: F401

        source = prog.source or copy.deepcopy(prog)
        for name, params in self.hw.passes:
            fn = _REGISTRY[name]
            run_params = dict(params)
            if name == "autotile":
                if self.oracle is not None:
                    run_params["_oracle"] = self.oracle
                if self.autotune_workers is not None and "workers" not in run_params:
                    run_params["workers"] = self.autotune_workers
            report: List = []
            run_params["_report"] = report
            with obs_trace.span(f"pass.{name}", hw=self.hw.name) as sp:
                prog = fn(prog, self.hw, run_params)
                sp.set(report_entries=len(report))
            entry = (name, dict(params), report) if report else (name, dict(params))
            self.trace.append(entry)
        prog.source = source
        return prog


def compile_program(prog: Program, hw: HardwareConfig) -> Program:
    return PassManager(hw).run(prog)
