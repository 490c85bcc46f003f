"""The public facade of the port.

``from repro_torch import api`` gives what this slice of the port has:

Compile:
    ``jit`` (= ``stripe_jit``), ``compile`` (= ``compile_cached``),
    ``TileProgram``, ``CompiledProgram``, ``compile_with_tilings``
Op library:
    ``set_backend`` / ``get_backend`` (``"torch"`` or ``"cuda"``: how the
    models' projections run), ``linear``
Hardware & model configs:
    ``get_config`` (hardware registry, with ``"h100"``), ``configs``
    (architecture registry: ``configs.get(name)``), ``build_model`` (a
    ``Model`` with ``init``, ``loss``, ``prefill``, ``decode_step``,
    ``init_cache``), ``make_batch``
Serving:
    ``ServingEngine``, ``WaveEngine`` (the wave baseline, and the one
    serving path of the moe and vlm families), ``EngineConfig``,
    ``Request``, ``SamplingParams``
Exploration:
    ``explore`` (subpackage: ``run_sweep``, ``get_space``,
    ``pareto_front``, ``dominating_baseline``, ...), ``get_workloads``,
    ``roofline_hillclimb``, ``measure_candidates``
Autotuning:
    ``tune`` (subpackage), ``TuningDB``, ``fit_calibration``,
    ``set_calibration``, ``measure_interleaved``
Observability:
    ``obs`` (subpackage; ``python -m repro_torch.obs``)
Kernels:
    ``matmul``, ``matmul_ref`` (the Stripe-compiled matmul),
    ``choose_block_sizes`` (flash attention's blocks under ``h100``)
Reliability:
    ``faults`` (fault-injection module), ``FaultPlan``, ``InjectedFault``
Conversion:
    ``params_from_jax`` (onto the card unless ``device="cpu"``)
"""
from __future__ import annotations

from . import configs, explore, obs, tune
from .convert import params_from_jax
from .core import CompiledProgram, TileProgram, compile_cached, stripe_jit
from .core.driver import compile_with_tilings
from .core.hwconfig import HardwareConfig, get_config
from .core.oplib import get_backend, linear, set_backend
from .explore import (dominating_baseline, get_space, measure_candidates, pareto_front,
                      run_sweep)
from .explore.hillclimb import roofline_hillclimb
from .explore.workloads import get_workloads
from .kernels.flash_attention.ops import choose_block_sizes
from .kernels.stripe_matmul.ops import matmul, matmul_ref
from .models.build import build_model, make_batch
from .reliability import FaultPlan, InjectedFault, faults
from .serving import EngineConfig, Request, SamplingParams, ServingEngine, WaveEngine
from .tune import TuningDB, fit_calibration, measure_interleaved, set_calibration

jit = stripe_jit
compile = compile_cached  # noqa: A001 - deliberate: api.compile, never bare

__all__ = [
    "jit", "compile", "stripe_jit", "compile_cached", "TileProgram",
    "CompiledProgram", "compile_with_tilings", "set_backend", "get_backend", "linear",
    "get_config", "HardwareConfig", "configs", "build_model", "make_batch",
    "tune", "TuningDB", "fit_calibration", "set_calibration", "measure_interleaved",
    "obs", "measure_candidates",
    "ServingEngine", "WaveEngine", "EngineConfig", "Request", "SamplingParams",
    "explore", "get_workloads", "roofline_hillclimb", "run_sweep", "get_space",
    "pareto_front", "dominating_baseline",
    "matmul", "matmul_ref", "choose_block_sizes",
    "faults", "FaultPlan", "InjectedFault", "params_from_jax",
]
