"""The public facade of the port.

``from repro_torch import api`` gives what this slice of the port has:

Compile:
    ``jit`` (= ``stripe_jit``), ``compile`` (= ``compile_cached``),
    ``TileProgram``, ``CompiledProgram``
Hardware & model configs:
    ``get_config`` (hardware registry, with ``"h100"``), ``configs``
    (architecture registry: ``configs.get(name)``), ``build_model``
Serving:
    ``ServingEngine``, ``EngineConfig``, ``Request``, ``SamplingParams``
Exploration:
    ``explore`` (subpackage: ``run_sweep``, ``get_space``,
    ``pareto_front``, ``dominating_baseline``, ...), ``get_workloads``,
    ``roofline_hillclimb``
Kernels:
    ``matmul``, ``matmul_ref`` (the Stripe-compiled matmul),
    ``choose_block_sizes`` (flash attention's blocks under ``h100``)
Reliability:
    ``faults`` (fault-injection module), ``FaultPlan``, ``InjectedFault``
Conversion:
    ``params_from_jax`` (onto the card unless ``device="cpu"``)
"""
from __future__ import annotations

from . import configs, explore
from .convert import params_from_jax
from .core import CompiledProgram, TileProgram, compile_cached, stripe_jit
from .core.hwconfig import HardwareConfig, get_config
from .explore import dominating_baseline, get_space, pareto_front, run_sweep
from .explore.hillclimb import roofline_hillclimb
from .explore.workloads import get_workloads
from .kernels.flash_attention.ops import choose_block_sizes
from .kernels.stripe_matmul.ops import matmul, matmul_ref
from .models.build import build_model
from .reliability import FaultPlan, InjectedFault, faults
from .serving import EngineConfig, Request, SamplingParams, ServingEngine

jit = stripe_jit
compile = compile_cached  # noqa: A001 - deliberate: api.compile, never bare

__all__ = [
    "jit", "compile", "stripe_jit", "compile_cached", "TileProgram",
    "CompiledProgram", "get_config", "HardwareConfig", "configs", "build_model",
    "ServingEngine", "EngineConfig", "Request", "SamplingParams",
    "explore", "get_workloads", "roofline_hillclimb", "run_sweep", "get_space",
    "pareto_front", "dominating_baseline",
    "matmul", "matmul_ref", "choose_block_sizes",
    "faults", "FaultPlan", "InjectedFault", "params_from_jax",
]
