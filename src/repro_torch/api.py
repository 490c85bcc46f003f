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
Reliability:
    ``faults`` (fault-injection module), ``FaultPlan``, ``InjectedFault``
Conversion:
    ``params_from_jax``
"""
from __future__ import annotations

from . import configs
from .convert import params_from_jax
from .core import CompiledProgram, TileProgram, compile_cached, stripe_jit
from .core.hwconfig import HardwareConfig, get_config
from .models.build import build_model
from .reliability import FaultPlan, InjectedFault, faults
from .serving import EngineConfig, Request, SamplingParams, ServingEngine

jit = stripe_jit
compile = compile_cached  # noqa: A001 - deliberate: api.compile, never bare

__all__ = [
    "jit", "compile", "stripe_jit", "compile_cached", "TileProgram",
    "CompiledProgram", "get_config", "HardwareConfig", "configs", "build_model",
    "ServingEngine", "EngineConfig", "Request", "SamplingParams",
    "faults", "FaultPlan", "InjectedFault", "params_from_jax",
]
