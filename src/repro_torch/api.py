"""The public facade of the port.

``from repro_torch import api`` gives what this slice of the port has:

Compile:
    ``jit`` (= ``stripe_jit``), ``compile`` (= ``compile_cached``),
    ``TileProgram``, ``single_op_program``, ``CompiledProgram``,
    ``compile_with_tilings``, ``execute_reference`` (the numpy
    interpreter), ``validate_program``, ``lower_program_torch`` (the twin
    of the JAX package's ``lower_program_jnp``: the plain PyTorch
    backend), ``compile_program``, ``get_pass``, ``split_block``,
    ``choose_tiling``, ``evaluate_tiling``, ``score_pass_trace``
Multi-device:
    ``Mesh`` (``parallel.spmd.Mesh``: explicit devices, one a rank);
    ``jit(..., mesh=)`` takes a device count, a mesh shape tuple (the
    machine's first cards) or a ``Mesh`` (``Mesh(["cuda:0"] * 4, ("x",))``
    runs four ranks on one card)
Op library:
    ``set_backend`` / ``get_backend`` (``"torch"`` or ``"cuda"``: how the
    models' projections run), ``linear``
Hardware & model configs:
    ``get_config`` (hardware registry, with ``"h100"``), ``HW_REGISTRY``,
    ``HardwareConfig``, ``configs``
    (architecture registry: ``configs.get(name)``), ``build_model`` (a
    ``Model`` with ``init``, ``loss``, ``prefill``, ``decode_step``,
    ``init_cache``), ``make_batch``
Caching:
    ``CompilationCache``, ``get_default_cache``, ``set_default_cache``
Serving:
    ``ServingEngine``, ``WaveEngine`` (the wave baseline, and the one
    serving path of every family but the dense one), ``EngineConfig``,
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
Training:
    ``adamw`` (``AdamWConfig``, ``apply_updates``, ...), ``TrainConfig``,
    ``Trainer`` (on the card unless ``device="cpu"``; on ``oplib``'s
    ``torch`` backend, since the kernels have no backward: ROADMAP C11),
    ``DataConfig``
Reliability:
    ``faults`` (fault-injection module), ``FaultPlan``, ``InjectedFault``
Conversion:
    ``params_from_jax`` (onto the card unless ``device="cpu"``)
"""
from __future__ import annotations

from . import configs, explore, obs, tune
from .convert import params_from_jax
from .core import (
    CompilationCache,
    CompiledProgram,
    TileProgram,
    compile_cached,
    execute_reference,
    get_default_cache,
    lower_program_torch,
    set_default_cache,
    single_op_program,
    stripe_jit,
    validate_program,
)
from .core.cost import evaluate_tiling, score_pass_trace
from .core.driver import compile_with_tilings
from .core.hwconfig import REGISTRY as HW_REGISTRY
from .core.hwconfig import HardwareConfig, get_config
from .core.passes import compile_program, get_pass
from .core.passes.autotile import choose_tiling
from .core.tiling import split_block
from .core.oplib import get_backend, linear, set_backend
from .data.pipeline import DataConfig
from .explore import (dominating_baseline, get_space, measure_candidates, pareto_front,
                      run_sweep)
from .explore.hillclimb import roofline_hillclimb
from .explore.workloads import get_workloads
from .kernels.flash_attention.ops import choose_block_sizes
from .kernels.stripe_matmul.ops import matmul, matmul_ref
from .models.build import build_model, make_batch
from .optim import adamw
from .parallel.spmd import Mesh
from .reliability import FaultPlan, InjectedFault, faults
from .serving import EngineConfig, Request, SamplingParams, ServingEngine, WaveEngine
from .train.loop import TrainConfig, Trainer
from .tune import TuningDB, fit_calibration, measure_interleaved, set_calibration

jit = stripe_jit
compile = compile_cached  # noqa: A001 - deliberate: api.compile, never bare

__all__ = [
    "jit", "compile", "stripe_jit", "compile_cached", "TileProgram",
    "single_op_program", "CompiledProgram", "execute_reference", "validate_program",
    "lower_program_torch", "compile_program", "get_pass", "split_block", "choose_tiling",
    "evaluate_tiling", "score_pass_trace",
    "compile_with_tilings", "set_backend", "get_backend", "linear",
    "get_config", "HW_REGISTRY", "HardwareConfig", "configs", "Mesh", "build_model",
    "make_batch",
    "CompilationCache", "get_default_cache", "set_default_cache",
    "tune", "TuningDB", "fit_calibration", "set_calibration", "measure_interleaved",
    "obs", "measure_candidates",
    "ServingEngine", "WaveEngine", "EngineConfig", "Request", "SamplingParams",
    "explore", "get_workloads", "roofline_hillclimb", "run_sweep", "get_space",
    "pareto_front", "dominating_baseline",
    "matmul", "matmul_ref", "choose_block_sizes",
    "adamw", "TrainConfig", "Trainer", "DataConfig",
    "faults", "FaultPlan", "InjectedFault", "params_from_jax",
]
