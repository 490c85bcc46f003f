"""Stripe: the paper's contribution — a nested-polyhedral tensor IR with a
config-driven optimization pass pipeline and torch/CUDA backends."""
from .affine import Affine, aff
from .poly import Constraint, Index, Polyhedron
from .ir import (
    AGG_IDENTITY,
    AGG_OPS,
    Block,
    Constant,
    Intrinsic,
    Load,
    Location,
    Program,
    RefDir,
    Refinement,
    Special,
    Store,
    TensorDecl,
)
from .ir import canonical_ir, ir_fingerprint
from .frontend import TileProgram, single_op_program
from .interp import execute_reference
from .lower_torch import lower_block_torch, lower_program_torch
from .validate import validate_program
from .cache import CompilationCache, get_default_cache, set_default_cache
from .driver import CompiledProgram, compile_cached, stripe_jit

__all__ = [
    "Affine", "aff", "Constraint", "Index", "Polyhedron",
    "AGG_IDENTITY", "AGG_OPS", "Block", "Constant", "Intrinsic", "Load",
    "Location", "Program", "RefDir", "Refinement", "Special", "Store",
    "TensorDecl", "TileProgram", "single_op_program", "execute_reference",
    "lower_block_torch", "lower_program_torch", "validate_program",
    "canonical_ir", "ir_fingerprint",
    "CompilationCache", "get_default_cache", "set_default_cache",
    "CompiledProgram", "compile_cached", "stripe_jit",
]
