"""The Stripe-compiled matmul: a one-block Tile program lowered to one
launch of the contraction kernel under the ``h100`` config."""
from .ops import matmul, matmul_ref

__all__ = ["matmul", "matmul_ref"]
