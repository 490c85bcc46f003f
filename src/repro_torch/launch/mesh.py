"""Production mesh builders, the twin of the JAX package's
``launch/mesh.py``, over the port's :class:`~repro_torch.parallel.spmd.Mesh`.

Defined as FUNCTIONS (not module constants) so importing this module
never touches device state.  A builder takes the first cards of the
machine (``torch.cuda.device_count()``) and raises when there are too
few, as ``jax.make_mesh`` does; ``devices=`` is the only way to emulate
devices (``["cuda:0"] * 8`` runs 8 ranks on one card, ``["cpu"] * 8`` on
the CPU).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..parallel.spmd import Mesh


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (one a rank, in order), or over
    the machine's first ``prod(shape)`` cards."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(
                f"mesh {shape} needs {n} devices; only {have} CUDA device(s) available "
                "(pass devices=, e.g. ['cuda:0'] * n or ['cpu'] * n, to emulate them)")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"mesh {shape} needs {n} devices; {len(devices)} given")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(shape), tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, devices: Optional[Sequence] = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_test_mesh(n_devices: int = 8, devices: Optional[Sequence] = None) -> Mesh:
    """Small mesh for multi-device unit tests (2 x n/2)."""
    return make_mesh((2, n_devices // 2), ("data", "model"), devices)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def tp_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n
