"""Architecture registry: ``get(name)`` / ``names()``."""
from __future__ import annotations

from typing import Dict, List

from .base import SHAPES, ArchConfig, ShapeSpec, applicable_shapes

_MODULES = [
    # only what the port serves; the other families come with later slices
    "llama3_8b",
]

_REGISTRY: Dict[str, ArchConfig] = {}


def _load() -> None:
    if _REGISTRY:
        return
    import importlib

    for m in _MODULES:
        mod = importlib.import_module(f".{m}", __package__)
        cfg: ArchConfig = mod.CONFIG
        _REGISTRY[cfg.name] = cfg


def get(name: str) -> ArchConfig:
    _load()
    return _REGISTRY[name]


def names() -> List[str]:
    _load()
    return list(_REGISTRY)


__all__ = ["get", "names", "ArchConfig", "ShapeSpec", "SHAPES", "applicable_shapes"]
