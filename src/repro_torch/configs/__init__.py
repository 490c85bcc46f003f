"""Architecture registry: ``get(name)`` / ``names()``."""
from __future__ import annotations

from typing import Dict, List

from .base import SHAPES, ArchConfig, ShapeSpec, applicable_shapes

_MODULES = [
    "xlstm_125m",
    "nemotron_4_15b",
    "chatglm3_6b",
    "llama3_8b",
    "qwen3_4b",
    "qwen3_moe_30b_a3b",
    "dbrx_132b",
    "internvl2_26b",
    "seamless_m4t_large_v2",
    "zamba2_2_7b",
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
