"""``build_model(cfg)`` returns a ``Model`` whose ``init`` draws random
parameters; only the dense family is ported."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..configs.base import ArchConfig
from . import lm


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]  # init(generator, device=None) -> params


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family != "dense":
        raise ValueError(f"no model for family {cfg.family}")
    return Model(cfg=cfg, init=lambda gen, device=None: lm.init_params(cfg, gen, device))
