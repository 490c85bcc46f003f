"""Declarative design-space specification (paper §4, "the biggest payoff
of the nested polyhedral model is design exploration").

A :class:`SearchSpace` names a base :class:`HardwareConfig` and a set of
:class:`Axis` knobs over it.  Because the hardware config is the *only*
hardware-specific artifact in the compiler, turning a knob never touches
an operation or a pass — a point is just ``space.apply(point)`` and the
standard pipeline compiles it.

Axis paths address the config structurally:

* ``mem.<UNIT>.<field>``     — a memory-unit field (``size_bytes``,
  ``bandwidth``, ``cache_line_elems``), e.g. ``mem.VMEM.size_bytes``;
* ``stencil.<NAME>.<field>`` — a compute-stencil field, e.g.
  ``stencil.mxu.dims``;
* ``peak_flops`` / ``ici_link_bw`` / ``pipeline_depth`` — top-level
  roofline/pipeline scalars;
* ``mesh``                   — a device-mesh shape tuple via
  ``with_mesh`` (``(1,)`` = single device); the partition pass annotates
  the shard plan, so sweeping this axis trades predicted latency against
  the new communication-bytes Pareto axis;
* ``pipeline``               — a named pass-pipeline variant
  (:data:`PIPELINE_VARIANTS`), e.g. dropping the fusion pass;
* ``<pass>.<param>``         — a pass parameter via ``with_params``,
  e.g. ``autotile.mem_cap_frac`` or ``fuse.prefer``.

Enumeration strategies: ``grid`` (evenly strided subsample of the full
cartesian product when it exceeds the budget), ``random`` (seeded i.i.d.
per-axis draws), and ``hillclimb`` (greedy coordinate descent from the
stock point, driven by a caller-supplied score — the generic form of the
roofline hillclimb that used to live in ``benchmarks/stripe_hillclimb``).
"""
from __future__ import annotations

import dataclasses
import itertools
import random as _random
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from ..core.hwconfig import HardwareConfig, get_config

PIPELINE_VARIANTS: Dict[str, Callable[[HardwareConfig], HardwareConfig]] = {
    "default": lambda cfg: cfg,
    "no-fuse": lambda cfg: cfg.without_pass("fuse"),
    "no-stencil": lambda cfg: cfg.without_pass("stencil"),
}


@dataclasses.dataclass(frozen=True)
class Axis:
    """One swept knob: a structural path into the config and its candidate
    values.  ``default`` is the stock setting (the hillclimb start point
    and the value omitted from derived config names)."""

    path: str
    values: Tuple[Any, ...]
    default: Any = None

    def __post_init__(self):
        if not self.values:
            raise ValueError(f"axis {self.path!r} has no values")
        if self.default is None:
            object.__setattr__(self, "default", self.values[0])


def apply_axis(cfg: HardwareConfig, path: str, value: Any) -> HardwareConfig:
    """Apply one axis setting to a config (see module docstring for the
    path grammar)."""
    parts = path.split(".")
    if path == "pipeline":
        try:
            return PIPELINE_VARIANTS[value](cfg)
        except KeyError:
            raise KeyError(f"unknown pipeline variant {value!r}; "
                           f"available: {sorted(PIPELINE_VARIANTS)}") from None
    if path in ("peak_flops", "ici_link_bw", "pipeline_depth"):
        return dataclasses.replace(cfg, **{path: value})
    if path == "mesh":
        shape = (value,) if isinstance(value, int) else tuple(value)
        return cfg.with_mesh(shape)
    if len(parts) == 3 and parts[0] == "mem":
        return cfg.with_mem(parts[1], **{parts[2]: value})
    if len(parts) == 3 and parts[0] == "stencil":
        return cfg.with_stencil(parts[1], **{parts[2]: tuple(value) if parts[2] == "dims" else value})
    if len(parts) == 2:
        return cfg.with_params(**{path: value})
    raise ValueError(f"unrecognized axis path {path!r}")


def _fmt(v: Any) -> str:
    if isinstance(v, (tuple, list)):
        return "x".join(str(int(s)) for s in v)  # mesh shapes: "2x4"
    if isinstance(v, float):
        return f"{v:g}"
    if isinstance(v, int) and v >= 1 << 20 and v % (1 << 20) == 0:
        return f"{v >> 20}Mi"
    return str(v)


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """A named design space: base config + axes.  Pure data (picklable),
    so the parallel sweep runner can ship it to worker processes."""

    name: str
    base: str  # registry name of the base HardwareConfig
    axes: Tuple[Axis, ...]

    def base_config(self) -> HardwareConfig:
        return get_config(self.base)

    def default_point(self) -> Dict[str, Any]:
        return {a.path: a.default for a in self.axes}

    def size(self) -> int:
        n = 1
        for a in self.axes:
            n *= len(a.values)
        return n

    def point_name(self, point: Mapping[str, Any]) -> str:
        """Readable derived-config name: base plus only the non-stock
        settings (names never enter the fingerprint, so this is purely
        for reports)."""
        diffs = [f"{a.path}={_fmt(point[a.path])}"
                 for a in self.axes if point[a.path] != a.default]
        return self.base if not diffs else f"{self.base}+" + ",".join(diffs)

    def apply(self, point: Mapping[str, Any]) -> HardwareConfig:
        """Materialize a point: the base config with every axis applied.
        The ``pipeline`` axis (if any) is applied first so pass-parameter
        axes act on the selected pipeline."""
        cfg = self.base_config()
        ordered = sorted(self.axes, key=lambda a: a.path != "pipeline")
        for a in ordered:
            cfg = apply_axis(cfg, a.path, point[a.path])
        return cfg.renamed(self.point_name(point))

    # ---------------------------------------------------------- strategies
    def grid(self, budget: int) -> List[Dict[str, Any]]:
        """The full cartesian product, evenly stride-subsampled down to
        ``budget`` points when it is larger.  The stock (all-defaults)
        point always leads, so every grid sweep revisits the baseline
        fingerprint — the sweep runner dedupes it against the baseline
        compile instead of rescoring."""
        stock = tuple(a.default for a in self.axes)
        combos = [c for c in itertools.product(*(a.values for a in self.axes))
                  if c != stock]
        if budget:
            take = budget - 1  # the stock point spends one budget slot
            if len(combos) > take:
                if take <= 0:
                    combos = []
                else:
                    n = len(combos)
                    picks = sorted({round(i * (n - 1) / max(take - 1, 1))
                                    for i in range(take)})
                    combos = [combos[i] for i in picks]
        return [dict(zip((a.path for a in self.axes), c)) for c in [stock] + combos]

    def random(self, budget: int, seed: int = 0) -> List[Dict[str, Any]]:
        """Seeded i.i.d. per-axis draws, deduplicated, stock point first."""
        rng = _random.Random(seed)
        target = min(budget, self.size())
        out = [self.default_point()]
        seen = {tuple(out[0][a.path] for a in self.axes)}
        attempts = 0
        while len(out) < target and attempts < 100 * max(budget, 1):
            attempts += 1
            point = {a.path: rng.choice(a.values) for a in self.axes}
            key = tuple(point[a.path] for a in self.axes)
            if key not in seen:
                seen.add(key)
                out.append(point)
        return out

    def hillclimb(self, budget: int,
                  score: Callable[[Dict[str, Any]], float],
                  seed: int = 0) -> List[Dict[str, Any]]:
        """Greedy coordinate descent from the stock point: sweep one axis
        at a time (round-robin, seeded axis order), keep the best value,
        stop when a full round improves nothing or the budget is spent.
        Returns every point evaluated, in evaluation order."""
        rng = _random.Random(seed)
        axes = list(self.axes)
        rng.shuffle(axes)
        current = self.default_point()
        visited: List[Dict[str, Any]] = []
        scores: Dict[Tuple, float] = {}

        def eval_point(p: Dict[str, Any]) -> float:
            key = tuple(p[a.path] for a in self.axes)
            if key not in scores:
                if len(visited) >= budget:
                    return float("inf")
                visited.append(dict(p))
                scores[key] = score(p)
            return scores[key]

        best = eval_point(current)
        improved = True
        while improved and len(visited) < budget:
            improved = False
            for a in axes:
                for v in a.values:
                    if v == current[a.path]:
                        continue
                    trial = dict(current, **{a.path: v})
                    s = eval_point(trial)
                    if s < best:
                        best, current = s, trial
                        improved = True
                if len(visited) >= budget:
                    break
        return visited


# --------------------------------------------------------------------------
# Built-in spaces
# --------------------------------------------------------------------------
def tpu_sweep() -> SearchSpace:
    """Hardware/compiler co-design around the TPU v5e: memory-system
    alternatives (HBM bandwidth generations, VMEM arena sizes, DMA
    pipeline depth) crossed with pass parameterizations (autotile
    budget, fusion-grouping preference) and pipeline variants (fusion
    on/off)."""
    return SearchSpace(
        name="tpu-sweep", base="tpu_v5e",
        axes=(
            Axis("pipeline", ("default", "no-fuse"), default="default"),
            Axis("mem.HBM.bandwidth", (819e9, 1.2e12, 1.64e12), default=819e9),
            Axis("mem.VMEM.size_bytes",
                 (64 * 2**20, 128 * 2**20, 256 * 2**20), default=128 * 2**20),
            Axis("pipeline_depth", (2, 1, 3), default=2),
            Axis("autotile.mem_cap_frac", (0.3, 0.45, 0.6, 0.9), default=0.45),
            Axis("fuse.prefer", ("epilogue", "prologue"), default="epilogue"),
        ))


def cacheline_sweep() -> SearchSpace:
    """The paper's Fig. 4 machine swept over its two defining knobs: the
    transaction granularity (cache-line width) and the tile budget —
    stencil-dims-scale exploration on the cached-architecture model."""
    return SearchSpace(
        name="cacheline-sweep", base="paper_fig4",
        axes=(
            Axis("mem.DRAM.cache_line_elems", (4, 8, 16, 32), default=8),
            Axis("autotile.mem_cap_elems", (256, 512, 1024, 2048), default=512),
            Axis("autotile.search", ("divisors", "pow2"), default="divisors"),
        ))


def h100_sweep() -> SearchSpace:
    """The same co-design axes as ``tpu-sweep`` around the H100 SXM (the
    port's counterpart of ``tpu-sweep``, as ``h100`` is of ``tpu_v5e``):
    HBM generations (H100 PCIe 2.0 TB/s, H100 SXM 3.35 TB/s, H200
    4.8 TB/s; data sheets), half and twice a block's 227 KB of shared
    memory (the unit ``localize`` and ``schedule`` name), the pipeline
    depth, the autotile budget at half to twice its stock fraction, the
    fusion preference, and fusion on/off (``no-fuse`` leaves the
    elementwise units to the elementwise kernel)."""
    return SearchSpace(
        name="h100-sweep", base="h100",
        axes=(
            Axis("pipeline", ("default", "no-fuse"), default="default"),
            Axis("mem.HBM.bandwidth", (2.0e12, 3.35e12, 4.8e12), default=3.35e12),
            Axis("mem.SMEM.size_bytes", (116_224, 232_448, 464_896), default=232_448),
            Axis("pipeline_depth", (2, 1, 3), default=2),
            Axis("autotile.mem_cap_frac", (0.0011, 0.0022, 0.0033, 0.0044), default=0.0022),
            Axis("fuse.prefer", ("epilogue", "prologue"), default="epilogue"),
        ))


def mesh_sweep() -> SearchSpace:
    """Multi-device co-design on the TPU v5e, as the JAX package's: device-mesh
    shapes (the partition pass's shard plan prices the collectives
    analytically — no devices are touched) crossed with interconnect
    bandwidth and the pipeline depth.  The sweep's Pareto front trades
    predicted latency against per-device communication bytes."""
    return SearchSpace(
        name="mesh-sweep", base="tpu_v5e",
        axes=(
            Axis("mesh", ((1,), (2,), (4,), (8,), (2, 2), (2, 4)),
                 default=(1,)),
            Axis("ici_link_bw", (50e9, 100e9, 25e9), default=50e9),
            Axis("pipeline_depth", (2, 1, 3), default=2),
        ))


BUILTIN_SPACES: Dict[str, Callable[[], SearchSpace]] = {
    "tpu-sweep": tpu_sweep,
    "h100-sweep": h100_sweep,
    "cacheline-sweep": cacheline_sweep,
    "mesh-sweep": mesh_sweep,
}

def get_space(name: str) -> SearchSpace:
    try:
        return BUILTIN_SPACES[name]()
    except KeyError:
        raise KeyError(f"unknown search space {name!r}; "
                       f"available: {sorted(BUILTIN_SPACES)}") from None
