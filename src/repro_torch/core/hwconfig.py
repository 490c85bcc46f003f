"""Hardware configuration — the paper's ``create_stripe_config`` /
``set_config_params`` (Fig. 1).

A ``HardwareConfig`` is the *only* hardware-specific artifact in the
compiler: a description of the memory hierarchy, compute stencils, and a
parameterized list of optimization passes.  Operations (the frontend) never
reference it; passes are generic and read their parameters from here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MemoryUnit:
    name: str
    size_bytes: int
    bandwidth: float  # bytes/s to the next-outer level
    cache_line_elems: int = 1  # transaction granularity, in elements


@dataclasses.dataclass(frozen=True)
class ComputeStencil:
    """A hardware compute unit needing exact tile multiples (paper:
    'Microarchitectural Stenciling')."""

    name: str  # e.g. "mxu", "vpu"
    # (parallel_out0, parallel_out1, reduction) multiples for contractions
    dims: Tuple[int, int, int]
    flops: float  # peak FLOP/s when fed at this stencil


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    name: str
    mem_units: Tuple[MemoryUnit, ...]  # outermost -> innermost
    stencils: Tuple[ComputeStencil, ...] = ()
    peak_flops: float = 0.0
    # roofline link terms (framework-level; chips in a pod slice)
    ici_link_bw: float = 0.0
    # device-mesh shape for multi-device plans: () = single device.  A
    # non-trivial mesh activates the partition pass's annotation mode
    # (shard-plan analysis + collective predictions in the pass trace)
    # and the interconnect terms of the cost model; the backend mesh a
    # ``stripe_jit(..., mesh=)`` compile runs on is resolved separately
    # (the config's mesh is the *model*, the driver's mesh the machine).
    mesh: Tuple[int, ...] = ()
    # grid-pipeline depth: how many in-flight tile buffers the hardware's
    # DMA pipeline holds per streamed view (2 = classic double buffering;
    # 1 = no overlap — fetch and compute serialize).  Gates the pipelined
    # latency model in cost.py and sizes memplan's streamed-view slots.
    pipeline_depth: int = 2
    # pass pipeline: (pass_name, params) applied in order
    passes: Tuple[Tuple[str, Dict], ...] = ()

    def mem(self, name: str) -> MemoryUnit:
        for m in self.mem_units:
            if m.name == name:
                return m
        raise KeyError(
            f"no memory unit {name!r} in hardware config {self.name!r}; "
            f"available units: {[m.name for m in self.mem_units]}")

    def inner_mem(self) -> MemoryUnit:
        return self.mem_units[1] if len(self.mem_units) > 1 else self.mem_units[0]

    def fingerprint(self) -> str:
        """Stable content hash of everything that can change compilation
        output: memory hierarchy, stencils, roofline terms, and the pass
        pipeline with its parameters (order-sensitive; param-key order is
        not).  The config *name* is deliberately excluded — two configs
        that compile identically hash identically, so design-space sweeps
        dedupe renamed-but-equal points into one compilation-cache entry.
        Used as the hardware component of compilation-cache keys.

        Memoized per instance: configs are frozen (every mutation helper
        returns a fresh instance via ``dataclasses.replace``), and the
        calibration-aware cost model consults the fingerprint once per
        candidate tiling — hashing the config thousands of times per
        autotile search would dominate it."""
        cached = self.__dict__.get("_fingerprint_memo")
        if cached is not None:
            return cached
        from .cache import stable_hash

        fp = stable_hash([
            "hwconfig",
            [[m.name, m.size_bytes, m.bandwidth, m.cache_line_elems] for m in self.mem_units],
            [[s.name, list(s.dims), s.flops] for s in self.stencils],
            self.peak_flops, self.ici_link_bw, self.pipeline_depth,
            list(self.mesh),
            [[name, sorted(params.items())] for name, params in self.passes],
        ])
        object.__setattr__(self, "_fingerprint_memo", fp)
        return fp

    def with_params(self, **overrides) -> "HardwareConfig":
        """The paper's ``set_config_params``: per-HW-version tweak of pass
        parameters without rewriting the config."""
        new_passes = []
        for name, params in self.passes:
            p = dict(params)
            for k, v in overrides.items():
                pref = name + "."
                if k.startswith(pref):
                    p[k[len(pref):]] = v
            new_passes.append((name, p))
        return dataclasses.replace(self, passes=tuple(new_passes))

    # ---------------------------------------------------------------- sweeps
    # Space-mutation helpers for design-space exploration (repro_torch.explore):
    # each returns a new config with one structural knob turned, leaving
    # everything else (including the pass pipeline) intact.
    def renamed(self, name: str) -> "HardwareConfig":
        return dataclasses.replace(self, name=name)

    def with_mem(self, unit: str, **overrides) -> "HardwareConfig":
        """Replace fields of one memory unit (e.g. ``with_mem("VMEM",
        size_bytes=64 << 20)``)."""
        self.mem(unit)  # raise the descriptive KeyError on a bad name
        units = tuple(
            dataclasses.replace(m, **overrides) if m.name == unit else m
            for m in self.mem_units)
        return dataclasses.replace(self, mem_units=units)

    def with_stencil(self, stencil: str, **overrides) -> "HardwareConfig":
        """Replace fields of one compute stencil (e.g. ``with_stencil(
        "mxu", dims=(256, 256, 128))``)."""
        if not any(s.name == stencil for s in self.stencils):
            raise KeyError(
                f"no stencil {stencil!r} in hardware config {self.name!r}; "
                f"available stencils: {[s.name for s in self.stencils]}")
        stencils = tuple(
            dataclasses.replace(s, **overrides) if s.name == stencil else s
            for s in self.stencils)
        return dataclasses.replace(self, stencils=stencils)

    def without_pass(self, name: str) -> "HardwareConfig":
        """Drop one pass from the pipeline (pipeline-variant sweeps)."""
        return dataclasses.replace(
            self, passes=tuple(p for p in self.passes if p[0] != name))

    def with_mesh(self, shape: Sequence[int]) -> "HardwareConfig":
        """Set the modeled device-mesh shape (mesh-shape sweeps).  The
        partition pass must see the *semantic* program, so it is
        prepended to the pipeline when a non-trivial mesh is set and the
        pipeline does not already run it."""
        shape = tuple(int(s) for s in shape)
        passes = self.passes
        n = 1
        for s in shape:
            n *= s
        if n <= 1:
            # a trivial mesh is *no* mesh: normalize so the config
            # fingerprints identically to the stock single-device one
            # (sweep dedupe relies on it)
            return dataclasses.replace(self, mesh=())
        if not any(name == "partition" for name, _ in passes):
            passes = (("partition", {}),) + passes
        return dataclasses.replace(self, mesh=shape, passes=passes)

    def mesh_devices(self) -> int:
        n = 1
        for s in self.mesh:
            n *= int(s)
        return n


# ---------------------------------------------------------------------------
# TPU v5e (the deployment target of this framework)
# ---------------------------------------------------------------------------
TPU_V5E = HardwareConfig(
    name="tpu_v5e",
    mem_units=(
        MemoryUnit("HBM", 16 * 2**30, 819e9, cache_line_elems=128),
        # VMEM: ~128 MiB; budget half for double-buffering headroom
        MemoryUnit("VMEM", 128 * 2**20, 2.7e12, cache_line_elems=128),
        MemoryUnit("VREG", 32 * 2**10, 1e14, cache_line_elems=8),
    ),
    stencils=(
        ComputeStencil("mxu", (128, 128, 128), 197e12),  # bf16 systolic
        ComputeStencil("vpu", (8, 128, 1), 4e12),
    ),
    peak_flops=197e12,
    ici_link_bw=50e9,
    pipeline_depth=2,  # double-buffered BlockSpec streaming
    passes=(
        # prefer is explicit (its implicit default) so a sweep point that
        # sets it to the stock value fingerprints identically to stock
        ("fuse", {"prefer": "epilogue"}),
        ("autotile", {
            "cost": "roofline",
            "search": "pow2",
            "mem_cap_frac": 0.45,   # of VMEM; leaves room for double buffering
            "count_untiled": True,
        }),
        ("stencil", {"stencil": "mxu", "min_dim": 16}),
        ("boundary", {"mode": "remainder"}),
        ("localize", {"inner": "VMEM"}),
        ("schedule", {"unit": "VMEM"}),
    ),
)

# ---------------------------------------------------------------------------
# The paper's Fig. 4 cost-model machine: a generic cached architecture with
# an 8-element cache line and a 512-element tile budget.
# ---------------------------------------------------------------------------
PAPER_FIG4 = HardwareConfig(
    name="paper_fig4",
    mem_units=(
        MemoryUnit("DRAM", 1 << 40, 100e9, cache_line_elems=8),
        MemoryUnit("CACHE", 512, 1e12, cache_line_elems=8),  # 512 *elements*
    ),
    peak_flops=1e12,
    pipeline_depth=1,  # the paper's cost-model machine has no DMA pipeline
    passes=(
        ("autotile", {
            "cost": "cache_lines",
            "search": "divisors",
            "mem_cap_elems": 512,
            "count_untiled": False,  # Fig 4 excludes the (untiled) weights
            "exact_macs": True,
        }),
    ),
)

# A host-CPU config used by tests: small tiles, no stencils.
CPU_TEST = HardwareConfig(
    name="cpu_test",
    mem_units=(
        MemoryUnit("RAM", 1 << 40, 50e9, cache_line_elems=16),
        MemoryUnit("L2", 1 << 20, 500e9, cache_line_elems=16),
    ),
    peak_flops=1e11,
    passes=(
        ("fuse", {}),
        ("autotile", {"cost": "cache_lines", "search": "pow2", "mem_cap_elems": 4096}),
        ("boundary", {"mode": "remainder"}),
        ("localize", {"inner": "L2"}),
        ("schedule", {"unit": "L2"}),
    ),
)

# ---------------------------------------------------------------------------
# NVIDIA H100 SXM (the port's deployment target).  Figures are spec-sheet
# values (NVIDIA H100 data sheet and the Hopper architecture white paper),
# not measurements.
# ---------------------------------------------------------------------------
_H100_SMEM = 232_448  # 227 KB of shared memory a block can use (data sheet)
_H100_L2 = 50 * 2**20  # 50 MB L2 cache (data sheet)

H100 = HardwareConfig(
    name="h100",
    mem_units=(
        # 80 GB HBM3 at 3.35 TB/s (data sheet); the roofline's memory term
        MemoryUnit("HBM", 80 * 10**9, 3.35e12, cache_line_elems=32),
        # L2 is the level a fusion group's streamed reduction operands are
        # re-read from across CUDA blocks: fusion prices its working set
        # here (the CUDA kernel loops over the reduction inside the block,
        # so the whole reduction extent never has to sit in SMEM).  Its
        # fill rate is the HBM rate above.
        MemoryUnit("L2", _H100_L2, 3.35e12, cache_line_elems=32),
        # per-block shared memory: the inner unit localize and schedule name
        MemoryUnit("SMEM", _H100_SMEM, 3.35e12, cache_line_elems=32),
        # 65,536 32-bit registers per SM (data sheet)
        MemoryUnit("REG", 65_536 * 4, 3.35e12, cache_line_elems=1),
    ),
    # 67 TFLOP/s float32 outside the tensor cores (data sheet): the
    # serving programs compute in float32 on the CUDA cores
    peak_flops=67e12,
    pipeline_depth=2,
    passes=(
        ("fuse", {"prefer": "epilogue"}),
        ("autotile", {
            "cost": "roofline",
            "search": "pow2",
            # autotile caps a plan tile at this fraction of the inner unit
            # (L2): 0.0022 * 50 MB = 115 KB, half of one block's 227 KB
            # SMEM, leaving the other half for double buffering
            "mem_cap_frac": 0.0022,
            "count_untiled": True,
        }),
        ("boundary", {"mode": "remainder"}),
        ("localize", {"inner": "SMEM"}),
        ("schedule", {"unit": "SMEM"}),
    ),
)

REGISTRY: Dict[str, HardwareConfig] = {
    c.name: c for c in (TPU_V5E, PAPER_FIG4, CPU_TEST, H100)
}


def get_config(name: str) -> HardwareConfig:
    """The registry accessor — the one way the rest of the framework (and
    the ``repro_torch.explore`` sweeps) should name a hardware config."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown hardware config {name!r}; "
            f"available configs: {sorted(REGISTRY)}") from None
