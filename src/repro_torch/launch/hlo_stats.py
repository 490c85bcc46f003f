"""Collective-traffic statistics from compiled HLO text: a copy of the
JAX package's ``launch/hlo_stats.py``.

The port emits no HLO: its dry run (``launch/dryrun.py``) traces rank 0
of the sharded step and counts its collectives itself.  This copy reads
HLO text that the reference's dry run wrote (``compiled.as_text()``), so
that both packages' rows can be set side by side, and its
:data:`COLLECTIVES` are the kinds the port's dry run reports in.

The reference's ``compiled.cost_analysis()`` has FLOPs and bytes but no
collective bytes; this parses the post-GSPMD optimized HLO and sums the
operand sizes of every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# e.g.:  %foo.12 = bf16[8,128,256]{2,1,0} all-gather(%bar.3), ...
_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(\([^)]*\)|[\w\[\],\s{}]+?)\s+([\w\-]+)\(([^)]*)\)"
)
_SHAPE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


_COMP_START = re.compile(r"^%?([\w\.\-]+)\s*(?:\([^)]*\))?\s*->.*\{\s*$|^ENTRY\s")


def collective_stats(hlo_text: str, body_multiplier: int = 1) -> Dict[str, Dict[str, float]]:
    """Returns {collective_kind: {count, operand_bytes, result_bytes}}.

    XLA's textual HLO lists each while-loop *body* computation once, so a
    collective inside a layer scan appears once even though it executes
    n_layers times.  ``body_multiplier`` scales collectives found inside
    non-entry computations whose name marks them as loop bodies (jax scan
    lowers to ``while`` with ``body``/``region`` computations); pass the
    dominant scan trip count (n_layers).
    """
    shapes: Dict[str, int] = {}
    rows = []
    in_entry = True
    cur_comp = ""
    # computations that are actual while-loop bodies/conditions: collect the
    # names referenced by `while(...), condition=%c, body=%b` instructions
    loop_comps = set()
    for m in re.finditer(r"condition=%?([\w\.\-]+),\s*body=%?([\w\.\-]+)", hlo_text):
        loop_comps.update(m.groups())
    for ln in hlo_text.splitlines():
        stripped = ln.strip()
        if stripped.startswith("ENTRY"):
            in_entry = True
            cur_comp = "entry"
        elif stripped.startswith("%") and stripped.endswith("{") and "=" not in stripped.split("(")[0]:
            cur_comp = stripped.split()[0].lstrip("%")
            in_entry = False
        m = _INSTR.match(ln)
        if not m:
            continue
        name, type_str, op, operands = m.groups()
        shapes[name] = _shape_bytes(type_str)
        rows.append((name, type_str, op, operands, cur_comp, in_entry))

    out: Dict[str, Dict[str, float]] = {}
    for name, type_str, op, operands, comp, in_entry in rows:
        kind = None
        for c in COLLECTIVES:
            if op == c or op.startswith(c + "-start"):
                kind = c
                break
        if kind is None:
            continue
        mult = 1
        if not in_entry and comp in loop_comps:
            mult = body_multiplier
        opnd_bytes = 0
        for token in operands.split(","):
            token = token.strip().lstrip("%")
            if token in shapes:
                opnd_bytes += shapes[token]
        d = out.setdefault(kind, {"count": 0, "operand_bytes": 0.0, "result_bytes": 0.0})
        d["count"] += mult
        d["operand_bytes"] += opnd_bytes * mult
        d["result_bytes"] += shapes.get(name, 0) * mult
    return out


def total_collective_bytes(hlo_text: str, body_multiplier: int = 1) -> float:
    stats = collective_stats(hlo_text, body_multiplier)
    return sum(d["operand_bytes"] for d in stats.values())
