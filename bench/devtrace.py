"""Reading a ``torch.profiler`` trace (its Chrome JSON export).

The union of the device operations' intervals (``busy_us``) is
``scripts/model_profile.py``'s ``_busy_ms``, and the kernel groups its
``_group``; the device time of kernels inside a harness range is its
``_projection_ms``, here by the range the host launched them from (the
launch's correlation id), so nested and short ranges need no device-side
span.  Copied, not imported: the yardstick stays with the benchmark.
"""
from __future__ import annotations

import bisect
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the prefix of every range the harness opens (torch.profiler.record_function)
RANGE_PREFIX = "bench."

Interval = Tuple[float, float]


class Trace:
    """The events of one profiled slice, in microseconds."""

    def __init__(self, events: List[dict]):
        self.ops = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.ranges: Dict[str, List[Interval]] = {}
        for e in events:
            if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(RANGE_PREFIX):
                self.ranges.setdefault(e["name"], []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))))
        for v in self.ranges.values():
            v.sort()
        self.launch: Dict[int, float] = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS:
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    self.launch[int(c)] = float(e["ts"])

    @classmethod
    def load(cls, path: Path) -> "Trace":
        data = json.loads(Path(path).read_text())
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events)

    # ------------------------------------------------------------ device
    def op_intervals(self, ops: Optional[Iterable[dict]] = None) -> List[Interval]:
        ops = self.ops if ops is None else ops
        return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in ops)

    def busy_us(self, ops: Optional[Iterable[dict]] = None) -> float:
        return union_length(self.op_intervals(ops))

    def window_us(self) -> Interval:
        """The profiled slice: the harness's ``bench.slice`` range."""
        (a, b), = self.ranges["bench.slice"]
        return a, b

    def launched_in(self, name: str) -> List[dict]:
        """Device operations whose launch lies inside a ``name`` range."""
        spans = self.ranges.get(name, [])
        starts = [a for a, _ in spans]
        out = []
        for e in self.ops:
            c = (e.get("args") or {}).get("correlation")
            t = self.launch.get(int(c)) if c is not None else None
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append(e)
        return out

    def device_us(self, ops: Iterable[dict]) -> float:
        return sum(float(e["dur"]) for e in ops)

    # --------------------------------------------------------- breakdown
    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for e in self.ops:
            name = str(e["name"]).split("(")[0][:80]
            by[name] = by.get(name, 0.0) + float(e["dur"])
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e6] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest stretches of the slice with no device operation,
        each named by the innermost harness range the host was in at its
        middle."""
        w0, w1 = self.window_us()
        gaps = []
        cursor = w0
        for a, b in merge(self.op_intervals()):
            if a > cursor:
                gaps.append((cursor, min(a, w1)))
            cursor = max(cursor, b)
        if cursor < w1:
            gaps.append((cursor, w1))
        gaps = [(a, b) for a, b in gaps if b > a]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_range_at((a + b) / 2), (b - a) / 1e6] for a, b in gaps[:n]]

    def host_range_at(self, t: float) -> str:
        best, width = "host outside the harness's ranges", float("inf")
        for name, spans in self.ranges.items():
            if name == "bench.slice":
                continue
            # the ranges of one name do not overlap: only the last one
            # that starts before t can hold it
            i = bisect.bisect_right([a for a, _ in spans], t) - 1
            if i >= 0 and spans[i][1] >= t and spans[i][1] - spans[i][0] < width:
                best, width = name, spans[i][1] - spans[i][0]
        return best


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def union_length(intervals: Sequence[Interval]) -> float:
    return sum(b - a for a, b in merge(intervals))
