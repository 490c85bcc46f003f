"""Online cost-model calibration from measured residuals.

The roofline/pipeline model predicts per-block latency from two terms —
HBM traffic time ``t_mem`` and compute time ``t_compute`` — priced at
datasheet peaks.  Real dispatch never hits datasheet peaks, so the
profiling residual log accumulates (predicted, measured) pairs with a
large systematic bias.  This module fits per-term scale coefficients

    measured  ~=  a * t_mem_raw  +  b * t_compute_raw  +  c

by iteratively-reweighted least squares with Huber weights (pure numpy,
robust to outlier dispatches), clamped non-negative.  With too few pairs
or a degenerate design matrix it degrades to a single geometric-mean
scale on both terms — the gmean bias correction.

A fitted :class:`Calibration` is **hardware-fingerprint scoped**:
``set_calibration`` activates it in a process-wide registry keyed by
``HardwareConfig.fingerprint()``, and ``cost.evaluate_tiling`` applies
the active calibration's scales to its roofline terms — so the autotile
search, ``score_pass_trace``, and the explore sweeps all rank candidates
on *calibrated* predictions.  The calibration fingerprint enters the
compilation-cache key (calibrated and uncalibrated artifacts never
collide), and calibrations persist as ``calibration.json`` next to the
tuning DB.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

from ..core.cache import stable_hash

CALIBRATION_NAME = "calibration.json"

# fewer (term-bearing) pairs than this and the per-term fit is
# under-determined — fall back to the single gmean scale
MIN_PAIRS_FOR_FIT = 4


@dataclasses.dataclass
class Calibration:
    """Per-term scale coefficients for one hardware fingerprint."""

    hw_fingerprint: str = ""
    scale_mem: float = 1.0
    scale_compute: float = 1.0
    overhead_s: float = 0.0
    n_pairs: int = 0
    method: str = ""      # "irls" | "gmean"
    backend: str = ""     # measurement backend the pairs came from
    ts: float = 0.0

    def fingerprint(self) -> str:
        """Cache-key component: any coefficient change re-keys every
        artifact compiled under this calibration."""
        return stable_hash([
            "calibration", self.hw_fingerprint,
            round(self.scale_mem, 9), round(self.scale_compute, 9),
            round(self.overhead_s, 12),
        ])[:16]

    def apply(self, t_mem: float, t_compute: float) -> tuple:
        return t_mem * self.scale_mem, t_compute * self.scale_compute

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "Calibration":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


# --------------------------------------------------------------------------
# Fitting
# --------------------------------------------------------------------------
def _gmean_scale(pairs: List[tuple]) -> Optional[float]:
    logs = [math.log(m / p) for p, m in pairs if p > 0 and m > 0]
    if not logs:
        return None
    return math.exp(sum(logs) / len(logs))


def fit_calibration(rows: List[Mapping[str, Any]], hw_fingerprint: str = "",
                    backend: str = "", iters: int = 10) -> Optional[Calibration]:
    """Fit a :class:`Calibration` from residual-log rows.

    Rows carrying raw roofline terms (``t_mem_raw``/``t_compute_raw``,
    written by profiled compiles) feed the per-term IRLS fit; rows with
    only ``predicted_s`` still contribute to the gmean fallback.  Returns
    None when no usable pair exists.
    """
    import time

    import numpy as np

    term_rows = []
    pred_pairs = []
    for r in rows:
        m = r.get("measured_s")
        if not m or m <= 0:
            continue
        tm, tc = r.get("t_mem_raw"), r.get("t_compute_raw")
        if tm is not None and tc is not None and (tm > 0 or tc > 0):
            term_rows.append((float(tm), float(tc), float(m)))
        p = r.get("predicted_s")
        if p and p > 0:
            pred_pairs.append((float(p), float(m)))

    cal = Calibration(hw_fingerprint=hw_fingerprint, backend=backend,
                      ts=time.time())

    if len(term_rows) >= MIN_PAIRS_FOR_FIT:
        X = np.array([[tm, tc, 1.0] for tm, tc, _ in term_rows])
        y = np.array([m for _, _, m in term_rows])
        # columns with no variation (e.g. every block pure-compute) make
        # the normal equations singular; lstsq handles rank deficiency.
        # Robustness is two-stage per iteration: hard-reject gross
        # outliers (> 3.5 sigma by MAD — Huber alone barely discounts a
        # dispatch 1000x off, e.g. a GC pause) and Huber-weight the rest.
        w = np.ones(len(y))
        beta = np.zeros(3)
        for _ in range(max(int(iters), 1)):
            Xw = X * w[:, None]
            beta, *_ = np.linalg.lstsq(Xw, y * w, rcond=None)
            resid = y - X @ beta
            a = np.abs(resid)
            # MAD sigma, floored so near-exact fits don't reject everything
            scale = max(np.median(a) * 1.4826,
                        1e-6 * float(np.median(np.abs(y))), 1e-30)
            k = 1.345 * scale
            w = np.sqrt(np.where(a <= k, 1.0, k / a))
            keep = a <= 3.5 * scale
            if keep.sum() >= MIN_PAIRS_FOR_FIT:
                w = np.where(keep, w, 0.0)
        a_mem, b_comp, c = (max(float(beta[0]), 0.0),
                            max(float(beta[1]), 0.0),
                            max(float(beta[2]), 0.0))
        if a_mem > 0 or b_comp > 0:
            cal.scale_mem, cal.scale_compute = a_mem, b_comp
            cal.overhead_s = c
            cal.n_pairs = len(term_rows)
            cal.method = "irls"
            # a term the fit zeroed out (column had no signal) keeps the
            # other term's scale so its predictions move the same way
            if cal.scale_mem == 0.0:
                cal.scale_mem = cal.scale_compute
            if cal.scale_compute == 0.0:
                cal.scale_compute = cal.scale_mem
            return cal

    s = _gmean_scale(pred_pairs)
    if s is None:
        return None
    cal.scale_mem = cal.scale_compute = s
    cal.n_pairs = len(pred_pairs)
    cal.method = "gmean"
    return cal


# --------------------------------------------------------------------------
# The process-wide active registry (what evaluate_tiling consults)
# --------------------------------------------------------------------------
_ACTIVE: Dict[str, Calibration] = {}


def any_active() -> bool:
    """Fast-path guard for the per-candidate cost-model hook."""
    return bool(_ACTIVE)


def set_calibration(cal: Calibration) -> None:
    if not cal.hw_fingerprint:
        raise ValueError("calibration needs a hw_fingerprint to scope to")
    _ACTIVE[cal.hw_fingerprint] = cal


def get_calibration(hw_fingerprint: str) -> Optional[Calibration]:
    return _ACTIVE.get(hw_fingerprint)


def clear_calibrations() -> None:
    _ACTIVE.clear()


def active_fingerprint(hw_fingerprint: str) -> str:
    """The cache-key component for one hardware config: the active
    calibration's fingerprint, or "" when predictions are raw."""
    cal = _ACTIVE.get(hw_fingerprint)
    return cal.fingerprint() if cal is not None else ""


# --------------------------------------------------------------------------
# Persistence (next to the tuning DB)
# --------------------------------------------------------------------------
def save_calibrations(dir: os.PathLike, name: str = CALIBRATION_NAME,
                      cals: Optional[List[Calibration]] = None) -> Optional[Path]:
    """Persist calibrations (default: every active one) as JSON under
    ``dir``; atomic publish, I/O failures swallowed (returns None)."""
    path = Path(dir) / name
    doc = {"version": 1,
           "calibrations": [c.to_json() for c in
                            (cals if cals is not None else _ACTIVE.values())]}
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, sort_keys=True, indent=1)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except OSError:
        return None
    return path


def load_calibrations(dir: os.PathLike, name: str = CALIBRATION_NAME,
                      activate: bool = True) -> List[Calibration]:
    """Load persisted calibrations; ``activate`` installs them in the
    process registry.  A missing or corrupt file is an empty list."""
    path = Path(dir) / name
    try:
        doc = json.loads(path.read_text())
        cals = [Calibration.from_json(d) for d in doc.get("calibrations", [])
                if isinstance(d, dict)]
    except (OSError, ValueError, TypeError):
        return []
    if activate:
        for c in cals:
            if c.hw_fingerprint:
                _ACTIVE[c.hw_fingerprint] = c
    return cals
