"""Measured-feedback autotuning.

Three pieces close the loop between the analytic cost model and real
measurement:

* :mod:`repro_torch.tune.db` — the persistent :class:`TuningDB` keyed by
  IR fingerprint x hardware fingerprint x backend x interpret-mode
  (interpret: measured on the kernels' plain versions, not on the card),
  recording measured candidate tilings and serving the measured best
  back into ``stripe_jit`` (decision source ``tuned``);
* :mod:`repro_torch.tune.measure` — the min-of-interleaved-rounds timing
  harness every DB-feeding measurement goes through;
* :mod:`repro_torch.tune.calibrate` — robust per-term regression fitting
  ``measured ~= a*t_mem + b*t_compute + c`` from accumulated residual
  pairs, activated per hardware fingerprint so ``evaluate_tiling``
  predicts calibrated latencies.
"""
from . import calibrate
from .calibrate import (
    Calibration,
    clear_calibrations,
    fit_calibration,
    get_calibration,
    load_calibrations,
    save_calibrations,
    set_calibration,
)
from .db import TunedEntry, TuningDB, candidate_id, entry_key
from .measure import Measurement, measure_interleaved

__all__ = [
    "Calibration",
    "Measurement",
    "TunedEntry",
    "TuningDB",
    "calibrate",
    "candidate_id",
    "clear_calibrations",
    "entry_key",
    "fit_calibration",
    "get_calibration",
    "load_calibrations",
    "measure_interleaved",
    "save_calibrations",
    "set_calibration",
]
