"""Measured-feedback tuning.  Ported so far: the cost-model calibration
registry (:mod:`repro_torch.tune.calibrate`, which the cost model consults
on every candidate tiling) and the min-of-interleaved-rounds timing harness
(:mod:`repro_torch.tune.measure`, which the sweep's measured validation
uses).  The tuning DB is not ported yet (ROADMAP A6)."""
from . import calibrate
from .measure import Measurement, measure_interleaved

__all__ = ["calibrate", "Measurement", "measure_interleaved"]
