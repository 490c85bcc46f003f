"""Measured-feedback tuning.  Only the cost-model calibration registry
(:mod:`repro_torch.tune.calibrate`) is ported so far: the cost model
consults it on every candidate tiling."""
from . import calibrate

__all__ = ["calibrate"]
