"""Design-space exploration.  Only the scenario corpus
(:mod:`repro_torch.explore.workloads`) is ported so far: it is the test
corpus the parity tests compile through both packages."""
from .workloads import CORPORA, Workload, get_workloads

__all__ = ["Workload", "get_workloads", "CORPORA"]
