"""The device's idle share of the traced slice (see ``_idle.py``)."""
from bench.spec import BENCH, load_module

read = load_module(BENCH / "metrics" / "_idle.py").read
