"""The whole step's share of the bf16 peak (see ``_mfu.py``)."""
from bench.spec import BENCH, load_module

read = load_module(BENCH / "metrics" / "_mfu.py").read
