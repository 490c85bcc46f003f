"""The projections' roofline share (see ``_roofline.py``), in the cells
that this name's end-to-end metric is reported in."""
from bench.spec import BENCH, load_module

read = load_module(BENCH / "metrics" / "_roofline.py").read
