"""The NVIDIA H100 SXM's data-sheet figures (dense, no sparsity), at its
700 W limit.  Copied from the port's ``launch/roofline.py`` and
``chip_smoke.py`` (not imported: the yardstick does not move with the
program)."""
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "float32": 67e12,      # outside the tensor cores
    "tf32": 494.7e12,
    "int8": 1979e12,
    "float8": 1979e12,
}
