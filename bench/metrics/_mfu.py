"""The whole step's share of the card's bf16 peak in the traced slice:
the model FLOPs of every token served there (2 x the active matrix
parameters a token, attention over its context, the LM head for each
token emitted; ``bench/work.py``) over the slice's length x 989 TFLOP/s."""
from bench import peaks


def read(ctx):
    if ctx.trace is None or ctx.slice_s <= 0 or ctx.slice_flops <= 0:
        return None
    return 100.0 * ctx.slice_flops / (ctx.slice_s * peaks.PEAK_FLOPS["bfloat16"])
