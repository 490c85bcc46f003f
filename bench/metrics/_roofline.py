"""The projections' roofline share in the traced slice: the least time
the card could take for every projection product recorded there (each
weight and activation read once and each output written once in the
configuration's type, or its operations at the type's peak, whichever is
larger; ``bench/work.py``) over the device time of the operations
launched inside the ``bench.proj`` ranges (casts of the weights
included)."""
from bench import work


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.products:
        return None
    ops = t.launched_in("bench.proj")
    spent = t.device_us(ops) / 1e6
    if spent <= 0:
        return None
    bound = sum(work.matmul_bound_s(m, k, n, ctx.arch["dtype"]) for m, k, n in ctx.products)
    return 100.0 * bound / spent
