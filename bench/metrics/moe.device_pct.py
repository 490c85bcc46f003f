"""The share of the traced slice's device busy time spent by operations
launched inside a ``bench.moe`` range (``moe_apply``: the router, the
dispatch and the experts' products), as a union of intervals over the
union of all."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    ops = t.launched_in("bench.moe")
    busy = t.busy_us()
    if not ops or busy <= 0:
        return None
    return 100.0 * t.busy_us(ops) / busy
