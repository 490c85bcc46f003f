"""The share of the traced slice in which no operation ran on the
device: 1 - the union of the device operations' intervals over the
slice."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    w0, w1 = t.window_us()
    return 100.0 * (1.0 - t.busy_us() / (w1 - w0))
