"""The share of the (token, choice) pairs that the MoE dispatch's
capacity dropped: the ``dropped`` counts of the ``moe.dispatch`` spans
that started in the window over their ``pairs``.  None where the
program has no such span."""


def read(ctx):
    spans = [s for s in ctx.spans if s.name == "moe.dispatch" and "dropped" in s.attrs]
    pairs = sum(s.attrs["pairs"] for s in spans)
    if pairs <= 0:
        return None
    return 100.0 * sum(s.attrs["dropped"] for s in spans) / pairs
