"""The MoE dispatch's device time (``nn/moe.py``'s ``moe.dispatch`` spans
that started in the window: the one-hot, the running count, the
positions, and the scatter into the experts' rows; each span's
``device_dur``, CUDA events on the stream), summed, in ms, over the
tokens they routed (every layer's call counts its own), in thousands.
None off the card, or where the program has no such span."""


def read(ctx):
    spans = [s for s in ctx.spans if s.name == "moe.dispatch"]
    dur = [getattr(s, "device_dur", None) for s in spans]
    tokens = sum(s.attrs["tokens"] for s in spans)
    if not spans or None in dur or tokens <= 0:
        return None
    return 1e3 * sum(dur) / (tokens / 1e3)
