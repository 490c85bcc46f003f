"""The Mamba2 layers' device time (``nn/ssm.py``'s ``ssm.mixer`` spans
that started in the window: a layer's projections, conv, scan and gated
norm; each span's ``device_dur``, CUDA events on the stream), summed, in
ms, over the token rows they computed (``tokens``, every layer's call
counting its own, padding included), in thousands.  None off the card,
or where the program has no such span."""


def read(ctx):
    spans = [s for s in ctx.spans if s.name == "ssm.mixer"]
    dur = [getattr(s, "device_dur", None) for s in spans]
    tokens = sum(s.attrs["tokens"] for s in spans)
    if not spans or None in dur or tokens <= 0:
        return None
    return 1e3 * sum(dur) / (tokens / 1e3)
