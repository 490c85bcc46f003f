"""The engine's ``serve.prefill`` spans (``obs.trace``) that started in
the window, summed, in ms, over the prompt tokens they prefilled, in
thousands."""


def read(ctx):
    plen = {s.index: s.plen for s in ctx.served}
    spans = [s for s in ctx.spans if s.name == "serve.prefill"]
    tokens = sum(plen[s.attrs["uid"]] for s in spans)
    return 1e3 * sum(s.dur for s in spans) / (tokens / 1e3) if tokens else None
