"""The mean of the engine's ``serve.decode_step`` spans (``obs.trace``)
that started in the window, in ms."""


def read(ctx):
    ds = [s.dur for s in ctx.spans if s.name == "serve.decode_step"]
    return 1e3 * sum(ds) / len(ds) if ds else None
