"""The wave engine's prefill calls of the waves in the window (host
clock after ``torch.cuda.synchronize()``, around the model's
``prefill``), summed, in ms, over the waves' real prompt tokens (padding
left out), in thousands."""


def read(ctx):
    if not ctx.waves:
        return None
    tokens = sum(s.plen for w in ctx.waves for s in w.members)
    return 1e3 * sum(w.prefill_s for w in ctx.waves) / (tokens / 1e3)
