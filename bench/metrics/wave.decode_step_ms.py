"""The mean of the wave engine's decode calls in the window (host clock
after ``torch.cuda.synchronize()``, around the model's
``decode_step``), in ms."""


def read(ctx):
    ds = [d for w in ctx.waves for d in w.decode_s]
    return 1e3 * sum(ds) / len(ds) if ds else None
