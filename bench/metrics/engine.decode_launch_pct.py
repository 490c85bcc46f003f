"""The share of the engine's decode steps that the host spends enqueuing
them: the ``serve.decode_launch`` spans (``serving/engine.py``: the
decode call, up to the wait for its tokens) over the ``serve.decode_step``
spans they nest in, host clock, both summed over the window.  Near 100%
the host sets the step's pace, by its launches or by a wait on the
device hidden in them.  None where the program has no such span."""


def read(ctx):
    launch = sum(s.dur for s in ctx.spans if s.name == "serve.decode_launch")
    step = sum(s.dur for s in ctx.spans if s.name == "serve.decode_step")
    if launch <= 0 or step <= 0:
        return None
    return 100.0 * launch / step
