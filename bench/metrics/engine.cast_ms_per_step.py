"""The block programs' weight casts a decode step: the ``device_dur`` of
the ``block.cast`` spans (``serving/stripe_decode.py``: each group of
bf16 -> float32 weight casts, CUDA events on the stream) that lie inside
a ``serve.decode_step`` span (same thread, start within its interval),
summed, in ms, over the decode steps that started in the window.  None
off the card, or where the program has no such span."""
import bisect


def read(ctx):
    steps = {}
    for s in ctx.spans:
        if s.name == "serve.decode_step":
            steps.setdefault(s.tid, []).append((s.ts, s.ts + s.dur))
    for v in steps.values():
        v.sort()
    starts = {tid: [a for a, _ in v] for tid, v in steps.items()}
    dur = []
    for s in ctx.spans:
        if s.name != "block.cast" or s.tid not in steps:
            continue
        i = bisect.bisect_right(starts[s.tid], s.ts) - 1
        if i >= 0 and s.ts <= steps[s.tid][i][1]:
            dur.append(getattr(s, "device_dur", None))
    if not dur or None in dur:
        return None
    return 1e3 * sum(dur) / sum(len(v) for v in steps.values())
