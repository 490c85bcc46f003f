"""The share of the decode steps' slots that held a live request in the
window: the delta of ``ServingEngine.metrics()``' ``slot_utilization``
times ``decode_steps`` (live slot-steps) over the delta of the steps
times the slots."""


def read(ctx):
    c0, c1 = ctx.counters
    if "live_slot_steps" not in c0:
        return None
    steps = c1["decode_steps"] - c0["decode_steps"]
    if steps <= 0:
        return None
    return 100.0 * (c1["live_slot_steps"] - c0["live_slot_steps"]) / (steps * ctx.mix["slots"])
