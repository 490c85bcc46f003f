"""The share of the Mamba2 layers' device time spent in their scan: the
``device_dur`` of the window's ``ssm.scan`` spans (``nn/ssm.py``: the
chunked scan and the prefill's final state, or the one-token update)
over that of the ``ssm.mixer`` spans they nest in, in %.  None off the
card, or where the program has no such span."""


def read(ctx):
    mixer = [getattr(s, "device_dur", None) for s in ctx.spans if s.name == "ssm.mixer"]
    scan = [getattr(s, "device_dur", None) for s in ctx.spans if s.name == "ssm.scan"]
    if not mixer or not scan or None in mixer or None in scan or sum(mixer) <= 0:
        return None
    return 100.0 * sum(scan) / sum(mixer)
