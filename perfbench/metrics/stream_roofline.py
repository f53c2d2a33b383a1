"""The least time the problem's kick, drift and thermostat work of a step
could take (``perfbench.roofline``) over the streaming phase's device
time a step (``phases/stream.json``), in %."""


def read(ctx):
    t, w = ctx.get("trace"), ctx.get("work")
    if not t or not w or t["phase_s"].get("stream", 0.0) <= 0:
        return None
    return 100.0 * w["stream_s"] / (t["phase_s"]["stream"] / t["steps"])
