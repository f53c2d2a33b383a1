"""The share of the traced window in which no kernel, copy or set ran on
the card (torch.profiler's trace: the union of the device's intervals)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
