"""The least time the problem's pair, bond and spring work of a step could
take (``perfbench.roofline``) over the pair phase's device time a step
(``phases/pair.json``), in %."""


def read(ctx):
    t, w = ctx.get("trace"), ctx.get("work")
    if not t or not w or t["phase_s"].get("pair", 0.0) <= 0:
        return None
    return 100.0 * w["pair_s"] / (t["phase_s"]["pair"] / t["steps"])
