"""Beads x replicas x steps of the measured window over its wall time, as
the cells whose pace the host sets read it: the same number the end-to-end
``bead_steps_per_s`` would be, reported per layer where it spreads from
process to process with the host's speed."""


def read(ctx):
    w = ctx.get("window")
    if not w or not w.get("bead_steps") or w["wall_s"] <= 0:
        return None
    return w["bead_steps"] / w["wall_s"]
