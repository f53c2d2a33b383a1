"""Launches of K2's step loop a step over the measured window
(``FastState.n_launches`` before and after it)."""


def read(ctx):
    w = ctx.get("window")
    if not w or w.get("launches") is None or w["steps"] <= 0:
        return None
    return w["launches"] / w["steps"]
