"""Operations that waited for the card, a step, over the sync window
(PyTorch's sync debug mode, counted)."""


def read(ctx):
    s = ctx.get("syncs")
    if not s or s["steps"] <= 0:
        return None
    return s["count"] / s["steps"]
