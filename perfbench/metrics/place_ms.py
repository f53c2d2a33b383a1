"""Device ms of one call of the program's placement (``place``, or
``place_replicas`` for R replicas) on the run's final state, after the
check's copies, the mean of back-to-back calls between CUDA events."""


def read(ctx):
    return ctx.get("place_ms")
