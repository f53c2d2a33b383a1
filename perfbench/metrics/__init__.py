"""Per-layer metrics, one module each, found by name: ``read(ctx)``
returns the metric's value, or None where the run has nothing to read
(then the result line leaves the metric out).  ``ctx`` is the traced
run's context (``perfbench.harness.traced_stretches``, ``place_ms``)."""
