"""Reduce a torch.profiler trace of a few steps to what the per-layer
metrics read: the device's busy time (the union of its kernel, copy and
set intervals) in the traced window, the window's length, each kernel's
time, the time of each kernel phase (``phases/*.json``), the kernels a
step, and the breakdown: the device operations that took most time and
the longest idle gaps, by what the host was doing then.

The trace goes through the profiler's Chrome-trace export, written to a
temporary file under ``TMPDIR`` and deleted once read.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function"}
WINDOW = "perfbench.window"


def kernel_name(name: str) -> str:
    """A kernel's own name: no return type, template arguments or
    parameters (``void ns::foo<1>(float*)`` -> ``foo``)."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    depth, out = 0, []
    for ch in base:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    base = "".join(out).strip().split(" ")[-1]
    return re.sub(r"^.*::", "", base) or name


def profile(advance, steps: int) -> list:
    """Run ``advance(steps)`` under the profiler; its trace's events."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            advance(steps)
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals):
    total, end = 0.0, -float("inf")
    gaps = []
    for a, b in sorted(intervals):
        if a > end:
            if end > -float("inf"):
                gaps.append((end, a))
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total, gaps


def reduce(events: list, steps: int, phases: dict) -> dict:
    """The summary the metric readers take (times in seconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    t0 = min(e["ts"] for e in win) if win else min(e["ts"] for e in xs)
    t1 = max(e["ts"] + e["dur"] for e in win) if win else \
        max(e["ts"] + e["dur"] for e in xs)
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and t0 <= e["ts"] <= t1]
    host = [e for e in xs if e.get("cat") in HOST_CATS
            and e.get("name") != WINDOW]
    busy, gaps = _union((e["ts"], min(e["ts"] + e["dur"], t1)) for e in dev)
    if dev:
        first = min(e["ts"] for e in dev)
        last = max(e["ts"] + e["dur"] for e in dev)
        gaps = [(t0, first)] + gaps + [(last, t1)]
    by_name = collections.Counter()
    n_kernels = 0
    for e in dev:
        name = kernel_name(e["name"]) if e["cat"] == "kernel" else e["name"]
        by_name[name] += e["dur"] * 1e-6
        n_kernels += e["cat"] == "kernel"
    phase_s = {ph: sum(s for k, s in by_name.items() if k in names)
               for ph, names in phases.items()}
    host.sort(key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    idle = collections.Counter()
    for a, b in gaps:
        if b > a:
            idle[_host_at(host, starts, 0.5 * (a + b))] += (b - a) * 1e-6
    return {
        "busy_s": busy * 1e-6, "window_s": (t1 - t0) * 1e-6,
        "steps": steps, "n_kernels": n_kernels, "phase_s": phase_s,
        "device_ops": by_name.most_common(10),
        "idle_gaps": idle.most_common(10),
    }


def _host_at(host: list, starts: list, t: float, reach: int = 4096) -> str:
    """The innermost host event running at time ``t``: of nested events
    the one that started last (``host`` sorted by start)."""
    i = bisect.bisect_right(starts, t)
    for e in reversed(host[max(0, i - reach):i]):
        if e["ts"] + e["dur"] >= t:
            return e["name"]
    return "host between operations"


def count_syncs(advance, steps: int) -> int:
    """The operations that wait for the card in ``steps`` steps, from
    PyTorch's sync debug mode."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            advance(steps)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return len(caught)


def time_calls(call, reps: int = 50, warmup: int = 5) -> float:
    """Mean device ms of ``call()`` by CUDA events around ``reps``
    back-to-back calls."""
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        call()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps
