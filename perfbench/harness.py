"""One run of one cell: set-up, the measured window, the check against the
reference and, with ``trace``, the per-layer readings.

Set-up (``setup_s``, from the process's start to the window's first
step): imports and CUDA's start, the scene from the seed, the program's
System and State, the configuration's thermalize and settle on the fast
engine, the cell's driver and its warm-up segment (which builds and
captures whatever the window runs).  The window then drives whole
segments of the cell's entry until ``seconds`` have passed, each ending
in a synchronize, and counts beads x replicas x steps over its wall
time.  After it: the peak of device memory; with ``trace`` the traced
stretches, taken from the window's final state before anything else
drives the program, so that they hold LE events in the window's share;
the program driven on to the check's copies and their replays; with
``trace`` the placement timed on the final state; the program's state
freed, then the reference.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from . import build, check, roofline, spec
from . import trace as tr
from .drivers import DRIVERS
from .scene import make_scene

FORBIDDEN = ("jax", "jaxlib", "flax", "lammps_le_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole)
    is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(driver, work, seconds: float, device) -> dict:
    """Whole segments until ``seconds`` have passed."""
    seg = work["segment_steps"]
    launches0 = driver.launches
    steps = 0
    ends = []
    sync(device)
    t0 = time.perf_counter()
    while True:
        driver.advance(seg)
        steps += seg
        sync(device)
        wall = time.perf_counter() - t0
        ends.append(wall)
        if wall >= seconds:
            break
    return {"steps": steps, "wall_s": wall, "segment_ends_s": ends,
            "launches": driver.launches - launches0 if driver.loop else None}


def segment_spread(win) -> dict:
    """The window's segments' wall times: quartiles, the largest and how
    many took over twice the median (a host that stood still)."""
    ends = win["segment_ends_s"]
    times = sorted(b - a for a, b in zip([0.0] + ends[:-1], ends))
    q = statistics.quantiles(times, n=4) if len(times) > 1 else times * 3
    return {"segments": len(times), "quartiles_s": q, "max_s": times[-1],
            "over_twice_median": sum(t > 2 * q[1] for t in times)}


def traced_stretches(driver, work, cfg, scene, device) -> dict:
    """Right after the window: the problem's work at the window's final
    positions, a profiled stretch, then a sync-counted stretch."""
    lo = torch.tensor(scene.box_lo, dtype=torch.float64, device=device)
    box = torch.tensor(scene.box_hi, dtype=torch.float64, device=device) - lo
    w = {"pair_s": 0.0, "stream_s": 0.0}
    for b in driver.beads(driver.state):
        one = roofline.work(b["x"].to(device, torch.float64), lo, box,
                            cfg["pair"]["cutoff"], scene.n - 1,
                            int((b["ex_left"] >= 0).sum()))
        w["pair_s"] += one["pair_s"]
        w["stream_s"] += one["stream_s"]
    steps = work["trace_steps"]
    events = tr.profile(driver.advance, steps)
    summary = tr.reduce(events, steps, spec.phases())
    del events
    nsync = work["sync_steps"]
    syncs = {"count": tr.count_syncs(driver.advance, nsync), "steps": nsync}
    return {"trace": summary, "syncs": syncs, "work": w}


def place_ms(driver):
    """The program's placement timed on the driver's state."""
    call = driver.place_call()
    return tr.time_calls(call) if call is not None else None


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", cfg=None, work=None,
             bench=None) -> tuple:
    """Run cell ``name`` once.  Returns (result line dict, check rows)."""
    work = work or spec.workload(name)
    cfg = cfg or spec.config(work["config"])
    bench = bench or spec.benchmark()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    split = {"imports_and_cuda_init": time.perf_counter() - t_start}
    t = time.perf_counter()
    scene = make_scene(cfg, seed)
    system = build.program_system(cfg, scene)
    split["scene_and_system"] = time.perf_counter() - t
    t = time.perf_counter()
    state = build.settle(cfg, scene, system, device)
    sync(device)
    split["thermalize_and_settle"] = time.perf_counter() - t
    t = time.perf_counter()
    driver = DRIVERS[work["driver"]](cfg, work, system, state, device)
    del state
    driver.warm(work["warm_steps"])
    sync(device)
    split["entry_and_warm_up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    win = window(driver, work, seconds, device)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    win["bead_steps"] = scene.n * work["replicas"] * win["steps"]
    ctx = {"window": win}
    if trace:
        ctx.update(traced_stretches(driver, work, cfg, scene, device))
    plan = check.Plan(cfg, work["check_steps"])
    check.complete(plan, driver, work)
    final = [check.on_host(b) for b in driver.beads(driver.state)]
    pairs = check.program_side(driver, plan)
    if trace:
        ctx["place_ms"] = place_ms(driver)
    plan_missing = len(plan.missing)
    del driver, plan
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    params = build.reference_params(cfg, scene, device)
    compared = check.reference_side(pairs, params, work["check_steps"],
                                    device)
    correct, rows = check.verdict(compared, work["limits"],
                                  check.health(final, cfg), plan_missing)

    if trace:
        metrics = {}
        for m in spec.cell_metrics(bench, name, True):
            val = spec.metric(m["name"]).read(ctx)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        ends = {"bead_steps_per_s": win["bead_steps"] / win["wall_s"],
                "peak_device_bytes": float(peak), "setup_s": setup_s}
        metrics = {m["name"]: {"value": ends[m["name"]], "unit": m["unit"]}
                   for m in spec.cell_metrics(bench, name, False)}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": len(rows),
            "failed": sum(not ok for *_, ok in rows), "metrics": metrics,
            "device": dev}
    if trace:
        t = ctx["trace"]
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        line["breakdown"] = {"device_ops": [list(p) for p in t["device_ops"]],
                             "idle_gaps": [list(p) for p in t["idle_gaps"]]}
    line["window"] = {"steps": win["steps"], "bead_steps": win["bead_steps"],
                      "wall_s": win["wall_s"], **segment_spread(win)}
    line["setup_split_s"] = split
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in rows}
    return line, rows
