"""Readings that set the limits and the cap, on the card, in one process:

    python -m perfbench.calibrate --workload le100k.loop --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 3 [--cap N --count-cells]

For each seed: the cell's set-up and a window of ``seconds``, the check's
replays, then the reference's readings of the program (the lower
readings of the limits) and, for the control seeds, of the control: the
reference computed in bfloat16, the nearest precision below the
configuration's float32, put in the program's place (the upper
readings).  With ``--count-cells`` every placement the program makes is
binned again by the grid's rule (``cell_counts``, computed on the card)
and the fullest cell's count kept: the cap search, run at a cap
(``--cap``) that nothing overflows.

    python -m perfbench.calibrate --workload le100k.loop --seeds 1 \
        --endurance 250000

runs the cell's set-up and then ``--endurance`` steps, whole segments,
and reads the health rule on the final state (the flags are sticky), the
fullest cell of every placement and the most extruders any replica held
at a segment's end: that the deployment stays healthy, its cells under
the cap and its table under its size, well past the steps a window
reaches.
Writes a JSON line a seed to standard output.  Not run by the benchmark.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from . import build, check, spec
from .drivers import DRIVERS
from .harness import sync, window
from .scene import make_scene


def cell_counts(x, lo, box, dims) -> np.ndarray:
    """Beads a cell of the nx x ny x nz grid at positions ``x`` ((N, 3),
    any image), counted with numpy in f64: each coordinate wrapped into
    the box and binned by its fraction of it."""
    dims = np.asarray(dims)
    frac = (np.asarray(x, np.float64) - lo) / box
    frac -= np.floor(frac)
    cell = np.minimum((frac * dims).astype(np.int64), dims - 1)
    return np.bincount(np.ravel_multi_index(cell.T, dims),
                       minlength=int(dims.prod()))


class Fullest:
    """Wraps the program's placement functions to bin every placement's
    positions again (``cell_counts``' rule, on the card: no copy to the
    host) and keep the fullest cell's count."""

    def __init__(self, system):
        nb = system.neighbor
        self.dims = (nb.nx, nb.ny, nb.nz)
        self.lo = np.asarray(system.box_lo, np.float64)
        self.box = np.asarray(system.box_size, np.float64)
        self.most = None
        self.placements = 0

    def count(self, x):
        lo = torch.as_tensor(self.lo, device=x.device)
        box = torch.as_tensor(self.box, device=x.device)
        dims = torch.as_tensor(self.dims, device=x.device)
        frac = (x.reshape(-1, x.shape[-2], 3).to(torch.float64) - lo) / box
        frac = frac - torch.floor(frac)
        cell = torch.minimum((frac * dims).to(torch.int64), dims - 1)
        flat = (cell[..., 0] * dims[1] + cell[..., 1]) * dims[2] \
            + cell[..., 2]
        most = max(torch.bincount(row, minlength=int(dims.prod())).max()
                   for row in flat)
        self.most = most if self.most is None else torch.maximum(self.most,
                                                                 most)

    def wrap(self, fn):
        def placed(system, maps, g, x, *rest):
            self.count(x.detach())
            self.placements += 1
            return fn(system, maps, g, x, *rest)
        return placed


class counting_cells:
    """Within the block, every placement the program makes is counted by
    ``Fullest`` (``None``: nothing counted)."""

    def __init__(self, system, on: bool):
        self.full = Fullest(system) if on else None

    def __enter__(self):
        import lammps_le_torch.fast.engine as engine

        self.saved = (engine.place, engine.place_replicas)
        if self.full is not None:
            engine.place = self.full.wrap(self.saved[0])
            engine.place_replicas = self.full.wrap(self.saved[1])
        return self.full

    def __exit__(self, *exc):
        import lammps_le_torch.fast.engine as engine

        engine.place, engine.place_replicas = self.saved


def endurance(work, cfg, seed, steps, device) -> dict:
    """The cell's set-up, then ``steps`` steps in whole segments (see the
    module's docstring)."""
    scene = make_scene(cfg, seed)
    system = build.program_system(cfg, scene)
    with counting_cells(system, True) as full:
        state = build.settle(cfg, scene, system, device)
        driver = DRIVERS[work["driver"]](cfg, work, system, state, device)
        driver.warm(work["warm_steps"])
        start = driver.step
        most = None
        seg = work["segment_steps"]
        t0 = time.perf_counter()
        while driver.step - start < steps:
            driver.advance(seg)
            left = driver.state.ex_left
            held = (left >= 0).reshape(-1, left.shape[-1]).sum(-1).max()
            most = held if most is None else torch.maximum(most, held)
        sync(device)
        wall = time.perf_counter() - t0
        final = [check.on_host(b) for b in driver.beads(driver.state)]
    return {"seed": seed, "steps": driver.step - start, "wall_s": wall,
            "health": {k: v[0] for k, v in check.health(final, cfg).items()},
            "flags": [b["flags"] for b in final],
            "events": {k: sum(b[k] for b in final)
                       for k in ("n_moves", "n_loads", "n_unloads")},
            "fullest_cell": int(full.most), "placements": full.placements,
            "most_extruders": int(most),
            "table": cfg["extruders"]["table"]}


def readings(work, cfg, seed, seconds, device, control, count_cells):
    t0 = time.perf_counter()
    scene = make_scene(cfg, seed)
    system = build.program_system(cfg, scene)
    with counting_cells(system, count_cells) as full:
        state = build.settle(cfg, scene, system, device)
        driver = DRIVERS[work["driver"]](cfg, work, system, state, device)
        driver.warm(work["warm_steps"])
        sync(device)
        setup = time.perf_counter() - t0
        win = window(driver, work, seconds, device)
        plan = check.Plan(cfg, work["check_steps"])
        check.complete(plan, driver, work)
        final = [check.on_host(b) for b in driver.beads(driver.state)]
        pairs = check.program_side(driver, plan)
    out = {"seed": seed, "setup_s": setup, "steps": win["steps"],
           "wall_s": win["wall_s"],
           "health": {k: v[0] for k, v in check.health(final, cfg).items()},
           "events": sum(b["n_moves"] + b["n_loads"] + b["n_unloads"]
                         for b in final)}
    if full is not None:
        out["fullest_cell"] = int(full.most)
        out["placements"] = full.placements
    del driver, plan, state
    gc.collect()
    torch.cuda.empty_cache()
    params = build.reference_params(cfg, scene, device)
    k = work["check_steps"]
    out["program"] = check.reference_side(pairs, params, k, device)
    if control:
        out["control"] = check.control_side(pairs, params, k, device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m perfbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--cap", type=int, default=0)
    ap.add_argument("--count-cells", action="store_true")
    ap.add_argument("--endurance", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    work = spec.workload(args.workload)
    cfg = spec.config(work["config"])
    if args.cap:
        cfg["neighbor"] = dict(cfg["neighbor"], cell_cap=args.cap)
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in args.seeds.split(","):
        if args.endurance:
            out = endurance(work, cfg, int(s), args.endurance, "cuda")
        else:
            out = readings(work, cfg, int(s), args.seconds, "cuda",
                           int(s) in ctrl, args.count_cells)
        out["workload"] = args.workload
        out["cap"] = cfg["neighbor"]["cell_cap"]
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
