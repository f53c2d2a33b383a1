#!/usr/bin/env python3
"""Versions of the lammps_le_torch port against each other in one process
on one CUDA card, in alternating order (the host's speed varies up to 2x
between processes, so only one process compares):

    python3 chip_ab.py kernels DIR [DIR ...] [--rounds N]
    python3 chip_ab.py steps CHECKOUT [--rounds N]

``kernels``: the pair stencils K1 (``stencil_forces``) on path 1's
settled 100k planes and K3 (``newton_half_forces``) on config 6's,
without energies (a production step's form), through the package's
wrappers on the libraries built from its own lammps_le_torch/csrc and
from each DIR (a copy of that directory with other sources), with the
package's nvcc flags.  Per tree: the median and quartiles over the
rounds of the device ms a call (CUDA events around 20 back-to-back
calls a round, queued behind a sleep kernel) and the largest force
difference from the package's own kernels.

``steps``: path 1 (1,500 steps after a 40-step warm-up, the step loop in
auto mode) and config 6 (600 steps after 20) from the same settled
states, on the package and on CHECKOUT's (another checkout of the repo;
its package is copied to build/ab and imported under another name).
Each round runs both versions, the order alternating.  Per version: the
medians, quartiles and wins of steps/s, and config 6's peak device memory
(``max_memory_allocated`` over its windows, the other version's state
alive beside it).  Each version must repeat its run bit for bit in every
round (the same rebuilds and position sum; the two versions' runs part
where their force sums round differently).  The card's name and power
limit are printed first and last.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke

ROOT = Path(__file__).resolve().parent
AB_DIR = ROOT / "build" / "ab"


def quartiles(v):
    s = sorted(v)
    return statistics.median(s), s[len(s) // 4], s[(3 * len(s)) // 4]


def settled(dev):
    """(path 1's Simulation and settled State, config 6's), built and run
    on the package."""
    data, system = chip_smoke.production_config(chip_smoke.BEADS)
    path1 = chip_smoke.drive(system, data, dev)
    data6, system6 = chip_smoke.config6_system()
    return path1, chip_smoke.settle_config6(data6, system6, dev)


def build_trees(dirs):
    """The step, blocked and tiled libraries of each source tree, built at
    once: [{name: path}]."""
    from lammps_le_torch.csrc.build import NVCC_FLAGS, nvcc

    out, procs = [], []
    for i, d in enumerate(dirs):
        dst = AB_DIR / f"tree{i}"
        dst.mkdir(parents=True, exist_ok=True)
        libs = {}
        for name in ("step", "blocked", "tiled"):
            libs[name] = dst / f"lib{name}.so"
            procs.append((d / f"{name}.cu", subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(libs[name]),
                 str(d / f"{name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        out.append(libs)
    for src, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {src} failed:\n{err}")
    return out


def kernels(args, dev):
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast.consts import StencilConsts
    from lammps_le_torch.fast.engine import to_fast
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.fast.place import GridConsts

    dirs = [ROOT / "lammps_le_torch" / "csrc"] + [Path(d) for d in args.dirs]
    trees = [K.bind(paths) for paths in build_trees(dirs)]
    cases = []
    for label, (sim, state) in zip(("K1 100k", "K3 config 6"),
                                   settled(dev)):
        system = sim.system
        maps = fast_maps(system)
        g = GridConsts.build(system, maps, dev)
        fs = to_fast(state, sim)
        C, n = StencilConsts(system), system.n
        if label.startswith("K3"):
            fn = (lambda fs=fs, g=g, C=C, n=n, maps=maps:
                  K.newton_half_forces(fs.gx, fs.bid, fs.hn, fs.pid,
                                       g.interior, g.faces, C, n,
                                       maps.strides, maps.fold_shifts,
                                       False)[0])
        else:
            fn = (lambda fs=fs, g=g, C=C, n=n, maps=maps:
                  K.stencil_forces(fs.gx, fs.bid, fs.hn, fs.pid,
                                   g.interior, C, n, maps.strides,
                                   False)[0])
        cases.append((label, fn))
    K._LIBS = trees[0]
    ref = [fn() for _, fn in cases]
    times = [[[] for _ in cases] for _ in trees]
    diffs = [[0.0] * len(cases) for _ in trees]
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for r in range(args.rounds):
        order = list(range(len(trees)))
        if r % 2:
            order.reverse()
        for t in order:
            K._LIBS = trees[t]
            for c, (_, fn) in enumerate(cases):
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                # hold the stream (~20 ms) while the host queues the
                # calls, so that the events see device time only
                torch.cuda._sleep(40_000_000)
                start.record()
                for _ in range(20):
                    gf = fn()
                stop.record()
                torch.cuda.synchronize()
                times[t][c].append(start.elapsed_time(stop) / 20)
                diffs[t][c] = float((gf - ref[c]).abs().max())
    K._LIBS = None
    for t, d in enumerate(dirs):
        for c, (label, _) in enumerate(cases):
            m, lo, hi = quartiles(times[t][c])
            print(f"{label} {d}: device {m:.4f} ms a call (IQR {lo:.4f}-"
                  f"{hi:.4f} over {args.rounds} rounds); max|f - f_pkg| "
                  f"{diffs[t][c]:.3g}", flush=True)


def port_sim(sim, pkg):
    """``sim`` rebuilt from package ``pkg``'s fix and Simulation classes."""
    fixes = importlib.import_module(pkg + ".fixes")
    integrate = importlib.import_module(pkg + ".integrate")
    return integrate.Simulation(
        system=sim.system, dt=sim.dt, ex_btype=sim.ex_btype,
        energy_every=sim.energy_every, fixes=tuple(
            getattr(fixes, type(f).__name__)(**{
                x.name: getattr(f, x.name) for x in dataclasses.fields(f)})
            for f in sim.fixes))


def steps(args, dev):
    import torch

    other = AB_DIR / "lammps_le_torch_other"
    shutil.rmtree(other, ignore_errors=True)
    shutil.copytree(Path(args.checkout) / "lammps_le_torch", other,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    sys.path.insert(0, str(AB_DIR))
    (sim1, start1), (sim6, start6) = settled(dev)
    runs = (("path 1", start1, sim1, 40, chip_smoke.MEASURE),
            ("config 6", start6, sim6, chip_smoke.C6["warm"],
             chip_smoke.C6["measure"]))
    versions = {}
    for name, pkg in (("change", "lammps_le_torch"),
                      ("other", "lammps_le_torch_other")):
        fast = importlib.import_module(pkg + ".fast")
        segs = []
        for _, _, sim, _, _ in runs:
            sim_v = port_sim(sim, pkg)
            segs.append((sim_v, fast.make_fast_segment(sim_v,
                                                       device=dev)[0]))
        versions[name] = (fast, segs)
    sps = {(v, run[0]): [] for v in versions for run in runs}
    ends = {key: set() for key in sps}
    peak = {v: 0 for v in versions}
    for r in range(args.rounds):
        order = list(versions) if r % 2 == 0 else list(reversed(versions))
        for v in order:
            fast, segs = versions[v]
            for (label, start, _, warm, measure), (sim_v, seg) in zip(
                    runs, segs):
                if label == "config 6":
                    torch.cuda.reset_peak_memory_stats()
                fs = fast.to_fast(start, sim_v)
                b0 = fs.step
                seg(fs, b0, warm, b0, b0 + warm + measure)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                seg(fs, b0 + warm, measure, b0, b0 + warm + measure)
                torch.cuda.synchronize()
                rate = measure / (time.perf_counter() - t0)
                sps[(v, label)].append(rate)
                if label == "config 6":
                    peak[v] = max(peak[v], torch.cuda.max_memory_allocated())
                end = (fs.n_rebuilds, int(fs.flags),
                       float(fs.gx.double().sum()))
                ends[(v, label)].add(end)
                print(f"round {r} {v} {label}: {rate:.2f} steps/s, "
                      f"rebuilds {end[0]}, flags {end[1]:#x}, sum x "
                      f"{end[2]:.10g}", flush=True)
                del fs
    for label, *_ in runs:
        for v in versions:
            m, lo, hi = quartiles(sps[(v, label)])
            print(f"{label} {v}: median {m:.2f} steps/s (IQR {lo:.2f}-"
                  f"{hi:.2f}); all " + " ".join(
                      f"{x:.2f}" for x in sps[(v, label)]), flush=True)
        wins = sum(a > b for a, b in zip(sps[("change", label)],
                                         sps[("other", label)]))
        ratio = (quartiles(sps[("change", label)])[0]
                 / quartiles(sps[("other", label)])[0])
        print(f"{label}: change over other in {wins} of {args.rounds} "
              f"rounds, median ratio {ratio:.3f}", flush=True)
    for v in versions:
        print(f"config 6 peak device memory, {v}: {peak[v]} B", flush=True)
    for key, seen in ends.items():
        if len(seen) != 1:
            raise RuntimeError(f"{key} ended differently across rounds: "
                               f"{sorted(seen)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    k = sub.add_parser("kernels")
    k.add_argument("dirs", nargs="*")
    s = sub.add_parser("steps")
    s.add_argument("checkout")
    for p in (k, s):
        p.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}; {chip_smoke.card_line()}",
          flush=True)
    (kernels if args.mode == "kernels" else steps)(args, dev)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
