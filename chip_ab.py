#!/usr/bin/env python3
"""Versions of the lammps_le_torch port against each other in one process
on one CUDA card, in alternating order (the host's speed varies up to 2x
between processes, so only one process compares):

    python3 chip_ab.py kernels DIR [DIR ...] [--rounds N]
    python3 chip_ab.py steps CHECKOUT [--rounds N]

``kernels``: each DIR is the csrc directory of another copy of the
package (DIR/.. holds its fast/kernels.py): that package is copied to
build/ab, imported as lammps_le_torch_tree<i>, and runs every case
through its own wrappers on the libraries it builds from its own
sources, so trees whose C entry points differ (the replica count the
chain kernels' entry points took with the replica axis) compare all the
same; a DIR without a package around it is refused.  The cases
(``kernel_cases``), one run's planes each, through each tree's wrappers:
on path 1's settled 100k planes the pair stencils K1 (``stencil_forces``,
in both reciprocal forms) and K5 (``tiled_stencil_forces``), K2a
(``kick_drift_halo``), K2c (``extruder_springs``) and the Langevin
kernel K2d+e without zero and with zero over path 5's group; on config
6's K3 (``newton_half_forces``), K2a, K2c, the Langevin kernel and a
rebuild's placement (``place.place``, plain torch).  Per case and tree:
the median and quartiles over the rounds of the device ms a call (CUDA
events around 20 back-to-back calls a round, queued behind a sleep
kernel), the largest difference of the first output from the package's,
and whether every output was bitwise the package's in every round;
first, per DIR, whether the SASS of K1's and K3/K4's block-body
instances is the package's (``same_sass``).  Then K2's step loop on path
1's settled planes (as if just rebuilt): a launch of limit 16, which the
trigger stops after d steps, and a launch of limit d (live steps only),
through each tree's step loop; per round and tree the device ms of one
launch (its control kernel and graph, ``chip_smoke.loop_launch_ms``),
and whether its planes are the package's bit for bit.

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
import inspect
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


def kernel_inputs(states, dev):
    """{size: the one-run inputs of ``kernel_cases``} from ``settled``'s
    states, built once on the package and shared by every tree: the
    Simulation, the FastState, the grid constants and maps, path 5's
    group plane (100k) and the beads a rebuild places (config 6)."""
    import numpy as np
    import torch

    from lammps_le_torch.fast.engine import _lgm_plane, extract_beads, to_fast
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.fast.place import GridConsts

    out = {}
    for size, (sim, state) in zip(("100k", "config 6"), states):
        system = sim.system
        maps = fast_maps(system)
        fs = to_fast(state, sim)
        member = np.zeros(system.n, bool)
        member[:chip_smoke.N_CHAIN] = True
        out[size] = dict(
            sim=sim, fs=fs, maps=maps,
            g=GridConsts.build(system, maps, dev),
            lgm=_lgm_plane(member, fs.slot_of, maps, torch.float32),
            beads=extract_beads(fs, maps))
    return out


def kernel_cases(inputs, pkg):
    """[(label, call)] of the kernels ``kernels`` times, each call through
    package ``pkg``'s wrappers (and its placement) returning its output
    tensors; ``inputs``: ``kernel_inputs``'.  Stencils without energies
    (a production step's form)."""
    K = importlib.import_module(pkg.__name__ + ".fast.kernels")
    consts = importlib.import_module(pkg.__name__ + ".fast.consts")
    place = importlib.import_module(pkg.__name__ + ".fast.place")

    def exact(fn):
        # the pair stencils' IEEE reciprocal for the call
        keep = K.APPROX_RCP
        K.APPROX_RCP = False
        try:
            return fn()
        finally:
            K.APPROX_RCP = keep

    cases = []
    for size, d in inputs.items():
        sim, fs, g, maps = d["sim"], d["fs"], d["g"], d["maps"]
        system = sim.system
        C, n = consts.StencilConsts(system), system.n
        S = consts.SpringConsts(system, sim.ex_btype)
        kick = 0.5 * sim.dt / float(system.masses[0])
        st = (fs.gx, fs.bid, fs.hn, fs.pid, g.interior)
        lan = (fs.gx, fs.gx_ref, fs.gv, fs.gf, fs.bid, g.interior,
               (123456789, 987654321), fs.step, -0.1, 0.7, kick, sim.dt,
               0.3, 0.2, n, True)
        kdh = (fs.gx, fs.gv, fs.gf, fs.bid, g.interior, g.halo_cols,
               g.halo_src, g.halo_shift, n, kick, sim.dt)
        # a tree whose K2a writes the halo by its image map takes it
        if "images" in inspect.signature(K.kick_drift_halo).parameters:
            kdh += (g.images,)
        spr = (fs.gx, fs.gf.clone(), fs.exl_slot, fs.exr_slot,
               fs.ex_left >= 0, S)
        common = [
            (f"K2a {size}", lambda kdh=kdh: K.kick_drift_halo(*kdh)),
            # in place on a scratch copy of the forces: its energies
            (f"K2c {size}", lambda spr=spr: (K.extruder_springs(*spr),)),
            (f"K2d+e {size}", lambda lan=lan: K.langevin_kick_monitor(
                *lan))]
        if size == "100k":
            cases += [
                ("K1 100k", lambda st=st, C=C, n=n, maps=maps:
                 K.stencil_forces(*st, C, n, maps.strides, False)),
                ("K1 IEEE 100k", lambda st=st, C=C, n=n, maps=maps:
                 exact(lambda: K.stencil_forces(*st, C, n, maps.strides,
                                                False))),
                ("K5 100k", lambda st=st, C=C, n=n, maps=maps:
                 K.tiled_stencil_forces(*st, C, n, maps.strides, False)),
                *common,
                ("K2d+e zero+group 100k", lambda lan=lan, lgm=d["lgm"]:
                 K.langevin_kick_monitor(*lan, lgm, True))]
        else:
            x, v, f = d["beads"]
            cases += [
                ("K3 config 6", lambda st=st, g=g, C=C, n=n, maps=maps:
                 K.newton_half_forces(*st, g.faces, C, n, maps.strides,
                                      maps.fold_shifts, False)),
                *common,
                ("place config 6", lambda system=system, maps=maps, g=g,
                 x=x, v=v, f=f, fs=fs: place.place(
                     system, maps, g, x, v, f, fs.ex_left, fs.ex_right,
                     fs.img))]
    return cases


# the block-body instances of K1 (step.cu) and of K3 and K4 (blocked.cu)
# in both reciprocal forms: their mangled names' patterns
STENCIL_INSTANCES = {"step": {"K1 approx": r"\S*14stencil_kernelILb1E",
                              "K1 IEEE": r"\S*14stencil_kernelILb0E"},
                     "blocked": {
                         "K3/K4 approx": r"\S*18newton_half_kernelILb1E",
                         "K3/K4 IEEE": r"\S*18newton_half_kernelILb0E"}}


def same_sass(libs_a, libs_b):
    """{instance: whether its SASS instructions (predicate, opcode,
    operands, in order) are the same in both trees' libraries} for
    STENCIL_INSTANCES, listed with the toolkit's cuobjdump."""
    from lammps_le_torch.csrc.build import nvcc
    from lammps_le_torch.probes import listing

    tool = Path(nvcc()).parent / "cuobjdump"

    def dump(path):
        return subprocess.run([str(tool), "-sass", str(path)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout

    out = {}
    for lib, instances in STENCIL_INSTANCES.items():
        text_a, text_b = dump(libs_a[lib]), dump(libs_b[lib])
        for label, pat in instances.items():
            out[label] = ([c[1:] for c in listing(text_a, pat)]
                          == [c[1:] for c in listing(text_b, pat)])
    return out


class _Replay:
    """A step loop from before the conditional graph (one graph a limit)
    behind ``StepLoop.launch``."""

    def __init__(self, loop):
        self.loop, self.buf, self.held = loop, loop.buf, loop.held

    def launch(self, sstep, do_drift, key_words, t0, t_slope, limit):
        self.loop._begin(sstep, key_words, limit, do_drift, t0, t_slope)
        self.loop.graphs[limit].replay()


def tree_packages(dirs):
    """[(tree index, package)]: the package for tree 0, and for each other
    DIR the package around it (DIR/..), copied to build/ab and imported
    as lammps_le_torch_tree<i>; a DIR without one is refused."""
    import lammps_le_torch

    out = [(0, lammps_le_torch)]
    for i, d in enumerate(dirs[1:], 1):
        src = Path(d).resolve().parent
        if not (src / "fast" / "kernels.py").exists():
            raise SystemExit(f"{d}: not the csrc directory of a copy of the "
                             f"package (no {src / 'fast' / 'kernels.py'})")
        name = f"lammps_le_torch_tree{i}"
        shutil.rmtree(AB_DIR / name, ignore_errors=True)
        shutil.copytree(src, AB_DIR / name, ignore=shutil.ignore_patterns(
            "build", "__pycache__"))
        if str(AB_DIR) not in sys.path:
            sys.path.insert(0, str(AB_DIR))
        out.append((i, importlib.import_module(name)))
    return out


def loop_runs(pkgs, sim, state, dev):
    """{tree: (launcher, the (gx, gv, gf) planes, head)} of each package's
    step loop on path 1's settled state as if just rebuilt, staged and
    built by one call of limit 16 (its host time printed: the loop's
    set-up, its graphs' captures among it), and d: the steps the trigger
    let that launch run."""
    import torch

    from lammps_le_torch.fast.engine import to_fast
    from lammps_le_torch.fixes import Langevin

    fs = to_fast(state, sim)
    lf = next(f for f in sim.fixes if isinstance(f, Langevin))
    args = (fs.gx, fs.gv, fs.gf, fs.gx, fs.bid, fs.hn, fs.pid, fs.exl_slot,
            fs.exr_slot, fs.ex_left >= 0, fs.lgm)
    head = (fs.step + 1, True, (123456789, 987654321), 1.0, 0.0)
    runs, steps = {}, set()
    for t, pkg in pkgs:
        maps_mod = importlib.import_module(pkg.__name__ + ".fast.maps")
        place = importlib.import_module(pkg.__name__ + ".fast.place")
        ps = importlib.import_module(pkg.__name__ + ".fast.pallas_step")
        maps = maps_mod.fast_maps(sim.system)
        g = place.GridConsts.build(sim.system, maps, dev)
        real = ps.make_step_kernel(sim.system, maps, sim.ex_btype,
                                   dt=sim.dt, langevin=lf, g=g)
        # the package's libraries built (and loaded) before: ``kernels``
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.add(int(real(*args, *head, 16)[3][7]))
        print(f"K2 loop tree {t}: first launch, set-up included, "
              f"{1e3 * (time.perf_counter() - t0):.2f} ms", flush=True)
        loop = real.loop
        runs[t] = (loop if hasattr(loop, "launch") else _Replay(loop),
                   (fs.gx, fs.gv, fs.gf), head)
    if len(steps) != 1:
        raise RuntimeError(f"the trees' 16-step launches ran {steps} steps")
    return runs, steps.pop()


def time_loops(runs, d, rounds):
    """The step-loop cases: per tree, limit (16, d), the device ms of a
    launch over the rounds (trees alternating), and whether every
    launch's planes were tree 0's."""
    import torch

    times = {(t, lim): [] for t in runs for lim in (16, d)}
    same = {key: True for key in times}
    ref = {}
    for r in range(rounds):
        order = list(runs) if r % 2 == 0 else list(reversed(runs))
        for t in order:
            loop, planes, head = runs[t]
            for lim in ((16, d) if r % 2 == 0 else (d, 16)):
                times[(t, lim)].append(chip_smoke.loop_launch_ms(
                    loop, planes, head, lim))
                out = [loop.buf[k].clone() for k in ("gx", "gv", "gf")]
                if t == min(runs):
                    ref.setdefault(lim, out)
                same[(t, lim)] &= (lim in ref and all(
                    torch.equal(a, b) for a, b in zip(out, ref[lim])))
    return times, same


def kernels(args, dev):
    import torch

    dirs = [ROOT / "lammps_le_torch" / "csrc"] + [Path(d) for d in args.dirs]
    pkgs = tree_packages(dirs)
    built = [importlib.import_module(pkg.__name__ + ".csrc.build").build()
             for _, pkg in pkgs]
    for _, pkg in pkgs:
        importlib.import_module(pkg.__name__ + ".fast.kernels")._lib()
    for d, paths in zip(dirs[1:], built[1:]):
        print(f"{d}: stencil instances with the package's SASS: "
              f"{same_sass(built[0], paths)}", flush=True)
    states = settled(dev)
    inputs = kernel_inputs(states, dev)
    trees = [kernel_cases(inputs, pkg) for _, pkg in pkgs]
    labels = [label for label, _ in trees[0]]
    ref = [fn() for _, fn in trees[0]]
    times = [[[] for _ in labels] for _ in trees]
    diffs = [[0.0] * len(labels) for _ in trees]
    same = [[True] * len(labels) for _ in trees]
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for r in range(args.rounds):
        order = list(range(len(trees)))
        if r % 2:
            order.reverse()
        for t in order:
            for c, (_, fn) in enumerate(trees[t]):
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                # hold the stream (~20 ms) while the host queues the
                # calls, so that the events see device time only
                torch.cuda._sleep(40_000_000)
                start.record()
                for _ in range(20):
                    out = fn()
                stop.record()
                torch.cuda.synchronize()
                times[t][c].append(start.elapsed_time(stop) / 20)
                diffs[t][c] = float((out[0].double()
                                     - ref[c][0].double()).abs().max())
                same[t][c] &= all(torch.equal(a, b)
                                  for a, b in zip(out, ref[c]))
    for c, label in enumerate(labels):
        for t, d in enumerate(dirs):
            m, lo, hi = quartiles(times[t][c])
            print(f"{label} {d}: device {m:.4f} ms a call (IQR {lo:.4f}-"
                  f"{hi:.4f} over {args.rounds} rounds); max|out0 - "
                  f"out0_pkg| {diffs[t][c]:.3g}, every output equal to the "
                  f"package's {same[t][c]}", flush=True)
        for t, d in enumerate(dirs[1:], 1):
            wins = sum(a < b for a, b in zip(times[0][c], times[t][c]))
            ratio = quartiles(times[0][c])[0] / quartiles(times[t][c])[0]
            print(f"{label}: package / {d} {ratio:.4f} in device time, the "
                  f"package faster in {wins} of {args.rounds} rounds",
                  flush=True)
    # K2's step loop, each tree's on its own libraries
    runs, d = loop_runs(pkgs, *states[0], dev)
    times, same_loop = time_loops(runs, d, args.rounds)
    for lim, label in ((16, f"stopped after {d} steps"),
                       (d, "live steps only")):
        for t in runs:
            m, lo, hi = quartiles(times[(t, lim)])
            print(f"K2 loop limit {lim} ({label}) 100k {dirs[t]}: device "
                  f"{m:.4f} ms a launch (IQR {lo:.4f}-{hi:.4f} over "
                  f"{args.rounds} rounds); planes equal to the package's "
                  f"{same_loop[(t, lim)]}", flush=True)
    for t in runs:
        ratio = (quartiles(times[(t, 16)])[0]
                 / quartiles(times[(t, d)])[0])
        print(f"K2 loop {dirs[t]}: limit 16 / limit {d} {ratio:.4f}",
              flush=True)


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
