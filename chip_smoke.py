#!/usr/bin/env python3
"""Smoke run of the lammps_le_torch port on one CUDA card.

The instructions one IEEE reciprocal issues, read from the built
library's SASS, and the card's SM count and clock set the operation
bounds of every kernel.  It drives the port's five paths through its
user entry points:

1. bench.py's production LE configuration (bench.py:398-486): a
   100,000-bead serpentine chromosome on the grid-resident fast engine,
   thermalized, settled with 500 seeded extruders, then 1,500 measured
   production steps with extrusion, ex_load and ex_unload, on the full
   27-offset stencil;
2. config 6 (benchmarks/configs.py:269-362): a 1,000,000-bead chromosome
   past the whole-plane gate, where the engine takes the Newton-half
   stencil, with 5,000 seeded extruders and 600 measured steps;
3. the 100k configuration's 1,500 measured steps, from the same settled
   state, on the sharded slab stencil (make_sharded_segment) at sp=2 with
   both slabs on the card;
4. the same on the tiled full stencil (make_pallas_kernel as kernel_fn);
5. the 100k configuration anew with its Langevin fix on the group of
   beads 1-90,000 with ``zero yes`` (the last tenth runs NVE).

After each it holds that path's hand-written CUDA kernels against their
plain PyTorch versions at the shapes the run gave them and times both
(one record per path and kernel; paths 3, 4 and 5 record their stencil or
their Langevin kernel, the other kernels having run at path 1's shapes),
and the stencils of paths 3 and 4 against the full stencil on the same
planes; it repeats paths 3 and 4 with every stencil call held against
another stencil on the planes of that call (``witness``); after config 6
it runs copies of its state on past the window on both stencils,
printing flags and the fullest cell.  Then it runs the two microprobes
(lammps_le_torch/probes) through their entry points at the TPU probes'
shapes: P1, the IEEE reciprocal against ``rcp.approx`` in a
division-bound chain and the latter's error, and P2, an f32 elementwise
chain against packed bf16, each kernel held against its plain version.
Last it runs a small system end to end on the card and on the CPU, on
the full and Newton-half stencils, to compare the two.

    python3 chip_smoke.py [--profile STEPS] [--overrun STEPS]

builds the kernels with nvcc on first use.  It exits nonzero, printing no
result, without a CUDA device.  Earlier lines report the card, the
throughput, per-kernel times and one JSON object of kernel records; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

# f32 sums of 1e5-1e6 terms taken in another order differ by ~1e-6 of
# their size; energies are held to 2e-2 plus that share
E_ABS, E_REL = 2e-2, 1e-5
F_REL = 3e-5  # forces: 3e-5 * max|f| (tests/test_pallas_step.py:97)
# two stencils (Newton-half vs full) sum each force in another order:
# 2e-4 * max|f|, the reference's K3-vs-XLA tolerance
# (tests/test_blocked_kernel.py:97)
F_REL_STENCILS = 2e-4

# bench.py's production run: beads, thermalize / settle / warm-up /
# measured steps, seeded extruders
BEADS, THERMALIZE, SETTLE, WARM, MEASURE, N_EX0 = (
    100_000, 300, 100, 40, 1500, 500)
GRID = (9, 33664)  # (cap, P) of the (3, cap, P) planes at that config
# config 6 (configs.py:269-362), the same phases
C6 = dict(beads=1_000_000, thermalize=400, settle=200, warm=20,
          measure=600, n_ex0=5000, grid=(9, 358144))

# the card's memory rate for the bound columns (NVIDIA's H100 SXM data
# sheet, at 700 W)
HBM_BPS = 3.35e12
# instructions a clock per SM: f32 add, multiply, min/max (and every other
# instruction: four schedulers issue one 32-lane warp instruction a clock
# each), and the MUFU pipe of reciprocals and square roots (the CUDA C++
# Programming Guide's arithmetic-instruction throughput table, compute
# capability 9.0).  The card's SM count and maximum SM clock turn them
# into rates (``set_rates``); an IEEE reciprocal costs the instructions
# that the built library issues for one (probes.probe_rcp.rcp_price).
LANES_SM, MUFU_LANES_SM = 128, 16
RATES = {}  # f32 and mufu operations/s, the reciprocal's instructions
# f32 operations of one examined slot pair, the arithmetic every pair
# does (3 differences, 5 for r^2, 1 division, 2 for r^6, 4 for the force
# factor, 6 to scale and add the force); the Newton-half stencil adds 3
# for the reaction.  Comparisons and the terms of the few pairs in bond
# or energy range are not counted.
PAIR_OPS = {"stencil_forces": 21, "newton_half_forces": 24,
            "tiled_stencil_forces": 21, "window_forces": 24}
SP_PATH, SP_PHASES = 2, (2, 4)  # slabs of path 3; of its kernel phase
# the source of each kernel not in step.cu
SOURCES = {"newton_half_forces": "blocked.cu", "window_forces": "blocked.cu",
           "tiled_stencil_forces": "tiled.cu", "rcp_chain": "probes.cu",
           "rcp": "probes.cu", "elementwise_chain": "probes.cu"}
# path 5: the thermostat's group, beads 1-90,000 of 100,000 (group chain
# id 1:90000); the last tenth of the chromosome runs NVE
N_CHAIN = 90_000


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    raise AssertionError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def production_config(n_beads, seed=2024):
    """bench.py:402-428: serpentine + LJ/FENE/harmonic, skin 0.5,
    rebuild_every 40, cap 9, 1024 extruder slots, f32."""
    from lammps_le_torch.io.data import system_from_data
    from lammps_le_torch.scene import serpentine
    from lammps_le_torch.system import (BOND_FENE, BOND_HARMONIC,
                                        BondParams, PairLJCut)

    data = serpentine(n_beads, spacing=0.97, row_gap=1.1, seed=seed,
                      barrier_fraction=0.003)
    ones = np.ones((4, 4))
    pair = PairLJCut(epsilon=ones, sigma=ones, cutoff=1.12 * ones,
                     shift=True)
    bonds = BondParams(
        style=np.array([BOND_FENE, BOND_HARMONIC]),
        coeffs=np.array([[30.0, 1.5, 1.0, 1.0], [3.0, 1.1, 0.0, 0.0]]))
    system, _ = system_from_data(
        data, pair=pair, bonds=bonds, dtype="float32", ex_btype=2,
        max_extruders=1024, skin=0.50, rebuild_every=40, cell_cap=9)
    return data, system


def config6_system():
    """configs.py:269-300 (_chain_system): serpentine of 1M beads, LJ 1.12
    shifted, FENE (30, 1.5, 1, 1) + harmonic (10, 1.1) extruder bonds,
    skin 0.5, rebuild_every 40, 8192 extruder slots, cap 9, f32."""
    from lammps_le_torch.io.data import system_from_data
    from lammps_le_torch.scene import serpentine
    from lammps_le_torch.system import (BOND_FENE, BOND_HARMONIC,
                                        BondParams, PairLJCut)

    data = serpentine(C6["beads"], seed=12345, n_atom_types=4,
                      n_bond_types=2, barrier_fraction=0.0)
    ones = np.ones((4, 4))
    pair = PairLJCut(epsilon=ones, sigma=ones, cutoff=1.12 * ones,
                     shift=True)
    bonds = BondParams(
        style=np.array([BOND_FENE, BOND_HARMONIC]),
        coeffs=np.array([[30.0, 1.5, 1.0, 1.0], [10.0, 1.1, 0.0, 0.0]]))
    system, _ = system_from_data(
        data, pair=pair, bonds=bonds, dtype="float32", ex_btype=2,
        max_extruders=8192, skin=0.5, rebuild_every=40, cell_cap=9)
    return data, system


def le_fixes(extrusion_every=1000, load_every=700, fraction=0.001,
             release_r=0.0, zero=False, group=None):
    """bench.py's production fixes; ``zero`` and ``group`` are its
    Langevin fix's options (path 5)."""
    from lammps_le_torch.fixes import (NVE, ExLoad, ExUnload, Extrusion,
                                       Langevin)

    return (
        NVE(),
        Langevin(t_start=1.0, t_stop=1.0, damp=10.0, seed=904297, zero=zero,
                 group=group),
        Extrusion(nevery=extrusion_every, neutral_type=1, ctcf_left=2,
                  ctcf_right=3, through_prob=0.5, btype=2,
                  ctcf_left_right=4, release_r=release_r),
        ExLoad(nevery=load_every, iatomtype=1, jatomtype=1, cutoff=1.12,
               btype=2, fraction=fraction, seed=684474, imaxbond=1,
               inewtype=1, jmaxbond=1, jnewtype=1),
        ExUnload(nevery=load_every, btype=2, cutoff=0.5, fraction=fraction,
                 seed=456456),
    )


def seed_extruders(state, n_ex, spacing, e_cap, reset_step=True):
    """Extruders at ``arange(n_ex) * spacing + 1`` with their right
    anchors 2 beads on; flags zeroed and, as bench.py does, the step."""
    import torch

    left = np.full(e_cap, -1, np.int64)
    right = np.full(e_cap, -1, np.int64)
    sites = np.arange(n_ex) * spacing + 1
    left[:n_ex] = sites
    right[:n_ex] = sites + 2
    dev = state.x.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return state.replace(ex_left=torch.tensor(left, device=dev),
                         ex_right=torch.tensor(right, device=dev),
                         flags=zero,
                         step=zero.clone() if reset_step else state.step)


def timed_run(label, sim, state, steps, groups=None):
    """``run_fast`` with its wall time and flags printed."""
    import torch

    from lammps_le_torch.fast import run_fast

    t0 = time.perf_counter()
    state = run_fast(sim, state, steps, groups=groups)
    torch.cuda.synchronize()
    print(f"{label} {steps} steps {time.perf_counter() - t0:.2f} s, "
          f"flags={int(state.flags):#x}", flush=True)
    return state


def measured_segment(sim, state, dev, warm, measure, profile_steps,
                     kernel_fn=None, segment=None, groups=None):
    """``warm`` steps, then ``measure`` timed steps with the launch counts
    zeroed just before them and read just after, on ``segment`` (default
    ``make_fast_segment`` on ``kernel_fn``); ``groups`` as to_fast's.
    Returns (FastState, measured wall s, rebuilds and kernel launches in
    the window)."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import make_fast_segment, to_fast

    segment = segment or make_fast_segment(sim, dev, kernel_fn)
    fs = to_fast(state, sim, kernel_fn, groups)
    b0 = fs.step
    bend = b0 + warm + measure
    segment(fs, b0, warm, b0, bend)
    torch.cuda.synchronize()
    rebuilds0 = fs.n_rebuilds
    K.reset_launches()
    t0 = time.perf_counter()
    segment(fs, b0 + warm, measure, b0, bend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    rebuilds = fs.n_rebuilds - rebuilds0
    if profile_steps:
        # on a copy: a step reassigns the state's fields, so the profiled
        # steps leave the measured state as it was for the checks
        profile_window(segment, dataclasses.replace(fs), sim.system,
                       profile_steps, b0, bend)
    return fs, wall, rebuilds, launches


def drive(system, data, dev, groups=None):
    """bench.py's thermalize / settle phases on the port.  Returns the
    production Simulation and the settled State that its measured phase
    starts from.  With ``groups`` (path 5) the production Langevin fix
    thermostats the group ``chain`` with ``zero yes``."""
    import torch

    from lammps_le_torch import rng
    from lammps_le_torch.fixes import NVE, Langevin
    from lammps_le_torch.integrate import Simulation
    from lammps_le_torch.state import init_state

    n = system.n
    warm = Simulation(system=system, dt=0.006, ex_btype=2, fixes=(
        NVE(), Langevin(t_start=1.0, t_stop=1.0, damp=1.0, seed=7)))
    state = init_state(system, data.x, types=data.types, seed=11,
                       device=dev)
    state = timed_run("thermalize", warm, state, THERMALIZE)

    state = seed_extruders(state, N_EX0, n // N_EX0, system.max_extruders)
    fixes = le_fixes(zero=True, group="chain") if groups else le_fixes()
    sim = Simulation(system=system, dt=0.006, energy_every=100,
                     fixes=fixes, ex_btype=2)
    settle = Simulation(system=system, dt=0.002, fixes=sim.fixes,
                        ex_btype=2)
    state = timed_run("settle", settle, state, SETTLE, groups)
    # bench.py's R=1 replica: key folded with replica seed 100
    return sim, state.replace(
        flags=torch.zeros_like(state.flags),
        key=torch.tensor(rng.fold_in(state.key.tolist(), 100),
                         dtype=torch.int64, device=dev))


def drive_config6(data, system, dev, profile_steps=0):
    """configs.py:300-331 on the port: thermalize 400 steps (NVE +
    Langevin damp 1, dt 0.006, init seed 19), zero the flags, seed 5,000
    extruders 200 beads apart, settle 200 steps at dt 0.002 with the
    production fixes (extrusion with release_r 3), zero the flags, then
    20 warm-up and 600 measured steps with energy_every 100.  The
    reference's 100-step launches only worked around a TPU worker crash
    (configs.py:333-336): the port runs the 600 steps as one segment.
    Returns what ``drive`` returns."""
    import torch

    from lammps_le_torch.fixes import NVE, Langevin
    from lammps_le_torch.integrate import Simulation
    from lammps_le_torch.state import init_state

    n = system.n
    warm = Simulation(system=system, dt=0.006, ex_btype=2, fixes=(
        NVE(), Langevin(t_start=1.0, t_stop=1.0, damp=1.0, seed=7)))
    state = init_state(system, data.x, types=data.types, seed=19,
                       device=dev)
    state = timed_run("config 6 thermalize", warm, state, C6["thermalize"])
    state = seed_extruders(state, C6["n_ex0"], n // C6["n_ex0"],
                           system.max_extruders, reset_step=False)
    sim = Simulation(system=system, dt=0.006, energy_every=100,
                     fixes=le_fixes(release_r=3.0), ex_btype=2)
    settle = Simulation(system=system, dt=0.002, fixes=sim.fixes,
                        ex_btype=2)
    state = timed_run("config 6 settle", settle, state, C6["settle"])
    state = state.replace(flags=torch.zeros_like(state.flags))
    return (sim,) + measured_segment(sim, state, dev, C6["warm"],
                                     C6["measure"], profile_steps)


def check_run(label, fs, system, wall, rebuilds, launches, measure, grid,
              want):
    """Print a measured run's throughput and state; fail unless it is
    healthy (finite planes of the expected shape, every bead placed, no
    error-class flag, FENE clamps <= 20 per move, T in (0.5, 2.0), moves
    > 0) and each kernel launched ``want[name]`` times in the window."""
    import torch

    from lammps_le_torch.fast import thermo_row_fast
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.state import FLAG_FENE_CLAMP

    row = thermo_row_fast(fs, system)
    temp = float(row.temp)
    flags = int(fs.flags)
    moves = int(fs.n_moves)
    clamps = int(fs.n_clamps)
    n_ex = int((fs.ex_left >= 0).sum())
    sps = measure / wall
    fullest = max_cell_count(fs, system)
    print(f"{label} {measure} steps in {wall:.3f} s: "
          f"{sps:.2f} steps/s, {sps * system.n:.4g} bead*steps/s; "
          f"rebuilds {rebuilds}; T {temp:.4f}; flags {flags:#x}; "
          f"moves {moves}, loads {int(fs.n_loads)}, unloads "
          f"{int(fs.n_unloads)}, extruders {n_ex}, clamps {clamps}; "
          f"epair {float(fs.epair):.6g} ebond {float(fs.ebond):.6g}; "
          f"fullest cell {fullest} beads (cap {grid[0]})",
          flush=True)
    print(f"launches in the {measure} measured steps: {launches}",
          flush=True)
    x_fin = bool(torch.isfinite(fs.gx).all() and torch.isfinite(fs.gv).all())
    if not x_fin or tuple(fs.gx.shape) != (3,) + grid:
        fail(f"non-finite planes, or of shape {tuple(fs.gx.shape)} (want "
             f"(3,) + {grid}), after the {label} run")
    interior = torch.as_tensor(fast_maps(system).interior,
                               device=fs.gx.device)
    placed = int(((fs.bid < system.n) & interior).sum())
    if placed != system.n:
        fail(f"{placed} of {system.n} beads on the grid")
    if flags & ~FLAG_FENE_CLAMP:
        fail(f"error-class flags {flags:#x}")
    if clamps > 20 * max(moves, 1):
        fail(f"{clamps} FENE clamp events for {moves} moves")
    if not 0.5 < temp < 2.0:
        fail(f"temperature {temp} outside (0.5, 2.0)")
    if moves <= 0:
        fail("no extrusion move in the run")
    if launches != want:
        fail(f"kernel launches {launches} in {measure} {label} steps "
             f"(want {want})")


def set_rates(card):
    """RATES from this card: the f32 and MUFU rates from its SM count and
    maximum SM clock (nvidia-smi), and the instructions one IEEE
    reciprocal issues, from the SASS of the built probes library."""
    import torch

    from lammps_le_torch.probes.probe_rcp import rcp_price

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    price, exact, approx = rcp_price()
    RATES.update(f32=LANES_SM * sms * mhz * 1e6,
                 mufu=MUFU_LANES_SM * sms * mhz * 1e6, div=price)
    print(f"bound rates ({card}): {sms} SMs at {mhz:.0f} MHz: f32 "
          f"{RATES['f32']:.4g} operations/s ({LANES_SM} lanes a clock per "
          f"SM; no FMA under -fmad=false), MUFU "
          f"{RATES['mufu']:.4g}/s; an IEEE reciprocal issues {price} "
          f"instructions on its fast path (SASS of the one-pass kernels: "
          f"exact {' '.join(exact)} | approximate {' '.join(approx)})",
          flush=True)


def bound(nbytes, ops, divs=0, mufu=0):
    """(ms, what bounds it): the least time an H100 SXM takes to move
    ``nbytes`` or to issue ``ops`` f32 operations, ``divs`` IEEE
    reciprocals and ``mufu`` further MUFU operations, whichever is
    longest.  Each reciprocal issues RATES["div"] instructions, one of
    them on the MUFU pipe."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = max((ops + divs * RATES["div"]) / RATES["f32"],
                (divs + mufu) / RATES["mufu"]) * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


def stencil_bound(name, fs, g, maps, n):
    """The stencils' bound on this run's planes: planes in (x, bid,
    has-next, partner, interior and, for the Newton-half stencil, the six
    face masks) and forces out once; operations for the pairs the data
    holds: at each offset d, each valid i slot of column c against the
    occupied j rows of column (c + d) mod P (in the self cell, the other
    occupied rows).  Empty j slots need only the bead-id compare, which is
    not counted; the Newton-half self cell computes no reaction."""
    import torch

    from lammps_le_torch.fast import kernels_ref as R
    from lammps_le_torch.ops.grid import _OFFSETS

    cap, P = maps.cap, maps.P
    sx, sy, sz = maps.strides
    occ = (fs.bid < n).sum(0, dtype=torch.int64)
    n_i = R.valid_mask(fs.bid, g.interior, n).sum(0, dtype=torch.int64)
    newton = name == "newton_half_forces"
    ops = pairs = 0
    for (a, b, c) in (R.HALF_OFFSETS if newton else _OFFSETS):
        delta = a * sx + b * sy + c * sz
        if delta == 0:
            k = int((n_i * (occ - 1)).sum())
            ops += k * (PAIR_OPS["stencil_forces"] - 1)
        else:
            k = int((n_i * torch.roll(occ, -delta)).sum())
            ops += k * (PAIR_OPS[name] - 1)
        pairs += k
    nbytes = cap * P * (12 + 4 + 1 + 4 + 12) + P * (1 + 6 * newton)
    return bound(nbytes, ops, divs=pairs)


def window_bound(wargs, n):
    """window_forces' bound on these windows (its ``args``): the window
    planes (the margins' copies included) in and the window forces and
    tallies out once; operations for the pairs the windows hold, counted
    as ``stencil_bound`` counts the Newton-half stencil's, each window
    rolled on itself."""
    import torch

    from lammps_le_torch.fast import kernels_ref as R

    xw, bidw, hnw, pidw, own = wargs[:5]
    period, (sx, sy, sz) = wargs[7], wargs[8]
    cap, Q = bidw.shape
    occ = (bidw < n).sum(0, dtype=torch.int64).view(-1, period)
    n_i = R.valid_mask(bidw, own, n).sum(0, dtype=torch.int64).view(
        -1, period)
    ops = pairs = 0
    for (a, b, c) in R.HALF_OFFSETS:
        delta = a * sx + b * sy + c * sz
        if delta == 0:
            k = int((n_i * (occ - 1)).sum())
            ops += k * (PAIR_OPS["stencil_forces"] - 1)
        else:
            k = int((n_i * torch.roll(occ, -delta, -1)).sum())
            ops += k * (PAIR_OPS["window_forces"] - 1)
        pairs += k
    return bound(cap * Q * (12 + 4 + 1 + 4 + 12) + Q + 5 * 4, ops,
                 divs=pairs)


def max_cell_count(fs, system):
    """The most beads one cell would hold at a rebuild now (binned from
    the beads' positions, not the planes, whose cells hold at most cap)."""
    import torch

    from lammps_le_torch.fast.engine import extract_beads
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.ops.cells import cell_coords, wrap_positions

    x, _ = wrap_positions(extract_beads(fs, fast_maps(system))[0], system,
                          fs.img)
    c3 = cell_coords(x, system)
    nb = system.neighbor
    col = (c3[:, 0] * nb.ny + c3[:, 1]) * nb.nz + c3[:, 2]
    return int(torch.bincount(col).max())


def profile_window(segment, fs, system, steps, b0, bend):
    """``steps`` more production steps under torch.profiler: device busy
    share of the wall time and the device time of the top kernels; then
    the copy's flags and fullest cell."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        segment(fs, fs.step, steps, b0, bend)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device rows only (a CPU op's row repeats its kernels' time)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    print(f"profile: {steps} steps in {wall * 1e3:.1f} ms under the "
          f"profiler, device busy {busy_us / 1e3:.1f} ms "
          f"({100 * busy_us / 1e6 / wall:.1f}%)", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:16]:
        print(f"  {e.self_device_time_total / steps:9.2f} us/step  "
              f"{e.count:6d}x  {e.key[:70]}", flush=True)
    print(f"profile: the profiled copy ends at step {fs.step} with flags "
          f"{int(fs.flags):#x}, at most {max_cell_count(fs, system)}"
          f" beads in a cell", flush=True)


def timings(fn, reps, warmup=3):
    """(device ms, wall ms, source of the device ms) per call of ``fn``.
    Device time is the sum of the device activities a torch.profiler trace
    of ``reps`` calls holds (source "profiler").  The profiler now and then
    records no device activity at all, or an activity too few or too many:
    each kernel's mean time then counts as often a call as the trace
    holds it to the nearest whole number (source "profiler, normalised",
    the counts printed).  After four traces with no device time it is the
    mean of CUDA-event pairs around each call, recorded while a sleep
    kernel holds the stream, so that every call is queued before the first
    runs and the events see device time, not the host's (source
    "events").  Wall time is CUDA events around ``reps`` back-to-back
    calls, which for a short kernel is the host's time to issue the call.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(stop) / reps
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count]
        if sum(e.self_device_time_total for e in kern) > 0:
            if all(e.count % reps == 0 for e in kern):
                busy_us = sum(e.self_device_time_total for e in kern)
                return busy_us / reps / 1e3, wall_ms, "profiler"
            print(f"timings: a trace of {reps} calls held " + ", ".join(
                f"{e.key[:40]} x{e.count}" for e in kern), flush=True)
            busy_us = sum(e.self_device_time_total / e.count
                          * round(e.count / reps) for e in kern)
            return busy_us / 1e3, wall_ms, "profiler, normalised"
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    # spin long enough (2e6 cycles a ms at <= 2 GHz) for the host to queue
    # all the calls: twice their back-to-back wall time, plus 20 ms
    torch.cuda._sleep(int((2 * reps * wall_ms + 20) * 2e6))
    for a, b in pairs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in pairs) / reps
    print(f"timings: four profiler traces held no device time; device ms "
          f"{ms:.4f} from CUDA events queued behind a sleep", flush=True)
    return ms, wall_ms, "events"


def kernel_phases(fs, sim, g):
    """The kernels both paths launch (kick_drift_halo, extruder_springs,
    langevin_kick_monitor) vs their plain versions on the same card
    tensors, at the shapes of the run that left ``fs`` (``g`` its
    GridConsts).  Returns per-kernel records (no launch counts), each with
    its bound from these tensors."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import kernels_ref as R
    from lammps_le_torch.fast.consts import SpringConsts
    from lammps_le_torch.fast.maps import fast_maps

    system = sim.system
    maps = fast_maps(system)
    S = SpringConsts(system, sim.ex_btype)
    n = system.n
    kick = 0.5 * sim.dt / float(system.masses[0])
    cap, P = maps.cap, maps.P
    H = int(g.halo_cols.shape[0])
    recs = {}

    # kick_drift_halo: bitwise
    kd_args = (fs.gx, fs.gv, fs.gf, fs.bid, g.interior, g.halo_cols,
               g.halo_src, g.halo_shift, n, kick, sim.dt)
    gx_k, gv_k = K.kick_drift_halo(*kd_args)
    gx_r, gv_r = R.kick_drift_halo(*kd_args)
    if not (torch.equal(gx_k, gx_r) and torch.equal(gv_k, gv_r)):
        fail("kick_drift_halo differs from its plain version")
    err = max(float((gx_k - gx_r).abs().max()),
              float((gv_k - gv_r).abs().max()))
    recs["kick_drift_halo"] = dict(
        replaces="lammps_le_tpu/fast/pallas_step.py:731", max_abs_err=err,
        tol="bitwise",
        # x, v, f, bid in, x, v out per slot; the halo list; 18 operations
        # a slot, 3 a halo copy
        bound=bound(cap * P * (36 + 4 + 24) + P + H * 20,
                    cap * P * 18 + cap * H * 3),
        t=timings(lambda: K.kick_drift_halo(*kd_args), 50),
        t_plain=timings(lambda: R.kick_drift_halo(*kd_args), 20))

    # extruder_springs (in place on copies of the run's forces)
    active = fs.ex_left >= 0
    if not bool(active.any()):
        fail("no active extruder at the end of the production run")
    exl = fs.exl_slot
    sp_args = (exl, fs.exr_slot, active, S)
    f_k = fs.gf.clone()
    f_r = fs.gf.clone()
    eb_k = K.extruder_springs(fs.gx, f_k, *sp_args)
    eb_r = R.extruder_springs(fs.gx, f_r, *sp_args)
    fmax = float(f_r.abs().max())
    err = float((f_k - f_r).abs().max())
    if not err <= F_REL * max(fmax, 1.0):
        fail(f"extruder_springs force error {err} vs max|f| {fmax}")
    ek, er = float(eb_k.double().sum()), float(eb_r.double().sum())
    if not abs(ek - er) <= E_ABS + E_REL * abs(er):
        fail(f"extruder_springs energy {ek} vs {er}")
    scratch = fs.gf.clone()
    recs["extruder_springs"] = dict(
        replaces="lammps_le_tpu/fast/pallas_step.py:776", max_abs_err=err,
        tol=f"{F_REL}*max|f|={F_REL * max(fmax, 1.0):.3g}",
        n_active=int(active.sum()),
        # per slot: two anchor slots and the active bit in, the energy
        # out; per active spring: two anchors' x and f in, f out, ~40
        # operations, 4 of them divisions (3 for the minimum image)
        bound=bound(exl.shape[0] * 13 + int(active.sum()) * 2 * 36,
                    int(active.sum()) * 36, divs=int(active.sum()) * 4),
        t=timings(lambda: K.extruder_springs(fs.gx, scratch, *sp_args), 50),
        t_plain=timings(
            lambda: R.extruder_springs(fs.gx, scratch, *sp_args), 20))

    # langevin_kick_monitor: noise planes bitwise (zero v and f, unit
    # gamma2), then the production arguments
    key = (123456789, 987654321)
    sstep = fs.step
    zeros = torch.zeros_like(fs.gx)
    nz_args = (fs.gx, fs.gx_ref, zeros, zeros, fs.bid, g.interior, key,
               sstep, 0.0, 1.0, 0.0, sim.dt, 1.0, 1.0, n, True)
    noise_k = K.langevin_kick_monitor(*nz_args)[0]
    valid = R.valid_mask(fs.bid, g.interior, n).to(torch.float32)
    noise_r = R.langevin_noise(key, fs.bid, sstep, torch.float32) * valid
    if not torch.equal(noise_k, noise_r):
        fail("Langevin noise planes differ from the plain threefry")
    lm_args = (fs.gx, fs.gx_ref, fs.gv, fs.gf, fs.bid, g.interior, key,
               sstep, -0.1, 0.7, kick, sim.dt, 0.3, 0.2, n, True)
    gf_k2, gv_k2, in_k = K.langevin_kick_monitor(*lm_args)
    gf_r2, gv_r2, in_r = R.langevin_kick_monitor(*lm_args)
    fmax = float(gf_r2.abs().max())
    err = max(float((gf_k2 - gf_r2).abs().max()),
              float((gv_k2 - gv_r2).abs().max()))
    if not err <= F_REL * max(fmax, 1.0) or not torch.equal(in_k, in_r):
        fail(f"langevin_kick_monitor error {err}, ints {in_k.tolist()} vs "
             f"{in_r.tolist()}")
    recs["langevin_kick_monitor"] = dict(
        replaces="lammps_le_tpu/fast/pallas_step.py:932", max_abs_err=err,
        tol="noise bitwise; f, v 3e-5*max|f|",
        # x, x_ref, v, f, bid in, f, v out per slot; ~46 f32 operations a
        # slot (the threefry integer work is not counted)
        bound=bound(cap * P * (48 + 4 + 24) + P, cap * P * 46),
        t=timings(lambda: K.langevin_kick_monitor(*lm_args), 50),
        t_plain=timings(lambda: R.langevin_kick_monitor(*lm_args), 5))
    return recs


def stencil_phase(fs, sim, g):
    """stencil_forces vs its plain version on the 100k planes: forces
    within 3e-5 max|f|, energies, flags and clamps.  Returns its record
    (no launch count)."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import kernels_ref as R
    from lammps_le_torch.fast.consts import StencilConsts
    from lammps_le_torch.fast.maps import fast_maps

    system = sim.system
    maps = fast_maps(system)
    n = system.n
    st_args = (fs.gx, fs.bid, fs.hn, fs.pid, g.interior,
               StencilConsts(system), n, maps.strides, True)
    gf_k, en_k, in_k = K.stencil_forces(*st_args)
    gf_r, en_r, in_r = R.stencil_forces(*st_args)
    fmax = float(gf_r.abs().max())
    err = float((gf_k - gf_r).abs().max())
    if not err <= F_REL * max(fmax, 1.0):
        fail(f"stencil_forces force error {err} vs max|f| {fmax}")
    de = (en_k.double() - en_r.double()).abs()
    if not bool(torch.all(de <= E_ABS + E_REL * en_r.double().abs())):
        fail(f"stencil_forces energies {en_k.tolist()} vs {en_r.tolist()}")
    if not torch.equal(in_k, in_r):
        fail(f"stencil_forces flags/clamps {in_k.tolist()} vs "
             f"{in_r.tolist()}")
    return dict(
        replaces="lammps_le_tpu/fast/pallas_step.py:249", max_abs_err=err,
        tol=f"{F_REL}*max|f|={F_REL * max(fmax, 1.0):.3g}",
        energies=en_k.tolist(), energies_plain=en_r.tolist(),
        bound=stencil_bound("stencil_forces", fs, g, maps, n),
        t=timings(lambda: K.stencil_forces(*st_args), 20),
        t_plain=timings(lambda: R.stencil_forces(*st_args), 3, 1))


def newton_phase(fs, sim, g):
    """newton_half_forces vs its plain version on the config-6 planes at
    the end of that run: forces within 3e-5 max|f|, energies, flags and
    clamps, ghost columns exactly 0, two launches bitwise equal; and vs
    the full 27-offset stencil on the same planes (forces within 2e-4
    max|f|, flags and clamps equal).  Device time per call
    of the kernel, its plain version and stencil_forces.  Returns the
    kernel's record (no launch count)."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import kernels_ref as R
    from lammps_le_torch.fast.consts import StencilConsts
    from lammps_le_torch.fast.maps import fast_maps

    system = sim.system
    maps = fast_maps(system)
    C, n = StencilConsts(system), system.n
    args = (fs.gx, fs.bid, fs.hn, fs.pid, g.interior, g.faces, C, n,
            maps.strides, maps.fold_shifts, True)
    k1 = K.newton_half_forces(*args)
    k2 = K.newton_half_forces(*args)
    bitwise = all(torch.equal(a, b) for a, b in zip(k1, k2))
    gf_k, en_k, in_k = k1
    gf_r, en_r, in_r = R.newton_half_forces(*args)
    fmax = float(gf_r.abs().max())
    err = float((gf_k - gf_r).abs().max())
    tol = F_REL * max(fmax, 1.0)
    ghost = float(gf_k[:, :, ~g.interior].abs().max())
    de = (en_k.double() - en_r.double()).abs()
    e_ok = bool(torch.all(de <= E_ABS + E_REL * en_r.double().abs()))
    st_args = (fs.gx, fs.bid, fs.hn, fs.pid, g.interior, C, n, maps.strides,
               True)
    gf_s, en_s, in_s = K.stencil_forces(*st_args)
    valid = R.valid_mask(fs.bid, g.interior, n)
    err_full = float((gf_s * valid - gf_k).abs().max())
    print(f"newton_half_forces at {tuple(fs.gx.shape)}: max_abs_err "
          f"{err:.3g} (tol {tol:.3g}), energies {en_k.tolist()} vs plain "
          f"{en_r.tolist()}, flags/clamps {in_k.tolist()} vs "
          f"{in_r.tolist()}, ghost max {ghost}, two launches bitwise "
          f"{bitwise}; vs stencil_forces max|df| {err_full:.3g}, energies "
          f"{en_s.tolist()}, flags/clamps {in_s.tolist()}", flush=True)
    if not err <= tol:
        fail(f"newton_half_forces force error {err} vs max|f| {fmax}")
    if not e_ok:
        fail(f"newton_half_forces energies {en_k.tolist()} vs "
             f"{en_r.tolist()}")
    if not torch.equal(in_k, in_r):
        fail(f"newton_half_forces flags/clamps {in_k.tolist()} vs "
             f"{in_r.tolist()}")
    if ghost != 0.0:
        fail(f"newton_half_forces left {ghost} on a ghost column")
    if not bitwise:
        fail("two newton_half_forces launches on the same inputs differ")
    if not err_full <= F_REL_STENCILS * max(fmax, 1.0) or not torch.equal(
            in_s, in_k):
        fail(f"newton_half_forces vs stencil_forces: {err_full}, "
             f"{in_k.tolist()} vs {in_s.tolist()}")
    return dict(
        replaces="lammps_le_tpu/fast/blocked_kernel.py:90", max_abs_err=err,
        tol=f"{F_REL}*max|f|={tol:.3g}; bitwise run to run",
        bound=stencil_bound("newton_half_forces", fs, g, maps, n),
        bound_full=stencil_bound("stencil_forces", fs, g, maps, n),
        t=timings(lambda: K.newton_half_forces(*args), 20),
        t_plain=timings(lambda: R.newton_half_forces(*args), 3, 1),
        t_full=timings(lambda: K.stencil_forces(*st_args), 20))


def shard_phase(fs, sim, g, dev):
    """window_forces vs its plain version on the windows of the measured
    100k planes at each sp of SP_PHASES (forces within 3e-5 max|f|,
    energies, exact counts, two launches bitwise equal), and the sharded
    stencil's assembled, folded forces vs stencil_forces on the same
    planes (2e-4 max|f|, flags and clamps equal, ghost columns 0).
    Prints per sp the device ms of window_forces, of the whole sharded
    stencil (windows, kernel, reactions, fold), of stencil_forces and of
    newton_half_forces.  Returns the record of window_forces at
    SP_PATH, the path's slab count (no launch count)."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import kernels_ref as R
    from lammps_le_torch.fast.consts import StencilConsts
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.parallel.shard_step import make_sharded_kernel

    system = sim.system
    maps = fast_maps(system)
    C, n = StencilConsts(system), system.n
    planes = (fs.gx, fs.bid, fs.hn, fs.pid)
    st_args = (*planes, g.interior, C, n, maps.strides, True)
    nh_args = (*planes, g.interior, g.faces, C, n, maps.strides,
               maps.fold_shifts, True)
    gf_s, en_s, in_s = K.stencil_forces(*st_args)
    valid = R.valid_mask(fs.bid, g.interior, n)
    fmax = float(gf_s.abs().max())
    t_full = timings(lambda: K.stencil_forces(*st_args), 20)
    t_newton = timings(lambda: K.newton_half_forces(*nh_args), 20)
    rec = None
    for sp in SP_PHASES:
        kern = make_sharded_kernel(system, maps, sim.ex_btype, [dev] * sp)
        (slabs, wargs), = kern.window_args(*planes, True)
        k1 = K.window_forces(*wargs)
        k2 = K.window_forces(*wargs)
        bitwise = all(torch.equal(a, b) for a, b in zip(k1, k2))
        (f_k, st_k), (f_r, st_r) = k1, R.window_forces(*wargs)
        wmax = float(f_r.abs().max())
        err = float((f_k - f_r).abs().max())
        tol = F_REL * max(wmax, 1.0)
        de = (st_k[:2].double() - st_r[:2].double()).abs()
        e_ok = bool(torch.all(de <= E_ABS + E_REL * st_r[:2].double().abs()))
        counts_ok = torch.equal(st_k[2:], st_r[2:])
        gf_k, en_k, in_k = kern(g, *planes, True)
        err_full = float((gf_s * valid - gf_k).abs().max())
        ghost = float(gf_k[:, :, ~g.interior].abs().max())
        t_fn = timings(lambda: kern(g, *planes, True), 20)
        print(f"sharded stencil sp={sp} (windows {tuple(wargs[0].shape)}, "
              f"margin {kern.margin}, chunk {kern.chunk}): window_forces "
              f"max_abs_err {err:.3g} (tol {tol:.3g}), stats "
              f"{st_k.tolist()} vs plain {st_r.tolist()}, two launches "
              f"bitwise {bitwise}; assembled vs stencil_forces max|df| "
              f"{err_full:.3g}, energies {en_k.tolist()} vs "
              f"{en_s.tolist()}, flags/clamps {in_k.tolist()} vs "
              f"{in_s.tolist()}, ghost max {ghost}", flush=True)
        if not err <= tol or not e_ok or not counts_ok:
            fail(f"window_forces at sp={sp}: {err} vs tol {tol}, stats "
                 f"{st_k.tolist()} vs {st_r.tolist()}")
        if not bitwise:
            fail(f"two window_forces launches at sp={sp} differ")
        if not err_full <= F_REL_STENCILS * max(fmax, 1.0) or not (
                torch.equal(in_k, in_s)) or ghost != 0.0:
            fail(f"sharded stencil at sp={sp} vs stencil_forces: "
                 f"{err_full}, {in_k.tolist()} vs {in_s.tolist()}, ghost "
                 f"{ghost}")
        r = dict(
            replaces="lammps_le_tpu/parallel/shard_step.py:55",
            max_abs_err=err, tol=f"{F_REL}*max|f|={tol:.3g}; bitwise run to "
            f"run; assembled vs stencil_forces {F_REL_STENCILS}*max|f|",
            bound=window_bound(wargs, n),
            t=timings(lambda: K.window_forces(*wargs), 20),
            t_plain=timings(lambda: R.window_forces(*wargs), 3, 1))
        print(f"sharded stencil sp={sp}, device ms per call ({card_line()}): "
              f"window_forces {r['t'][0]:.4f} (bound {r['bound'][0]:.4f} by "
              f"{r['bound'][1]}; plain {r['t_plain'][0]:.4f}), the whole "
              f"sharded stencil {t_fn[0]:.4f} (wall {t_fn[1]:.4f}), "
              f"stencil_forces {t_full[0]:.4f}, newton_half_forces "
              f"{t_newton[0]:.4f}", flush=True)
        if sp == SP_PATH:
            rec = r
    return rec


def tiled_phase(fs, sim, g):
    """tiled_stencil_forces vs its plain version on the measured 100k
    planes (forces within 3e-5 max|f|, energies, flags and clamps equal)
    and vs stencil_forces (2e-4 max|f|, flags and clamps equal).  Returns
    its record (no launch count), with stencil_forces' time on the same
    planes."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import kernels_ref as R
    from lammps_le_torch.fast.consts import StencilConsts
    from lammps_le_torch.fast.maps import fast_maps

    system = sim.system
    maps = fast_maps(system)
    n = system.n
    args = (fs.gx, fs.bid, fs.hn, fs.pid, g.interior, StencilConsts(system),
            n, maps.strides, True)
    gf_k, en_k, in_k = K.tiled_stencil_forces(*args)
    gf_r, en_r, in_r = R.tiled_stencil_forces(*args)
    gf_s, en_s, in_s = K.stencil_forces(*args)
    fmax = float(gf_r.abs().max())
    err = float((gf_k - gf_r).abs().max())
    tol = F_REL * max(fmax, 1.0)
    err_full = float((gf_s - gf_k).abs().max())
    de = (en_k.double() - en_r.double()).abs()
    e_ok = bool(torch.all(de <= E_ABS + E_REL * en_r.double().abs()))
    print(f"tiled_stencil_forces at {tuple(fs.gx.shape)}: max_abs_err "
          f"{err:.3g} (tol {tol:.3g}), energies {en_k.tolist()} vs plain "
          f"{en_r.tolist()}, flags/clamps {in_k.tolist()} vs "
          f"{in_r.tolist()}; vs stencil_forces max|df| {err_full:.3g}, "
          f"energies {en_s.tolist()}, flags/clamps {in_s.tolist()}",
          flush=True)
    if not err <= tol or not e_ok or not torch.equal(in_k, in_r):
        fail(f"tiled_stencil_forces vs its plain version: {err} (tol {tol}),"
             f" {en_k.tolist()} vs {en_r.tolist()}, {in_k.tolist()} vs "
             f"{in_r.tolist()}")
    if not err_full <= F_REL_STENCILS * max(fmax, 1.0) or not torch.equal(
            in_s, in_k):
        fail(f"tiled_stencil_forces vs stencil_forces: {err_full}, "
             f"{in_k.tolist()} vs {in_s.tolist()}")
    return dict(
        replaces="lammps_le_tpu/fast/pallas_kernel.py:59", max_abs_err=err,
        tol=f"{F_REL}*max|f|={tol:.3g}; vs stencil_forces "
        f"{F_REL_STENCILS}*max|f|",
        bound=stencil_bound("tiled_stencil_forces", fs, g, maps, n),
        t=timings(lambda: K.tiled_stencil_forces(*args), 20),
        t_plain=timings(lambda: R.tiled_stencil_forces(*args), 3, 1),
        t_full=timings(lambda: K.stencil_forces(*args), 20))


def zero_group_phase(fs, sim, g):
    """langevin_kick_monitor with ``zero`` over the group plane of the run
    that left ``fs`` (path 5), on its planes at the production gammas:
    against its plain version (forces and velocities within 3e-5 max|f|,
    flags and trigger equal), two launches bitwise equal; the random
    force alone (v, f, gamma1 and the kick 0) summed over the group per
    component within f32 round-off of 0; the forces and velocities of
    every slot outside the group bitwise those of the zero-off call.
    Returns its record (no launch count), with the time of the call
    without zero and group on the same planes."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import kernels_ref as R
    from lammps_le_torch.fixes import Langevin

    system = sim.system
    n, units = system.n, system.units
    lf = next(f for f in sim.fixes if isinstance(f, Langevin))
    mass = float(system.masses[0])
    kick = 0.5 * sim.dt * units.ftm2v / mass
    gamma1 = -mass / lf.damp / units.ftm2v
    gamma2 = float(np.sqrt(mass) * np.sqrt(
        24.0 * units.boltz / (lf.damp * sim.dt) / units.mvv2e) / units.ftm2v)
    key, lgm = (123456789, 987654321), fs.lgm
    cap, P = fs.bid.shape
    head = (fs.gx, fs.gx_ref, fs.gv, fs.gf, fs.bid, g.interior, key, fs.step,
            gamma1, gamma2, kick, sim.dt, 0.3, 0.2, n, True)
    on = head + (lgm, True)
    k1 = K.langevin_kick_monitor(*on)
    k2 = K.langevin_kick_monitor(*on)
    bitwise = all(torch.equal(a, b) for a, b in zip(k1, k2))
    r = R.langevin_kick_monitor(*on)
    fmax = float(r[0].abs().max())
    err = max(float((k1[0] - r[0]).abs().max()),
              float((k1[1] - r[1]).abs().max()))
    tol = F_REL * max(fmax, 1.0)
    zeros = torch.zeros_like(fs.gx)
    rf = (fs.gx, fs.gx_ref, zeros, zeros, fs.bid, g.interior, key, fs.step,
          0.0, gamma2, 0.0, sim.dt, 0.3, 0.2, n, True, lgm)
    s_on = K.langevin_kick_monitor(*rf, True)[0].double().sum((1, 2))
    s_off = K.langevin_kick_monitor(*rf, False)[0].double().sum((1, 2))
    cnt = float(lgm.sum())
    # the sum of cnt terms of |gamma2 * noise| <= |gamma2| / 2 in f32: the
    # tree sum of the mean's pass (depth <= log2(cap * P) + 3) and one
    # rounding each of the mean, of noise - mean and of its gamma2 product
    sum_tol = abs(gamma2) * cnt * 2.0 ** -24 * (
        0.5 * (np.log2(cap * P) + 3) + 3)
    off = K.langevin_kick_monitor(*head, lgm, False)
    out = ~(R.valid_mask(fs.bid, g.interior, n) & (lgm > 0))
    same = (torch.equal(k1[0][:, out], off[0][:, out])
            and torch.equal(k1[1][:, out], off[1][:, out]))
    print(f"langevin_kick_monitor zero+group on the path-5 planes ({int(cnt)}"
          f" members): max_abs_err {err:.3g} (tol {tol:.3g}), ints "
          f"{k1[2].tolist()} vs plain {r[2].tolist()}, two launches bitwise "
          f"{bitwise}; random force summed over the group {s_on.tolist()} "
          f"(tol {sum_tol:.3g}; with zero off {s_off.tolist()}); outside "
          f"the group bitwise the zero-off call's {same}", flush=True)
    if not err <= tol or not torch.equal(k1[2], r[2]):
        fail(f"langevin_kick_monitor zero+group vs its plain version: "
             f"{err} (tol {tol}), {k1[2].tolist()} vs {r[2].tolist()}")
    if not bitwise:
        fail("two langevin_kick_monitor zero+group launches differ")
    if not float(s_on.abs().max()) <= sum_tol:
        fail(f"the group's random force sums to {s_on.tolist()}, past "
             f"{sum_tol}")
    if not same:
        fail("zero changed forces or velocities outside the group")
    return dict(
        replaces="lammps_le_tpu/fast/pallas_step.py:932", max_abs_err=err,
        tol=f"{F_REL}*max|f|={tol:.3g}; bitwise run to run; group sum of "
        f"the random force <= {sum_tol:.3g}; outside the group bitwise the "
        f"zero-off call's",
        # bid, the interior mask and the group plane in for the mean;
        # x, x_ref, v, f in and f, v out per slot; ~46 f32 operations a
        # slot, 6 more for the weight and the mean (the threefry integer
        # work is not counted)
        bound=bound(cap * P * (48 + 4 + 4 + 24) + P, cap * P * 52),
        t=timings(lambda: K.langevin_kick_monitor(*on), 50),
        t_plain=timings(lambda: R.langevin_kick_monitor(*on), 5),
        t_nozero=timings(lambda: K.langevin_kick_monitor(*head), 50))


def group_temperatures(fs, system):
    """(T of the Langevin group's beads, T of the rest) from the planes,
    3 degrees of freedom a bead."""
    import torch

    from lammps_le_torch.fast import kernels_ref as R
    from lammps_le_torch.fast.maps import fast_maps

    interior = torch.as_tensor(fast_maps(system).interior,
                               device=fs.gv.device)
    valid = R.valid_mask(fs.bid, interior, system.n)
    member = valid & (fs.lgm > 0)
    mv2 = float(system.masses[0]) * (fs.gv.double() ** 2).sum(0)
    kb = system.units.boltz
    return tuple(float(mv2[m].sum()) / (3.0 * int(m.sum()) * kb)
                 for m in (member, valid & ~member))


def probe_phase():
    """P1 and P2 at the TPU probes' shapes.  For each run, its entry point
    (``rcp_chain``, ``precision``, ``chain``) is called once with the
    launch counts zeroed just before and read just after, and that result
    is held against its plain version on the card (P1 exact: bitwise, else
    within 1e-6 of max|acc|, the difference printed; P1 approximate:
    within one ulp of acc a step plus the reciprocal's 1 ulp scaled by
    1e-7; the approximate reciprocal within 2^-22 relative over both
    domains; P2 f32 bitwise, bf16 within one bf16 ulp of max|out|, the
    count that differ printed).  Then each kernel is timed (``timings``),
    and the rates and speedups printed come from those times.  Returns
    [(path, name, record)]."""
    import torch

    from lammps_le_torch import probes
    from lammps_le_torch.probes import probe_bf16 as B
    from lammps_le_torch.probes import probe_rcp as C

    dev = torch.device("cuda", 0)
    out = []
    x = torch.as_tensor(np.random.RandomState(0).uniform(
        0.5, 2.6, (C.ROWS, C.P)).astype(np.float32), device=dev)
    n, reps = x.numel(), C.REPS
    plain = C.rcp_chain_ref(x, reps)
    chain_ms = {}
    for approx in (False, True):
        probes.reset_launches()
        got = C.rcp_chain(x, approx, reps)
        launches = probes.LAUNCHES["rcp_chain"]
        if launches != 1:
            fail(f"rcp_chain: {launches} launches in one call")
        err = float((got - plain).abs().max())
        amax = float(plain.abs().max())
        t = timings(lambda a=approx: C.rcp_chain(x, a, reps), 20)
        chain_ms[approx] = t[0]
        per_s = reps * n / (t[0] * 1e-3)
        if approx:
            # a step may round acc one ulp apart, and r * 1e-7 differs by
            # at most 1 ulp of r times 1e-7
            tol = reps * 2.0 ** -23 * (1e-7 * float((1.0 / x).max()) + amax)
            ok, how = err <= tol, f"<= {tol:.3g}, reps ulps of acc and r"
            b = bound(8 * n, 4 * reps * n, mufu=reps * n)
            rate = f"MUFU {per_s:.4g}/s of {RATES['mufu']:.4g}"
        else:
            same = torch.equal(got, plain)
            ok = same or err <= 1e-6 * amax
            how = "bitwise" if same else f"{err:.3g} <= 1e-6 max|acc|"
            b = bound(8 * n, 3 * reps * n, divs=reps * n)
            rate = (f"{(3 + RATES['div']) * per_s:.4g} instructions/s of "
                    f"{RATES['f32']:.4g}")
        label = "approx" if approx else "exact"
        print(f"P1 {label} chain ({C.ROWS}x{C.P}, {reps} steps): "
              f"{t[0]:.4f} ms a call ({t[2]}; {launches} launch); vs the "
              f"plain exact chain max|d| {err:.3g} ({how}); {rate}",
              flush=True)
        if not ok:
            fail(f"rcp_chain ({label}) vs its plain version: {err}")
        out.append((f"probe P1 {label}", "rcp_chain", dict(
            replaces="benchmarks/probe_rcp.py:23", max_abs_err=err, tol=how,
            launches=launches, bound=b, t=t,
            t_plain=timings(lambda: C.rcp_chain_ref(x, reps), 2, 1))))
    print(f"P1 speedup of the approximate reciprocal "
          f"{chain_ms[False] / chain_ms[True]:.2f}x", flush=True)

    probes.reset_launches()
    errs = [C.precision(lo, hi)[2] for lo, hi, _ in C.DOMAINS]
    launches = probes.LAUNCHES["rcp"]
    if launches != len(C.DOMAINS):
        fail(f"rcp: {launches} launches in {len(C.DOMAINS)} calls")
    exact = [C.precision(lo, hi, approx=False)[2] for lo, hi, _ in C.DOMAINS]
    xd = C.domain(*C.DOMAINS[1][:2])
    got = C.reciprocal(xd)
    err = float((got - 1.0 / xd).abs().max())
    print("P1 approximate reciprocal, max rel err: " + "; ".join(
        f"[{lo}, {hi}] ({label}) {e:.3e} (IEEE {ee:.3e})" for (
            lo, hi, label), e, ee in zip(C.DOMAINS, errs, exact)), flush=True)
    if not max(errs) <= 2.0 ** -22 or not max(exact) <= 2.0 ** -24:
        fail(f"reciprocal errors {errs} (approximate, want <= 2^-22), "
             f"{exact} (IEEE, want <= 2^-24)")
    out.append(("probe P1 precision", "rcp", dict(
        replaces="benchmarks/probe_rcp.py:63", max_abs_err=err,
        tol="max rel err <= 2^-22 over both domains", launches=launches,
        bound=bound(8 * xd.numel(), xd.numel(), mufu=xd.numel()),
        t=timings(lambda: C.reciprocal(xd), 50),
        t_plain=timings(lambda: 1.0 / xd, 50),
        t_lib=timings(lambda: torch.reciprocal(xd), 50))))

    run_ms = {}
    per_step = B.step_instructions()
    print("P2 compiled step (SASS of the main loop; arithmetic, all): "
          + "; ".join(f"{str(d)[6:]} {a:g}, {t:g}"
                      for d, (a, t) in per_step.items())
          + f" (the chain as written: {B.CHAIN_OPS})", flush=True)
    for rows, dtype, label in B.RUNS:
        xb = B.inputs(rows).to(dtype)
        probes.reset_launches()
        got = B.chain(xb, dtype)
        launches = probes.LAUNCHES["elementwise_chain"]
        if launches != 1:
            fail(f"elementwise_chain: {launches} launches in one call")
        want = B.chain_ref(xb, B.REPS)
        m = xb.numel()
        differ = int((got != want).sum())
        err = float((got - want).abs().max())
        t = timings(lambda x=xb, d=dtype: B.chain(x, d), 20)
        run_ms[rows, dtype] = t[0]
        # the compiled step's arithmetic a lane (an element in f32, a
        # pair in bf16) bounds it; all its instructions give the rate
        arith, total = per_step[dtype]
        lanes = m if dtype == torch.float32 else m // 2
        b = bound(m * (4 + xb.element_size()), arith * B.REPS * lanes)
        ins = total * B.REPS * lanes
        if dtype == torch.float32:
            ok, how = differ == 0, "bitwise"
        else:
            ulp = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
            ok = err <= ulp
            how = f"{differ} of {m} differ, by <= 1 bf16 ulp ({ulp:.3g})"
        name = str(dtype)[6:]
        print(f"P2 {label} ({rows} rows): {t[0]:.4f} ms a call ({t[2]}; "
              f"{launches} launch), "
              f"{B.OPS * m * B.REPS / (t[0] * 1e-3) / 1e12:.3f} T elem-op/s "
              f"by the TPU probe's count, "
              f"{ins / (t[0] * 1e-3):.4g} instructions/s of "
              f"{RATES['f32']:.4g}; vs the plain chain max|d| {err:.3g} "
              f"({how})", flush=True)
        if not ok:
            fail(f"elementwise_chain {name} {rows} rows vs its plain "
                 f"version: {err} ({differ} differ)")
        out.append((f"probe P2 {name} {rows} rows", "elementwise_chain",
                    dict(replaces="benchmarks/probe_bf16.py:29",
                         max_abs_err=err, tol=how, launches=launches,
                         bound=b, t=t,
                         t_plain=timings(
                             lambda x=xb: B.chain_ref(x, B.REPS), 2, 1))))
    f32, bf16 = torch.float32, torch.bfloat16
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"P2 done; SM clock, its maximum and power draw now: {clock}",
          flush=True)
    print(f"P2 bf16 speedup at 16 rows: "
          f"{run_ms[16, f32] / run_ms[16, bf16]:.2f}x; at 8 rows: "
          f"{run_ms[8, f32] / run_ms[8, bf16]:.2f}x", flush=True)
    return out


def bead_positions(fs, system):
    """The beads' positions, in bead order, from the planes."""
    from lammps_le_torch.fast.engine import extract_beads
    from lammps_le_torch.fast.maps import fast_maps

    return extract_beads(fs, fast_maps(system))[0]


def witness(label, sim, start, dev, kernel_fn, fs_ref, x_full,
            newton=False):
    """The path's window once more from the same settled state, with every
    call of its stencil ``kernel_fn`` also held against another stencil on
    the planes that call saw: with ``newton``, the whole-grid Newton-half
    stencil (forces within 3e-5 max|f|), else stencil_forces (2e-4
    max|f|); and against stencil_forces' flags and clamps (equal).  The
    path's own stencil drives the run, so it is the measured run again
    (its end is compared bitwise with ``fs_ref``).  A FENE clamp that the
    full stencil counts on the same planes comes from the trajectory, not
    from the path's stencil; how far the trajectory has drifted from the
    full-stencil path's is the largest minimum-image distance of a bead
    from its place ``x_full`` at the end of that path.  Prints the calls
    with clamps and the largest deviation from stencil_forces; fails on a
    disagreement."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import kernels_ref as R
    from lammps_le_torch.fast.consts import StencilConsts
    from lammps_le_torch.fast.maps import fast_maps

    system = sim.system
    maps = fast_maps(system)
    C, n = StencilConsts(system), system.n
    held, tol = (("newton_half_forces", F_REL) if newton
                 else ("stencil_forces", F_REL_STENCILS))
    log = []

    def shadowed(g, gx, bid, hn, pid, energy: bool):
        out = kernel_fn(g, gx, bid, hn, pid, energy)
        gf_s, _, in_s = K.stencil_forces(gx, bid, hn, pid, g.interior, C, n,
                                         maps.strides, energy)
        valid = R.valid_mask(bid, g.interior, n)
        scale = torch.clamp(gf_s.abs().max(), min=1.0)
        err_full = (gf_s * valid - out[0]).abs().max() / scale
        err = err_full
        if newton:
            gf_n = K.newton_half_forces(
                gx, bid, hn, pid, g.interior, g.faces, C, n, maps.strides,
                maps.fold_shifts, energy)[0]
            err = (gf_n - out[0]).abs().max() / scale
        log.append(torch.cat([torch.stack([err, err_full]).double(),
                              out[2].double(), in_s.double()]))
        return out

    fs = measured_segment(sim, start, dev, WARM, MEASURE, 0, shadowed)[0]
    rows = torch.stack(log).cpu()
    worst, worst_full = float(rows[:, 0].max()), float(rows[:, 1].max())
    over = int((rows[:, 1] > F_REL_STENCILS).sum())
    differ = (rows[:, 2:4] != rows[:, 4:6]).any(1).nonzero().view(-1)
    clamped = [(int(k), int(rows[k, 3]), int(rows[k, 5]))
               for k in (rows[:, 3] + rows[:, 5]).nonzero().view(-1)]
    same = (torch.equal(fs.gx, fs_ref.gx) and torch.equal(fs.gv, fs_ref.gv)
            and int(fs.n_clamps) == int(fs_ref.n_clamps))
    box = torch.as_tensor(np.asarray(system.box_size, np.float32),
                          device=fs.gx.device)
    d = bead_positions(fs, system) - x_full
    drift = float((d - box * torch.round(d / box)).norm(dim=-1).max())
    print(f"witness {label}: {len(log)} stencil calls (call 0 is the "
          f"set-up), each against {held} on its planes: max|df| / max(max|f|"
          f", 1) {worst:.3g} (tol {tol}); against stencil_forces "
          f"{worst_full:.3g}, over {F_REL_STENCILS} in {over} calls; "
          f"flags/clamps differ from stencil_forces' in {len(differ)} calls;"
          f" (call, clamps, full-stencil clamps) where either clamps: "
          f"{clamped}; end bitwise the measured run's {same}; a bead at most"
          f" {drift:.4g} from its place at the end of the full-stencil path",
          flush=True)
    if not worst <= tol or len(differ):
        fail(f"witness {label}: the path's stencil and {held} disagree on "
             f"the run's planes ({worst}, calls {differ.tolist()[:10]})")
    if not same:
        fail(f"witness {label}: the run did not repeat the measured run")


def overrun(sim, fs, dev, steps):
    """From copies of the checked config-6 state, ``steps`` steps past the
    measured window on each stencil (the engine's Newton-half one, then
    the full 27-offset one; the same state, keys and noise, so only the
    order of the force sums differs), reading after every step the flags
    and the fullest cell (what the next rebuild bins), to tell whether a
    cell outgrows cap on both stencils or on one.  Prints the steps where
    the flags change or a cell holds more than cap beads, and how many
    steps end with a cell at cap; checks nothing."""
    from lammps_le_torch.fast import make_fast_segment
    from lammps_le_torch.fast.engine import make_kernel
    from lammps_le_torch.fast.maps import fast_maps

    system = sim.system
    cap = system.neighbor.cell_cap
    for label, kernel_fn in (
            ("newton_half_forces", None),
            ("stencil_forces", make_kernel(system, fast_maps(system),
                                           sim.ex_btype))):
        segment = make_fast_segment(sim, dev, kernel_fn)
        c = dataclasses.replace(fs)
        b0 = c.step
        flags, at_cap, marks = int(c.flags), 0, []
        for _ in range(steps):
            segment(c, c.step, 1, b0, b0 + steps)
            fullest = max_cell_count(c, system)
            at_cap += fullest == cap
            if int(c.flags) != flags or fullest > cap:
                flags = int(c.flags)
                marks.append((c.step, f"{flags:#x}", fullest))
        print(f"overrun on {label}, steps {b0 + 1}-{c.step} (cap {cap}): "
              f"{at_cap} steps end with a cell at cap; (step, flags, "
              f"fullest cell) where the flags change or a cell holds more: "
              f"{marks}", flush=True)


def small_end_to_end(dev, steps=40, stencil="stencil_forces"):
    """A 2,000-bead run with every LE fix on the card (kernels) and on the
    CPU (plain versions), on the stencil ``stencil`` (the engine's full
    one, or as kernel_fn the Newton-half, the tiled or, with two slabs on
    the run's device, the sharded one): the same events, positions within
    1e-3; the CPU run launches no kernel, the card run each of its
    kernels once a step."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import run_fast
    from lammps_le_torch.fast.blocked_kernel import make_blocked_kernel
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.fast.pallas_kernel import make_pallas_kernel
    from lammps_le_torch.fixes import NVE, Langevin
    from lammps_le_torch.integrate import Simulation
    from lammps_le_torch.parallel.shard_step import make_sharded_kernel
    from lammps_le_torch.state import init_state

    data, system = production_config(2000, seed=5)
    maps = fast_maps(system)
    warm = Simulation(system=system, dt=0.006, ex_btype=2, fixes=(
        NVE(), Langevin(t_start=1.0, t_stop=1.0, damp=1.0, seed=7)))
    sim = Simulation(system=system, dt=0.005, energy_every=4, ex_btype=2,
                     fixes=le_fixes(5, 7, 0.3))
    kernel_fns = {
        "stencil_forces": lambda d: None,
        "newton_half_forces": lambda d: make_blocked_kernel(system, maps, 2),
        "tiled_stencil_forces": lambda d: make_pallas_kernel(system, maps, 2),
        "window_forces": lambda d: make_sharded_kernel(system, maps, 2,
                                                       [d] * 2)}
    out = {}
    for d in ("cpu", dev):
        st = init_state(system, data.x, types=data.types, seed=11, device=d)
        st = run_fast(warm, st, 30)
        st = seed_extruders(st, 20, 100, system.max_extruders)
        K.reset_launches()
        st = run_fast(sim, st, steps, kernel_fns[stencil](d))
        out[str(d)] = st, dict(K.LAUNCHES)
    (a, la), (b, lb) = out["cpu"], out[str(dev)]
    dx = float((a.x - b.x.cpu()).abs().max())
    same = (torch.equal(a.ex_left, b.ex_left.cpu())
            and torch.equal(a.ex_right, b.ex_right.cpu())
            and [int(a.n_moves), int(a.n_loads), int(a.n_unloads),
                 int(a.flags)]
            == [int(b.n_moves), int(b.n_loads), int(b.n_unloads),
                int(b.flags)])
    print(f"small end-to-end on {stencil} (2000 beads, {30 + steps} "
          f"steps): cuda vs cpu max|dx| {dx:.3g}, moves {int(b.n_moves)}, "
          f"loads {int(b.n_loads)}, unloads {int(b.n_unloads)}, same events "
          f"{same}, launches cpu {la} cuda {lb}", flush=True)
    if not same or not dx < 1e-3 or int(b.n_moves) == 0:
        fail("small end-to-end run: card and CPU disagree")
    # run_fast's setup evaluates the forces once more (to_fast)
    want = path_launches(lb, stencil, steps)
    want[stencil] = want["extruder_springs"] = steps + 1
    if any(la.values()) or lb != want:
        fail(f"small end-to-end launches: cpu {la}, cuda {lb} (want {want})")


def print_kernel(path, name, r):
    print(f"kernel {name} on the {path} path: {r['launches']} launches; "
          f"device {r['t'][0]:.4f} ms ({r['t'][2]}; plain "
          f"{r['t_plain'][0]:.4f} ms, {r['t_plain'][2]}; bound "
          f"{r['bound'][0]:.4f} ms by {r['bound'][1]}"
          + (f"; library {r['t_lib'][0]:.4f} ms, {r['t_lib'][2]}"
             if "t_lib" in r else "") + "); wall per "
          f"back-to-back call {r['t'][1]:.4f} ms (plain "
          f"{r['t_plain'][1]:.4f} ms); max_abs_err {r['max_abs_err']:.3g} "
          f"({r['tol']})", flush=True)


def path_launches(launches, stencil, steps=MEASURE):
    """The launches a path's measured window must hold: ``steps`` of its
    stencil and of each kernel every path runs, none of the other
    stencils."""
    stencils = ("stencil_forces", "newton_half_forces", "window_forces",
                "tiled_stencil_forces")
    want = {k: 0 if k in stencils else steps for k in launches}
    want[stencil] = steps
    return want


def path_records(path, phases, launches):
    """[(path, kernel name, record)] with each record's launch count from
    that path's measured window."""
    out = []
    for name, r in phases.items():
        r["launches"] = launches[name]
        out.append((path, name, r))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="profile STEPS more steps of each measured run")
    ap.add_argument("--overrun", type=int, default=300, metavar="STEPS",
                    help="run config 6 STEPS steps past its window on each "
                    "stencil, printing flags and the fullest cell")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lammps_le_torch.csrc.build import build
    from lammps_le_torch.fast.engine import whole_planes_fit
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.fast.pallas_kernel import make_pallas_kernel
    from lammps_le_torch.fast.place import GridConsts
    from lammps_le_torch.parallel.shard_step import shardable
    from lammps_le_torch.parallel.spatial import make_sharded_segment

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}; {card}", flush=True)
    t0 = time.perf_counter()
    libs = build()
    print(f"built {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    set_rates(card)
    recs = []

    # the 100k path: full 27-offset stencil, within the whole-plane gate
    data, system = production_config(BEADS)
    print(f"{system.n} beads, grid {system.neighbor.nx}x{system.neighbor.ny}"
          f"x{system.neighbor.nz}, cap {system.neighbor.cell_cap}",
          flush=True)
    sim, start = drive(system, data, dev)
    fs, wall, rebuilds, launches = measured_segment(
        sim, start, dev, WARM, MEASURE, args.profile)
    # every kernel of the path launches once a production step; rebuilds
    # and LE events launch none
    check_run("production", fs, system, wall, rebuilds, launches, MEASURE,
              GRID, path_launches(launches, "stencil_forces"))
    x_full = bead_positions(fs, system)
    g = GridConsts.build(system, fast_maps(system), dev)
    recs += path_records("100k", dict(
        stencil_forces=stencil_phase(fs, sim, g),
        **kernel_phases(fs, sim, g)), launches)
    sps = {"100k full stencil": MEASURE / wall}
    del fs
    torch.cuda.empty_cache()

    # path 3, the sharded slab stencil: the reference's gate, then the
    # same measured phase from the same settled state at SP_PATH slabs
    maps = fast_maps(system)
    for sp in (1, 2, 4):
        print(f"shardable at sp={sp}: "
              f"{shardable(system, maps, [dev] * sp) or 'yes'}", flush=True)
    segment = make_sharded_segment(sim, [dev] * SP_PATH)
    fs, wall, rebuilds, launches = measured_segment(
        sim, start, dev, WARM, MEASURE, args.profile, segment.kernel_fn,
        segment)
    check_run(f"sharded sp={SP_PATH}", fs, system, wall, rebuilds, launches,
              MEASURE, GRID, path_launches(launches, "window_forces"))
    sps[f"100k sharded sp={SP_PATH}"] = MEASURE / wall
    witness(f"sharded sp={SP_PATH}", sim, start, dev, segment.kernel_fn, fs,
            x_full, newton=True)
    recs += path_records("100k sharded", dict(
        window_forces=shard_phase(fs, sim, g, dev)), launches)
    del fs, segment
    torch.cuda.empty_cache()

    # path 4, the tiled full stencil as kernel_fn
    tiled_fn = make_pallas_kernel(system, maps, sim.ex_btype)
    fs, wall, rebuilds, launches = measured_segment(
        sim, start, dev, WARM, MEASURE, args.profile, tiled_fn)
    check_run("tiled", fs, system, wall, rebuilds, launches, MEASURE, GRID,
              path_launches(launches, "tiled_stencil_forces"))
    sps["100k tiled stencil"] = MEASURE / wall
    witness("tiled", sim, start, dev, tiled_fn, fs, x_full)
    tiled = tiled_phase(fs, sim, g)
    recs += path_records("100k tiled", dict(tiled_stencil_forces=tiled),
                         launches)
    print(f"100k stencils, device ms per call ({card}): "
          f"tiled_stencil_forces {tiled['t'][0]:.4f} ({tiled['t'][2]}; bound "
          f"{tiled['bound'][0]:.4f} by {tiled['bound'][1]}), stencil_forces "
          f"{tiled['t_full'][0]:.4f} ({tiled['t_full'][2]}; wall per "
          f"back-to-back call {tiled['t_full'][1]:.4f})", flush=True)
    del fs, start
    torch.cuda.empty_cache()

    # path 5, fix langevin zero + group: the production Langevin fix on
    # the group chain (beads 1-90,000) with zero yes, all phases anew
    member = np.zeros(system.n, bool)
    member[:N_CHAIN] = True
    groups = {"chain": member}
    sim5, start = drive(system, data, dev, groups)
    fs, wall, rebuilds, launches = measured_segment(
        sim5, start, dev, WARM, MEASURE, args.profile, groups=groups)
    check_run("zero+group", fs, system, wall, rebuilds, launches, MEASURE,
              GRID, path_launches(launches, "stencil_forces"))
    sps["100k langevin zero+group"] = MEASURE / wall
    t_in, t_out = group_temperatures(fs, system)
    print(f"zero+group: T over the group's {N_CHAIN} beads {t_in:.4f}, over "
          f"the other {system.n - N_CHAIN} {t_out:.4f}", flush=True)
    zg = zero_group_phase(fs, sim5, g)
    recs += path_records("100k langevin zero+group",
                         dict(langevin_kick_monitor=zg), launches)
    print(f"langevin_kick_monitor on the path-5 planes, device ms per call "
          f"({card}): zero+group {zg['t'][0]:.4f}, without zero and group "
          f"{zg['t_nozero'][0]:.4f}: the zero pass and the group plane cost "
          f"{zg['t'][0] - zg['t_nozero'][0]:.4f}", flush=True)
    print(f"100k steps/s in this call ({card}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in sps.items()), flush=True)
    del fs, g, start, x_full
    torch.cuda.empty_cache()

    # config 6: past the whole-plane gate, the Newton-half stencil
    t0 = time.perf_counter()
    data, system = config6_system()
    maps = fast_maps(system)
    print(f"config 6: {system.n} beads, grid {system.neighbor.nx}x"
          f"{system.neighbor.ny}x{system.neighbor.nz}, cap {maps.cap}, P "
          f"{maps.P}, whole planes fit {whole_planes_fit(maps)}; host set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if (maps.cap, maps.P) != C6["grid"] or whole_planes_fit(maps):
        fail(f"config 6 grid ({maps.cap}, {maps.P}), want {C6['grid']} past "
             f"the whole-plane gate")
    torch.cuda.reset_peak_memory_stats()
    sim, fs, wall, rebuilds, launches = drive_config6(data, system, dev,
                                                      args.profile)
    check_run("config 6", fs, system, wall, rebuilds, launches,
              C6["measure"], C6["grid"],
              path_launches(launches, "newton_half_forces", C6["measure"]))
    print(f"config 6 peak device memory {torch.cuda.max_memory_allocated()} "
          f"B of {torch.cuda.get_device_properties(0).total_memory} B "
          f"({card})", flush=True)
    g = GridConsts.build(system, maps, dev)
    recs += path_records("config6", dict(
        newton_half_forces=newton_phase(fs, sim, g),
        **kernel_phases(fs, sim, g)), launches)
    if args.overrun:
        overrun(sim, fs, dev, args.overrun)
    del fs, g
    torch.cuda.empty_cache()
    full = next(r for _, name, r in recs if name == "newton_half_forces")
    print(f"config 6 stencils, device ms per call ({card}): "
          f"newton_half_forces {full['t'][0]:.4f}, stencil_forces "
          f"{full['t_full'][0]:.4f} ({full['t_full'][2]}; bound "
          f"{full['bound_full'][0]:.4f} by {full['bound_full'][1]}), plain "
          f"newton_half_forces {full['t_plain'][0]:.4f}", flush=True)

    # the microprobes P1 and P2, each run on its own, on a warm card
    recs += probe_phase()
    for path, name, r in recs:
        print_kernel(path, name, r)

    small_end_to_end(dev)
    small_end_to_end(dev, stencil="newton_half_forces")

    print(json.dumps({"kernels": [
        {"name": name, "path": path, "route": "cuda",
         "source": "lammps_le_torch/csrc/" + SOURCES.get(name, "step.cu"),
         "replaces": r["replaces"], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["t"][0],
         "ms_source": r["t"][2], "plain_ms": r["t_plain"][0],
         "plain_ms_source": r["t_plain"][2], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1],
         "library_ms": r["t_lib"][0] if "t_lib" in r else None}
        for path, name, r in recs]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
