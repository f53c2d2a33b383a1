#!/usr/bin/env python3
"""Smoke run of the lammps_le_torch port on one CUDA card.

Drives the port's two paths through its user entry points:

* bench.py's production LE configuration (bench.py:398-486): a
  100,000-bead serpentine chromosome on the grid-resident fast engine,
  thermalized, settled with 500 seeded extruders, then 1,500 measured
  production steps with extrusion, ex_load and ex_unload, on the full
  27-offset stencil;
* config 6 (benchmarks/configs.py:269-362): a 1,000,000-bead chromosome
  past the whole-plane gate, where the engine takes the Newton-half
  stencil, with 5,000 seeded extruders and 600 measured steps.

After each it holds that path's hand-written CUDA kernels against their
plain PyTorch versions at the shapes the run gave them and times both
(one record per path and kernel); after config 6 it runs copies of its
state on past the window on both stencils, printing flags and the
fullest cell; then it runs a small system end to end on the card and on
the CPU, on both stencils, to compare the two.

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

# the card's peaks for the bound columns (NVIDIA's H100 SXM data sheet, at
# 700 W): memory bytes/s and f32 operations/s outside the tensor cores
HBM_BPS, F32_OPS = 3.35e12, 67e12
# f32 operations of one examined slot pair, the arithmetic every pair
# does (3 differences, 5 for r^2, 1 division, 2 for r^6, 4 for the force
# factor, 6 to scale and add the force); the Newton-half stencil adds 3
# for the reaction.  Comparisons and the terms of the few pairs in bond
# or energy range are not counted.
PAIR_OPS = {"stencil_forces": 21, "newton_half_forces": 24}


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
             release_r=0.0):
    from lammps_le_torch.fixes import (NVE, ExLoad, ExUnload, Extrusion,
                                       Langevin)

    return (
        NVE(),
        Langevin(t_start=1.0, t_stop=1.0, damp=10.0, seed=904297),
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


def timed_run(label, sim, state, steps):
    """``run_fast`` with its wall time and flags printed."""
    import torch

    from lammps_le_torch.fast import run_fast

    t0 = time.perf_counter()
    state = run_fast(sim, state, steps)
    torch.cuda.synchronize()
    print(f"{label} {steps} steps {time.perf_counter() - t0:.2f} s, "
          f"flags={int(state.flags):#x}", flush=True)
    return state


def measured_segment(sim, state, dev, warm, measure, profile_steps):
    """``warm`` steps, then ``measure`` timed steps with the launch counts
    zeroed just before them and read just after.  Returns (FastState,
    measured wall s, rebuilds and kernel launches in the window)."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import make_fast_segment, to_fast

    segment = make_fast_segment(sim, dev)
    fs = to_fast(state, sim)
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


def drive(system, data, dev, profile_steps=0):
    """bench.py's thermalize / settle / measure phases on the port.
    Returns (FastState, production Simulation, measured wall s,
    rebuilds and kernel launches in the measured window)."""
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
    sim = Simulation(system=system, dt=0.006, energy_every=100,
                     fixes=le_fixes(), ex_btype=2)
    settle = Simulation(system=system, dt=0.002, fixes=sim.fixes,
                        ex_btype=2)
    state = timed_run("settle", settle, state, SETTLE)
    # bench.py's R=1 replica: key folded with replica seed 100
    state = state.replace(
        flags=torch.zeros_like(state.flags),
        key=torch.tensor(rng.fold_in(state.key.tolist(), 100),
                         dtype=torch.int64, device=dev))
    return (sim,) + measured_segment(sim, state, dev, WARM, MEASURE,
                                     profile_steps)


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


def bound(nbytes, ops):
    """(ms, what bounds it): the least time an H100 SXM takes to move
    ``nbytes`` or to do ``ops`` f32 operations, whichever is longer."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    ops = 0
    for (a, b, c) in (R.HALF_OFFSETS if newton else _OFFSETS):
        delta = a * sx + b * sy + c * sz
        if delta == 0:
            ops += int((n_i * (occ - 1)).sum()) * PAIR_OPS["stencil_forces"]
        else:
            ops += int((n_i * torch.roll(occ, -delta)).sum()) * PAIR_OPS[name]
    nbytes = cap * P * (12 + 4 + 1 + 4 + 12) + P * (1 + 6 * newton)
    return bound(nbytes, ops)


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
    records no device activity at all; after four such traces it is the
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
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        if busy_us > 0:
            return busy_us / reps / 1e3, wall_ms, "profiler"
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
        # operations
        bound=bound(exl.shape[0] * 13 + int(active.sum()) * 2 * 36,
                    int(active.sum()) * 40),
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


def small_end_to_end(dev, steps=40, newton_half=False):
    """A 2,000-bead run with every LE fix on the card (kernels) and on the
    CPU (plain versions), on the full stencil or (``newton_half``) on the
    Newton-half one: the same events, positions within 1e-3; the CPU run
    launches no kernel, the card run each of its kernels once a step."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import run_fast
    from lammps_le_torch.fast.blocked_kernel import make_blocked_kernel
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.fixes import NVE, Langevin
    from lammps_le_torch.integrate import Simulation
    from lammps_le_torch.state import init_state

    data, system = production_config(2000, seed=5)
    warm = Simulation(system=system, dt=0.006, ex_btype=2, fixes=(
        NVE(), Langevin(t_start=1.0, t_stop=1.0, damp=1.0, seed=7)))
    sim = Simulation(system=system, dt=0.005, energy_every=4, ex_btype=2,
                     fixes=le_fixes(5, 7, 0.3))
    kernel_fn = (make_blocked_kernel(system, fast_maps(system), 2)
                 if newton_half else None)
    stencil = "newton_half_forces" if newton_half else "stencil_forces"
    out = {}
    for d in ("cpu", dev):
        st = init_state(system, data.x, types=data.types, seed=11, device=d)
        st = run_fast(warm, st, 30)
        st = seed_extruders(st, 20, 100, system.max_extruders)
        K.reset_launches()
        st = run_fast(sim, st, steps, kernel_fn)
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
    want = dict.fromkeys(lb, steps)
    want["stencil_forces"] = want["newton_half_forces"] = 0
    want[stencil] = want["extruder_springs"] = steps + 1
    if any(la.values()) or lb != want:
        fail(f"small end-to-end launches: cpu {la}, cuda {lb} (want {want})")


def print_kernel(path, name, r):
    print(f"kernel {name} on the {path} path: {r['launches']} launches; "
          f"device {r['t'][0]:.4f} ms ({r['t'][2]}; plain "
          f"{r['t_plain'][0]:.4f} ms, {r['t_plain'][2]}; bound "
          f"{r['bound'][0]:.4f} ms by {r['bound'][1]}); wall per "
          f"back-to-back call {r['t'][1]:.4f} ms (plain "
          f"{r['t_plain'][1]:.4f} ms); max_abs_err {r['max_abs_err']:.3g} "
          f"({r['tol']})", flush=True)


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
    from lammps_le_torch.fast.place import GridConsts

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

    # the 100k path: full 27-offset stencil, within the whole-plane gate
    data, system = production_config(BEADS)
    print(f"{system.n} beads, grid {system.neighbor.nx}x{system.neighbor.ny}"
          f"x{system.neighbor.nz}, cap {system.neighbor.cell_cap}",
          flush=True)
    sim, fs, wall, rebuilds, launches = drive(system, data, dev,
                                              args.profile)
    # every kernel of the path launches once a production step; rebuilds
    # and LE events launch none
    want = dict.fromkeys(launches, MEASURE)
    want["newton_half_forces"] = 0
    check_run("production", fs, system, wall, rebuilds, launches, MEASURE,
              GRID, want)
    g = GridConsts.build(system, fast_maps(system), dev)
    recs = path_records("100k", dict(
        stencil_forces=stencil_phase(fs, sim, g),
        **kernel_phases(fs, sim, g)), launches)
    del fs, g
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
    want = dict.fromkeys(launches, C6["measure"])
    want["stencil_forces"] = 0
    check_run("config 6", fs, system, wall, rebuilds, launches,
              C6["measure"], C6["grid"], want)
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
    for path, name, r in recs:
        print_kernel(path, name, r)
    full = next(r for _, name, r in recs if name == "newton_half_forces")
    print(f"config 6 stencils, device ms per call ({card}): "
          f"newton_half_forces {full['t'][0]:.4f}, stencil_forces "
          f"{full['t_full'][0]:.4f} ({full['t_full'][2]}; bound "
          f"{full['bound_full'][0]:.4f} by {full['bound_full'][1]}), plain "
          f"newton_half_forces {full['t_plain'][0]:.4f}", flush=True)

    small_end_to_end(dev)
    small_end_to_end(dev, newton_half=True)

    print(json.dumps({"kernels": [
        {"name": name, "path": path, "route": "cuda",
         "source": "lammps_le_torch/csrc/" + (
             "blocked.cu" if name == "newton_half_forces" else "step.cu"),
         "replaces": r["replaces"], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["t"][0],
         "ms_source": r["t"][2], "plain_ms": r["t_plain"][0],
         "plain_ms_source": r["t_plain"][2], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1], "library_ms": None}
        for path, name, r in recs]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
