#!/usr/bin/env python3
"""Smoke run of the lammps_le_torch port on one CUDA card.

Drives the port's main path through its user entry points at bench.py's
production LE configuration (bench.py:398-486): a 100,000-bead serpentine
chromosome on the grid-resident fast engine, thermalized, settled with
500 seeded extruders, then 1,500 measured production steps with
extrusion, ex_load and ex_unload.  Then it holds each hand-written CUDA
kernel against its plain PyTorch version at the shapes that run gave it,
times both, and runs a small system end to end on the card and on the
CPU to compare the two.

    python3 chip_smoke.py

builds the kernels with nvcc on first use.  It exits nonzero, printing no
result, without a CUDA device.  Earlier lines report the card, the
throughput, per-kernel times and one JSON object of kernel records; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# f32 sums of 1e5-1e6 terms taken in another order differ by ~1e-6 of
# their size; energies are held to 2e-2 plus that share
E_ABS, E_REL = 2e-2, 1e-5
F_REL = 3e-5  # forces: 3e-5 * max|f| (tests/test_pallas_step.py:97)

# bench.py's production run: beads, thermalize / settle / warm-up /
# measured steps, seeded extruders
BEADS, THERMALIZE, SETTLE, WARM, MEASURE, N_EX0 = (
    100_000, 300, 100, 40, 1500, 500)
GRID = (9, 33664)  # (cap, P) of the (3, cap, P) planes at that config


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


def le_fixes(extrusion_every=1000, load_every=700, fraction=0.001):
    from lammps_le_torch.fixes import (NVE, ExLoad, ExUnload, Extrusion,
                                       Langevin)

    return (
        NVE(),
        Langevin(t_start=1.0, t_stop=1.0, damp=10.0, seed=904297),
        Extrusion(nevery=extrusion_every, neutral_type=1, ctcf_left=2,
                  ctcf_right=3, through_prob=0.5, btype=2,
                  ctcf_left_right=4),
        ExLoad(nevery=load_every, iatomtype=1, jatomtype=1, cutoff=1.12,
               btype=2, fraction=fraction, seed=684474, imaxbond=1,
               inewtype=1, jmaxbond=1, jnewtype=1),
        ExUnload(nevery=load_every, btype=2, cutoff=0.5, fraction=fraction,
                 seed=456456),
    )


def seed_extruders(state, n_ex, spacing, e_cap):
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
                         flags=zero, step=zero.clone())


def drive(system, data, dev, profile_steps=0):
    """bench.py's thermalize / settle / measure phases on the port.
    Returns (FastState, production Simulation, measured wall s,
    rebuilds and kernel launches in the measured window)."""
    import torch

    from lammps_le_torch import rng
    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import make_fast_segment, run_fast, to_fast
    from lammps_le_torch.fixes import NVE, Langevin
    from lammps_le_torch.integrate import Simulation
    from lammps_le_torch.state import init_state

    n = system.n
    warm = Simulation(system=system, dt=0.006, ex_btype=2, fixes=(
        NVE(), Langevin(t_start=1.0, t_stop=1.0, damp=1.0, seed=7)))
    state = init_state(system, data.x, types=data.types, seed=11,
                       device=dev)
    t0 = time.perf_counter()
    state = run_fast(warm, state, THERMALIZE)
    torch.cuda.synchronize()
    print(f"thermalize {THERMALIZE} steps {time.perf_counter() - t0:.2f} s, "
          f"flags={int(state.flags):#x}", flush=True)

    state = seed_extruders(state, N_EX0, n // N_EX0, system.max_extruders)
    sim = Simulation(system=system, dt=0.006, energy_every=100,
                     fixes=le_fixes(), ex_btype=2)
    settle = Simulation(system=system, dt=0.002, fixes=sim.fixes,
                        ex_btype=2)
    t0 = time.perf_counter()
    state = run_fast(settle, state, SETTLE)
    torch.cuda.synchronize()
    print(f"settle {SETTLE} steps {time.perf_counter() - t0:.2f} s, "
          f"flags={int(state.flags):#x}", flush=True)
    # bench.py's R=1 replica: key folded with replica seed 100
    state = state.replace(
        flags=torch.zeros_like(state.flags),
        key=torch.tensor(rng.fold_in(state.key.tolist(), 100),
                         dtype=torch.int64, device=dev))

    segment = make_fast_segment(sim, dev)
    fs = to_fast(state, sim)
    b0 = fs.step
    bend = b0 + WARM + MEASURE
    segment(fs, b0, WARM, b0, bend)
    torch.cuda.synchronize()
    rebuilds0 = fs.n_rebuilds
    K.reset_launches()
    t0 = time.perf_counter()
    segment(fs, b0 + WARM, MEASURE, b0, bend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    rebuilds = fs.n_rebuilds - rebuilds0
    if profile_steps:
        profile_window(segment, fs, profile_steps, b0, bend)
    return fs, sim, wall, rebuilds, launches


def profile_window(segment, fs, steps, b0, bend):
    """``steps`` more production steps under torch.profiler: device busy
    share of the wall time and the device time of the top kernels."""
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


def timings(fn, reps, warmup=3):
    """(device ms, wall ms) per call of ``fn``.  Device time is the sum of
    the device activities a torch.profiler trace of ``reps`` calls holds;
    wall time is CUDA events around ``reps`` back-to-back calls, which for
    a short kernel is the host's time to issue the call."""
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    if busy_us <= 0:
        fail("the profiler saw no device time")
    return busy_us / reps / 1e3, wall_ms


def kernel_phases(fs, sim, dev):
    """Each kernel vs its plain version on the same card tensors at the
    production shapes.  Returns per-kernel records (no launch counts)."""
    import torch

    from lammps_le_torch.fast import engine
    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import kernels_ref as R

    system = sim.system
    ctx = engine._ctx(sim, dev)
    g, C, S, maps = ctx.g, ctx.C, ctx.S, ctx.maps
    n = system.n
    kick = 0.5 * sim.dt / float(system.masses[0])
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
        t=timings(lambda: K.kick_drift_halo(*kd_args), 50),
        t_plain=timings(lambda: R.kick_drift_halo(*kd_args), 20))

    # stencil_forces: forces 3e-5 max|f|, energies, flags and clamps
    st_args = (fs.gx, fs.bid, fs.hn, fs.pid, g.interior, C, n, maps.strides,
               True)
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
    recs["stencil_forces"] = dict(
        replaces="lammps_le_tpu/fast/pallas_step.py:249", max_abs_err=err,
        tol=f"{F_REL}*max|f|={F_REL * max(fmax, 1.0):.3g}",
        energies=en_k.tolist(), energies_plain=en_r.tolist(),
        t=timings(lambda: K.stencil_forces(*st_args), 20),
        t_plain=timings(lambda: R.stencil_forces(*st_args), 3, 1))

    # extruder_springs (in place on a copy of the stencil forces)
    active = fs.ex_left >= 0
    if not bool(active.any()):
        fail("no active extruder at the end of the production run")
    sp_args = (fs.exl_slot, fs.exr_slot, active, S)
    f_k = gf_r.clone()
    f_r = gf_r.clone()
    eb_k = K.extruder_springs(fs.gx, f_k, *sp_args)
    eb_r = R.extruder_springs(fs.gx, f_r, *sp_args)
    fmax = float(f_r.abs().max())
    err = float((f_k - f_r).abs().max())
    if not err <= F_REL * max(fmax, 1.0):
        fail(f"extruder_springs force error {err} vs max|f| {fmax}")
    ek, er = float(eb_k.double().sum()), float(eb_r.double().sum())
    if not abs(ek - er) <= E_ABS + E_REL * abs(er):
        fail(f"extruder_springs energy {ek} vs {er}")
    scratch = gf_r.clone()
    recs["extruder_springs"] = dict(
        replaces="lammps_le_tpu/fast/pallas_step.py:776", max_abs_err=err,
        tol=f"{F_REL}*max|f|={F_REL * max(fmax, 1.0):.3g}",
        n_active=int(active.sum()),
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
    lm_args = (fs.gx, fs.gx_ref, fs.gv, gf_r, fs.bid, g.interior, key,
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
        t=timings(lambda: K.langevin_kick_monitor(*lm_args), 50),
        t_plain=timings(lambda: R.langevin_kick_monitor(*lm_args), 5))
    return recs


def small_end_to_end(dev, steps=40):
    """A 2,000-bead run with every LE fix on the card (kernels) and on the
    CPU (plain versions): the same events, positions within 1e-3; the CPU
    run launches no kernel, the card run each kernel once a step."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import run_fast
    from lammps_le_torch.fixes import NVE, Langevin
    from lammps_le_torch.integrate import Simulation
    from lammps_le_torch.state import init_state

    data, system = production_config(2000, seed=5)
    warm = Simulation(system=system, dt=0.006, ex_btype=2, fixes=(
        NVE(), Langevin(t_start=1.0, t_stop=1.0, damp=1.0, seed=7)))
    sim = Simulation(system=system, dt=0.005, energy_every=4, ex_btype=2,
                     fixes=le_fixes(5, 7, 0.3))
    out = {}
    for d in ("cpu", dev):
        st = init_state(system, data.x, types=data.types, seed=11, device=d)
        st = run_fast(warm, st, 30)
        st = seed_extruders(st, 20, 100, system.max_extruders)
        K.reset_launches()
        st = run_fast(sim, st, steps)
        out[str(d)] = st, dict(K.LAUNCHES)
    (a, la), (b, lb) = out["cpu"], out[str(dev)]
    dx = float((a.x - b.x.cpu()).abs().max())
    same = (torch.equal(a.ex_left, b.ex_left.cpu())
            and torch.equal(a.ex_right, b.ex_right.cpu())
            and [int(a.n_moves), int(a.n_loads), int(a.n_unloads),
                 int(a.flags)]
            == [int(b.n_moves), int(b.n_loads), int(b.n_unloads),
                int(b.flags)])
    print(f"small end-to-end (2000 beads, {30 + steps} steps): cuda vs cpu "
          f"max|dx| {dx:.3g}, moves {int(b.n_moves)}, loads "
          f"{int(b.n_loads)}, unloads {int(b.n_unloads)}, same events "
          f"{same}, launches cpu {la} cuda {lb}", flush=True)
    if not same or not dx < 1e-3 or int(b.n_moves) == 0:
        fail("small end-to-end run: card and CPU disagree")
    # run_fast's setup evaluates the forces once more (to_fast)
    want = {k: steps + (k in ("stencil_forces", "extruder_springs"))
            for k in lb}
    if any(la.values()) or lb != want:
        fail(f"small end-to-end launches: cpu {la}, cuda {lb} (want {want})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="profile STEPS more production steps")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lammps_le_torch.csrc.build import build
    from lammps_le_torch.fast import thermo_row_fast
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.state import FLAG_FENE_CLAMP

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    lib = build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    data, system = production_config(BEADS)
    print(f"{system.n} beads, grid {system.neighbor.nx}x{system.neighbor.ny}"
          f"x{system.neighbor.nz}, cap {system.neighbor.cell_cap}",
          flush=True)

    fs, sim, wall, rebuilds, launches = drive(system, data, dev,
                                              args.profile)

    row = thermo_row_fast(fs, system)
    temp = float(row.temp)
    flags = int(fs.flags)
    moves = int(fs.n_moves)
    clamps = int(fs.n_clamps)
    n_ex = int((fs.ex_left >= 0).sum())
    sps = MEASURE / wall
    print(f"production {MEASURE} steps in {wall:.3f} s: "
          f"{sps:.2f} steps/s, {sps * system.n:.4g} bead*steps/s; "
          f"rebuilds {rebuilds}; T {temp:.4f}; flags {flags:#x}; "
          f"moves {moves}, loads {int(fs.n_loads)}, unloads "
          f"{int(fs.n_unloads)}, extruders {n_ex}, clamps {clamps}; "
          f"epair {float(fs.epair):.6g} ebond {float(fs.ebond):.6g}",
          flush=True)
    print(f"launches in the {MEASURE} measured steps: {launches}",
          flush=True)
    x_fin = bool(torch.isfinite(fs.gx).all() and torch.isfinite(fs.gv).all())
    if not x_fin or tuple(fs.gx.shape) != (3,) + GRID:
        fail(f"non-finite planes, or of shape {tuple(fs.gx.shape)} (want "
             f"(3,) + {GRID}), after the production run")
    interior = torch.as_tensor(fast_maps(system).interior, device=dev)
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
    # every kernel launches once a production step; rebuilds and LE
    # events launch none
    for name, count in launches.items():
        if count != MEASURE:
            fail(f"kernel {name} launched {count} times in {MEASURE} "
                 f"production steps")

    recs = kernel_phases(fs, sim, dev)
    for name, r in recs.items():
        print(f"kernel {name}: device {r['t'][0]:.4f} ms (plain "
              f"{r['t_plain'][0]:.4f} ms); wall per back-to-back call "
              f"{r['t'][1]:.4f} ms (plain {r['t_plain'][1]:.4f} ms); "
              f"max_abs_err {r['max_abs_err']:.3g} ({r['tol']})",
              flush=True)
    small_end_to_end(dev)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "lammps_le_torch/csrc/step.cu",
         "replaces": r["replaces"], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["t"][0],
         "plain_ms": r["t_plain"][0]}
        for name, r in recs.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
