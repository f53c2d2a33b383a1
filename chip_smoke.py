#!/usr/bin/env python3
"""Smoke run of the lammps_le_torch port on one CUDA card.

The instructions one IEEE reciprocal issues, read from the built
library's SASS, and the card's SM count and clock set the operation
bounds of every kernel.  It drives the fast engine on six paths
through the port's user entry points:

1. bench.py's production LE configuration (bench.py:398-486): a
   100,000-bead serpentine chromosome on the grid-resident fast engine,
   thermalized, settled with 500 seeded extruders, then 1,500 measured
   production steps with extrusion, ex_load and ex_unload, on the full
   27-offset stencil in K2's step loop (``make_fast_segment``'s auto mode:
   launches of up to 16 steps, one launch of one conditional CUDA graph
   and one host read each), then the same window from the same settled
   state on the chain (one host-driven step a launch), which it must
   repeat;
2. config 6 (benchmarks/configs.py:269-362): a 1,000,000-bead chromosome
   past the whole-plane gate, where the engine takes the Newton-half
   stencil, with 5,000 seeded extruders and 600 measured steps, then
   two replicas of its end for 40 steps (``run_fast_replicas``);
3. the 100k configuration's 1,500 measured steps, from the same settled
   state, on the slab-resident state (``shard_fast_state``: each slab's
   columns of every plane on its own device, slab s on cuda:(s % the
   device count), here both on the card) through make_sharded_segment at
   sp=2 (the slab step: K2a, the slab stencil K4, K2c on the gathered
   anchors and the split Langevin pass per slab, the margins, halos and
   fold copied between slabs), held bit for bit to the whole-state chain
   on the same stencil from the same state, with its cross-slab copies,
   bytes and their device time a step;
4. the same on the tiled full stencil (make_pallas_kernel as kernel_fn);
5. the 100k configuration anew with its Langevin fix on the group of
   beads 1-90,000 with ``zero yes`` (the last tenth runs NVE);
6. bench.py's replica sweep (``--sweep``, bench.py:517-583) from path 1's
   settled state: R = 1, 4 and 8 replicas (``run_fast_replicas``' start,
   keys folded with 100 + i) on the replica-batched non-reactive chain,
   rebuild every 4 steps, 40 warm-up and 1,500 measured steps in chunks
   of 250; every replica healthy (one whose flags include a cell
   overflow: healthy through the step before its run alone first
   overflows, where a numpy count of that rebuild's positions must find a
   cell past cap), replica 0 bit for bit the same at every R, each kernel
   one launch a step for all replicas;
10. the multi-card paths, run after path 3: the 100k window
    slab-resident at sp=4 (held bit for bit to the whole-state chain);
    dp=2 x sp=2 on the 100k config for 200 steps
    (``make_replicated_sharded_segment``, two replicas each on its row of
    two slabs), each replica bit for bit the sp=2 segment on it alone;
    and, inside path 7, config 2 with four replicas on the general path
    over a mesh of two devices (``make_replica_runner(mesh=...)``), bit
    for bit the one-card runner.  On a host of several cards the slabs
    spread over them (``multi_card`` runs paths 3 and 10 alone).

After each it holds that path's hand-written CUDA kernels against their
plain PyTorch versions at the shapes the run gave them and times both
(path 6 and config 6's replicas: each chain kernel batched over the R = 8
run's planes, and K3 over two config-6 plane sets, also against its
one-run launches on each replica, bit for bit, and timed against them;
one record per path and kernel, K2's step loop against its plain loop
among them, with its launch stopped by the trigger against the launch
of its steps and its graph's nodes a step; paths 3, 4 and 5 record their stencil or their Langevin
kernel, the other kernels having run at path 1's shapes),
and the stencils of paths 3 and 4 against the full stencil on the same
planes; it repeats paths 3 and 4 with every stencil call held against
another stencil on the planes of that call (``witness``); after config 6
it runs copies of its state on past the window on both stencils,
printing flags and the fullest cell.  Then it runs the two microprobes
(lammps_le_torch/probes) through their entry points at the TPU probes'
shapes: P1, the IEEE reciprocal against ``rcp.approx`` in a
division-bound chain and the latter's error, and P2, an f32 elementwise
chain against packed bf16, each kernel held against its plain version.
Then it runs a small system end to end on the card and on the CPU, on
the full and Newton-half stencils, to compare the two.  Last, path 7,
the general path (``integrate.run``: velocity-Verlet with every fix
option, plain PyTorch, no kernel of its own): benchmarks/configs.py's
configs 1 (the generated 32k FENE melt, rebuild every 4), 2 (1k chain +
extrusion), 3 (10k turnover) and 5 (the 100k chromosome, cap 14, a
rebuild every step, all three LE fixes) built as configs.py builds them,
configs 1-3 at their --quick lengths and config 5 at its full ones, each
held healthy (config 5's extruders heat it past T 2: its T is held to
the fast engine's from the same warm state; config 1 starts from
overlapping random walks: held finite); config 2's 40 steps from its
warm state twice on the card (bit for bit) and on the CPU (integer
fields bit for bit, positions within 1e-3); config 5's profile (device
busy share, top kernels and operations) and host syncs a step, which
must be 0.  After path 1 it holds the general path's ``setup`` on path
1's settled state against the fast engine's forces.  Then path 8, the
deck front end (``deck/``, ``python -m lammps_le_torch``): config 4
(configs.py:199-249, the README's deck: 10,000 beads, f32) through
``DeckRunner`` on the card, ``run 300`` and the measured ``run 2000``,
which must take K2's step loop, launch each of its kernels once a step
and end healthy, then K1, K2a, K2c and K2d+e on its final planes against
their plain versions (the ``config4`` records); the CLI in a subprocess
on the 300-bead deck of tests/test_deck.py (exit 0, its log, dump and
data file); that deck resumed from its checkpoint at step 40, bit for
bit the uninterrupted run; that deck on the general path (``LLE_FAST=0``)
in f64 on the card and on the CPU (integer fields equal); and
``minimize`` decks (fire, cg) in f64 with the CPU's iteration counts.
Last, path 9, the observers and the native LAMMPS restart (``observe/``,
``io/lammps_restart``): config 4's deck with ``compute pe/atom``,
``stress/atom``, ``coord/atom`` (through ``dump custom`` and ``compute
reduce``), ``rdf`` past the cell size (through ``fix ave/time`` in vector
mode), ``group/group`` and ``pair/local`` (through ``dump local``) every
500 steps of the measured ``run 2000`` in K2's step loop; each observer
on its final state held against a CPU copy (integer outputs bit for bit)
and timed, ``contact_map_accumulate`` and ``profile()``, and a native
``write_restart`` read back by a fresh runner bit for bit; then the
300-bead deck with the same observers in f64 against a CPU copy within
1e-10, and its restart.  The probes also time P1's float4 ``rcp``
against its first form (one element a thread) in turns, and its launch
floor.

    python3 chip_smoke.py [--profile STEPS] [--overrun STEPS]

(``--profile`` also counts the host syncs a step of STEPS more steps).

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
# 32-bit integer add, shift and bitwise operations a clock per SM (the
# same table, compute capability 9.0): the rate of threefry's rounds
INT_LANES_SM = 64
RATES = {}  # f32, int32 and mufu operations/s, the reciprocal's price
# integer operations of one threefry2x32 word (csrc/step.cu threefry_x0):
# 20 rounds of an add, a rotation (one funnel shift) and a xor, 5 key
# injections of two adds and the round constant, the counter and key adds
THREEFRY_OPS = 20 * 3 + 5 * 3 + 2
# f32 operations of one slot pair within the LJ cut or bonded (an acting
# pair, ``pair_counts``): 3 differences, 5 for r^2, 1 division, 2 for
# r^6, 4 for the force factor, 6 to scale and add the force; the
# Newton-half stencil adds 3 for the reaction.  Any other occupied pair
# needs only its distance: DIST_OPS, the 3 differences and 5 for r^2.
# Comparisons and the other terms of the few pairs in bond or energy
# range are not counted; their FENE division and logf are
# (``bonded_terms``).
PAIR_OPS = {"stencil_forces": 21, "newton_half_forces": 24,
            "tiled_stencil_forces": 21, "window_forces": 24}
DIST_OPS = 8
# instructions of the stencils' approximate reciprocal (stencil_rcp in
# csrc/common.cuh): one MUFU.RCP and its Newton step's FMUL, FADD, FMUL
# (-fmad=false)
APPROX_RCP_OPS = 4
SP_PATH, SP_PHASES = 2, (2, 4)  # slabs of path 3; of its kernel phase
# path 10: the slabs of its wide window; its dp x sp run's replicas (one a
# row of SP_PATH slabs) and steps; the general path's replicas over a
# mesh of GEN_MESH devices and their steps; path 5's slab-resident window
# with zero (the split Langevin pass's sums); steps whose cross-slab
# traffic is profiled; positions of the zero window against the whole
# state (bead layout: the group means' sums differ in order)
SP_WIDE, DP_REPLICAS, DP_STEPS = 4, 2, 200
GEN_REPLICAS, GEN_MESH, GEN_REPLICA_STEPS = 4, 2, 40
ZERO_SLAB_STEPS, TRAFFIC_STEPS, ZERO_X_TOL = 40, 20, 1e-4
# the source of each kernel not in step.cu
SOURCES = {"newton_half_forces": "blocked.cu", "window_forces": "blocked.cu",
           "tiled_stencil_forces": "tiled.cu", "rcp_chain": "probes.cu",
           "rcp": "probes.cu", "elementwise_chain": "probes.cu"}
# path 5: the thermostat's group, beads 1-90,000 of 100,000 (group chain
# id 1:90000); the last tenth of the chromosome runs NVE
N_CHAIN = 90_000
# path 6, bench.py's --sweep (bench.py:517-583): replica counts, the
# static rebuild cadence, measured steps a chunk, the replica keys' first
# seed; steps whose host syncs are counted; config 6's replicas and steps
SWEEP, SWEEP_EVERY, SWEEP_CHUNK, SWEEP_SEED = (1, 4, 8), 4, 250, 100
SYNC_STEPS = 50
C6_REPLICAS, C6_REPLICA_STEPS = 2, 40
# what replica 0 of path 6 must end with bit for bit at every R
REPLICA_WITNESS = ("gx", "gv", "gf", "gx_ref", "bid", "hn", "pid", "slot_of",
                   "exl_slot", "exr_slot", "ex_left", "ex_right", "types",
                   "img", "flags", "epair", "ebond", "n_moves", "n_loads",
                   "n_unloads", "n_clamps", "last_event")
# path 7, the general path (integrate.run): benchmarks/configs.py's
# configs 1, 2, 3 and 5 (configs.py:86-197, 252-266) as its _chain_system
# and _extrusion_run build them; configs 1-3 at their --quick measured
# lengths, config 5 at its full ones.  Fields: beads (chains x length for
# the generated melt), the Simulation's dt and extra fixes, rebuild
# cadence, cell cap, seeded extruders, thermalize / warm / measured steps.
GENERAL = {
    1: dict(name="1_chain32k_generated", chains=320, length=100, dt=0.012,
            rebuild_every=4, thermalize=0, warm=50, measure=200, n_ex=0),
    2: dict(name="2_1k_extrusion_only", chains=1, length=1000, dt=0.006,
            rebuild_every=1, thermalize=300, warm=50, measure=300, n_ex=10),
    3: dict(name="3_10k_turnover", chains=1, length=10_000, dt=0.006,
            rebuild_every=1, thermalize=300, warm=50, measure=300,
            n_ex=100),
    5: dict(name="5_mach2022_100k", chains=1, length=100_000, dt=0.006,
            rebuild_every=1, cell_cap=14, thermalize=300, warm=50,
            measure=2000, n_ex=500),
}
# config 2's card checks: steps from the warm state (an extrusion event at
# its first, step 351); f32 positions card against CPU
GEN_CHECK_STEPS, GEN_X_TOL = 40, 1e-3
# config 5's profiled steps (at least; --profile raises it)
GEN_PROFILE_STEPS = 20
# path 8, the deck front end: config 4 (configs.py:199-249, README.md:22-40)
# at its full lengths, a run of 300 steps then the measured 2,000; the
# 300-bead deck of tests/test_deck.py:11-36 (the CLI, restart and card vs
# CPU phases; f64 positions card against CPU after its 60 steps); the
# minimize decks on its data jittered by 0.1 (fire to max|F| < 0.1, cg to
# the energy tolerance 1e-6), f64
C4 = dict(beads=10_000, measure=2000)
# the contract phase: config 5's steps through the positional run
CONTRACT_STEPS = 12
CONFIG4_DECK = """
units lj
atom_style bond
special_bonds fene
read_data data.le
neighbor 0.4 bin
bond_style hybrid
bond_coeff 1 fene 30.0 1.5 1.0 1.0
bond_coeff 2 harmonic 10.0 1.1
pair_style lj/cut 1.12
pair_modify shift yes
pair_coeff * * 1.0 1.0 1.12
velocity all create 1.0 87287
fix 1 all nve
fix 2 all langevin 1.0 1.0 10.0 904297
fix loop all extrusion 175 1 2 3 0.5 2 4
fix loading all ex_load 70 1 1 1.12 2 prob 0.001 684474 iparam 1 1 jparam 1 1
fix unloading all ex_unload 70 2 0.5 prob 0.001 456456
thermo 2000
timestep 0.006
run 300
"""
TINY_DECK = """
units lj
atom_style bond
special_bonds fene
read_data data.tiny
neighbor 0.3 bin
bond_style hybrid
bond_coeff 1 fene 30.0 1.5 1.0 1.0
bond_coeff 2 harmonic 10.0 1.1
pair_style lj/cut 1.12
pair_modify shift yes
pair_coeff * * 1.0 1.0 1.12
velocity all create 1.0 87287
fix 1 all nve
fix 2 all langevin 1.0 1.0 10.0 904297
fix loop all extrusion 10 1 2 3 0.5 2 4
fix loading all ex_load 10 1 1 1.12 2 prob 0.5 684474 iparam 1 1 jparam 1 1
fix unloading all ex_unload 10 2 0.5 prob 0.1 456456
thermo 20
timestep 0.005
run 40
write_data out.data
write_restart out.ckpt.npz
run 20
"""
DECK_X_TOL = 1e-6
MIN_DECK = """
units lj
atom_style bond
special_bonds fene
read_data min.data
neighbor 0.3 bin
bond_style hybrid
bond_coeff 1 fene 30.0 1.5 1.0 1.0
bond_coeff 2 harmonic 10.0 1.1
pair_style lj/cut 1.12
pair_modify shift yes
pair_coeff * * 1.0 1.0 1.12
timestep 0.005
"""
MIN_RUNS = (("fire", "0.0 0.1 1000 5000"), ("cg", "1e-6 1e-3 300 3000"))
# path 9, the observers and the native restart on config 4's deck: the
# computes and dumps every 500 steps of the measured run 2000; rdf past
# the cell size (the dedicated wide grid); each observer on the card held
# against the same observer on a CPU copy of the state: integer outputs
# bit for bit, f32 floats within OBS_F32_REL x max(1, max|value|) (sums
# of up to ~30 pair terms taken in another order; on the H100 the gap
# was 2.0e-7 of the largest pe/atom and 9.2e-8 of the largest
# stress/atom), the 300-bead deck's in f64 within OBS_F64_REL
OBS_CMDS = """
group left id 1:{half}
group right id {half1}:{n}
compute pea all pe/atom
compute str all stress/atom NULL
compute co all coord/atom cutoff {coord}
compute petot all reduce sum c_pea
compute comax all reduce max c_co
compute gr all rdf 50 cutoff 2.5
compute gg left group/group right
compute pl all pair/local dist eng force
fix avr all ave/time {every} 1 {every} c_gr[*] mode vector file rdf.ave
dump dc all custom {every} atoms.dump id c_pea c_co c_str[1] c_str[2] c_str[3]
dump dl all local {every} pairs.dump c_pl[1] c_pl[2] c_pl[3]
thermo_style custom step temp epair press c_petot c_comax c_gg
thermo {every}
"""
OBS_EVERY = 500
OBS_F32_REL, OBS_F64_REL = 1e-5, 1e-10
# the TPU kernel each chain kernel replaces (its records, one-run and batched)
REPLACES = {
    "kick_drift_halo": "lammps_le_tpu/fast/pallas_step.py:731",
    "stencil_forces": "lammps_le_tpu/fast/pallas_step.py:249",
    "extruder_springs": "lammps_le_tpu/fast/pallas_step.py:776",
    "langevin_kick_monitor": "lammps_le_tpu/fast/pallas_step.py:932",
    "langevin_kick_parts": "lammps_le_tpu/fast/pallas_step.py:932",
    "langevin_sums": "lammps_le_tpu/fast/pallas_step.py:932",
    "newton_half_forces": "lammps_le_tpu/fast/blocked_kernel.py:90"}


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
    system, data = general_system(1, C6["beads"], skin=0.5, rebuild_every=40,
                                  max_extruders=8192, cell_cap=9)
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
    state, _ = run_fast(sim, state, steps, groups=groups)
    torch.cuda.synchronize()
    print(f"{label} {steps} steps {time.perf_counter() - t0:.2f} s, "
          f"flags={int(state.flags):#x}", flush=True)
    return state


def measured_segment(sim, state, dev, warm, measure, profile_steps,
                     kernel_fn=None, segment=None, groups=None, pallas=None,
                     mesh=None):
    """``warm`` steps, then ``measure`` timed steps with the launch counts
    zeroed just before them and read just after, on ``segment`` (default
    ``make_fast_segment`` on ``kernel_fn`` with ``pallas``: auto, the
    step loop within the whole-plane gate); ``groups`` as to_fast's; with
    ``mesh`` the state slab-resident on its devices (``shard_fast_state``).
    Returns (the FastState or ShardedFastState, measured wall s,
    rebuilds, kernel launches and step-loop launches in the window)."""
    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import make_fast_segment, to_fast
    from lammps_le_torch.parallel.spatial import shard_fast_state

    segment = segment or make_fast_segment(
        sim, pallas=pallas, kernel_fn=kernel_fn, device=dev)[0]
    fs = to_fast(state, sim, groups, kernel_fn=kernel_fn)
    if mesh is not None:
        fs = shard_fast_state(fs, mesh)
    b0 = fs.step
    bend = b0 + warm + measure
    segment(fs, b0, warm, b0, bend)
    sync_all()
    rebuilds0, loops0 = fs.n_rebuilds, fs.n_launches
    K.reset_launches()
    t0 = time.perf_counter()
    segment(fs, b0 + warm, measure, b0, bend)
    sync_all()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    rebuilds = fs.n_rebuilds - rebuilds0
    loops = fs.n_launches - loops0
    if profile_steps:
        # on copies: a step reassigns the state's fields, so the profiled
        # steps leave the measured state as it was for the checks
        dev_ms = profile_window(segment, dataclasses.replace(fs), sim.system,
                                profile_steps, b0, bend)
        # the profiler's own host time slows a host-bound run: the busy
        # share at the unprofiled rate is device time a step x steps/s
        print(f"device busy at the measured rate: {dev_ms:.4f} ms a step "
              f"x {measure / wall:.2f} steps/s = "
              f"{100 * dev_ms * measure / wall / 1e3:.1f}%", flush=True)
        count_syncs(segment, dataclasses.replace(fs), profile_steps, b0,
                    bend)
    return fs, wall, rebuilds, launches, loops


def bench_replica(state, i):
    """bench.py's replica ``i`` of a settled State: its key folded with
    SWEEP_SEED + i (bench.py:551-556)."""
    import torch

    from lammps_le_torch import rng

    return state.replace(key=torch.tensor(
        rng.fold_in(state.key.tolist(), SWEEP_SEED + i), dtype=torch.int64,
        device=state.key.device))


def drive(system, data, dev, groups=None, replica=0):
    """bench.py's thermalize / settle phases on the port.  Returns the
    production Simulation and the settled State that its measured phase
    starts from: bench.py's replica ``replica`` (its R = 1 run's, 0), or
    with ``replica`` None the settled State itself.  With ``groups``
    (path 5) the production Langevin fix thermostats the group ``chain``
    with ``zero yes``."""
    import torch

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
    state = state.replace(flags=torch.zeros_like(state.flags))
    return sim, state if replica is None else bench_replica(state, replica)


def settle_config6(data, system, dev):
    """configs.py:300-331 up to its measured phase: thermalize 400 steps
    (NVE + Langevin damp 1, dt 0.006, init seed 19), zero the flags, seed
    5,000 extruders 200 beads apart, settle 200 steps at dt 0.002 with
    the production fixes (extrusion with release_r 3), zero the flags.
    Returns (the production Simulation, the settled State)."""
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
    return sim, state.replace(flags=torch.zeros_like(state.flags))


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
                 int32=INT_LANES_SM * sms * mhz * 1e6,
                 mufu=MUFU_LANES_SM * sms * mhz * 1e6, div=price)
    print(f"bound rates ({card}): {sms} SMs at {mhz:.0f} MHz: f32 "
          f"{RATES['f32']:.4g} operations/s ({LANES_SM} lanes a clock per "
          f"SM; no FMA under -fmad=false), int32 {RATES['int32']:.4g}/s "
          f"({INT_LANES_SM} lanes), MUFU "
          f"{RATES['mufu']:.4g}/s; an IEEE reciprocal issues {price} "
          f"instructions on its fast path (SASS of the one-pass kernels: "
          f"exact {' '.join(exact)} | approximate {' '.join(approx)})",
          flush=True)


def bound(nbytes, ops, divs=0, mufu=0, approx=False, int_ops=0):
    """(ms, what bounds it): the least time an H100 SXM takes to move
    ``nbytes`` or to issue ``ops`` f32 operations, ``divs`` reciprocals
    and ``mufu`` further MUFU operations, or ``int_ops`` 32-bit integer
    operations, whichever is longest.  Each reciprocal issues
    RATES["div"] instructions (IEEE) or APPROX_RCP_OPS (``approx``: the
    stencils' approximate one), one of them on the MUFU pipe."""
    price = APPROX_RCP_OPS if approx else RATES["div"]
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = max((ops + divs * price) / RATES["f32"],
                (divs + mufu) / RATES["mufu"],
                int_ops / RATES["int32"] if int_ops else 0.0) * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


def bonded_terms(bid, hn, own, n, newton, energy, tiled=False):
    """(IEEE divisions, MUFU operations) of the bonded pairs a stencil call
    on these planes computes besides every pair's reciprocal: the FENE
    force's ``neg_kf / rlog`` (csrc/common.cuh pair_force, tiled_pair) for
    each bond within reach, seen from both of its beads by the full
    stencils and once by the Newton-half ones, with ``tiled`` (K5's
    formulas) also its ``rsq / r0^2`` and ``sigma^2 / rsq_w``, and with
    ``energy`` its ``logf`` (charged as one MUFU operation, its least
    cost)."""
    from lammps_le_torch.fast import kernels_ref as R

    links = int((R.valid_mask(bid, own, n) & hn).sum())
    pairs = links if newton else 2 * links
    return pairs * (3 if tiled else 1), pairs if energy else 0


def langevin_bound(bid, interior, n, lgm=None, zero=False):
    """langevin_kick_monitor's bound on these planes: x, x_ref, v, f and
    bid in and f, v out per slot, the interior mask, and with a group its
    plane; ~46 f32 operations a slot, 6 more with ``zero`` (the weight
    and the mean); threefry's integer work, THREEFRY_OPS a word, three
    words for each slot of nonzero weight (valid, and in the group where
    ``lgm`` is given), drawn once: what the function needs, however often
    a kernel draws them."""
    from lammps_le_torch.fast import kernels_ref as R

    cap, P = bid.shape
    w = R.valid_mask(bid, interior, n)
    if lgm is not None:
        w = w & (lgm != 0)
    words = 3 * int(w.sum())
    return bound(cap * P * (48 + 4 + 24 + (0 if lgm is None else 4)) + P,
                 cap * P * (52 if zero else 46),
                 int_ops=words * THREEFRY_OPS)


def pair_counts(x, bid, hn, own, n, cutsq, offsets, deltas):
    """{offset: (pairs, acting)} on these planes: at each offset, each
    valid i slot (a bead in an ``own`` column c) against the occupied j
    rows of column c + delta (``deltas``: {offset: a function rolling a
    plane's columns by delta}; in the self cell the other occupied rows),
    and of those pairs the acting ones: within the cut (r^2 in f32, as
    the kernels compute it) or bonded (either is the other's chain
    neighbour)."""
    import torch

    from lammps_le_torch.fast import kernels_ref as R

    valid = R.valid_mask(bid, own, n)
    u1 = torch.where(hn, bid + 1, n + 2)
    eye = torch.eye(bid.shape[0], dtype=torch.bool, device=bid.device)
    out = {}
    for o in offsets:
        roll = deltas[o]
        bj, u1j = roll(bid), roll(u1)
        mask = valid[:, None, :] & (bj < n)[None, :, :]
        if o == (0, 0, 0):
            mask &= ~eye[:, :, None]
        rsq = 0
        for k in range(3):
            d = x[k][:, None, :] - roll(x[k])[None, :, :]
            rsq = rsq + d * d
        bonded = (bj[None] == u1[:, None]) | (bid[:, None] == u1j[None])
        out[o] = (int(mask.sum()),
                  int((mask & ((rsq < cutsq) | bonded)).sum()))
    return out


def pair_ops(name, counts):
    """(f32 operations, reciprocals) of the pairs ``counts``
    (``pair_counts``) in stencil ``name``'s function: each acting pair
    PAIR_OPS - 1 (the self cell at the full stencil's price: it computes
    no reaction) and its reciprocal, every other pair DIST_OPS."""
    ops = divs = 0
    for o, (k, act) in counts.items():
        price = PAIR_OPS["stencil_forces" if o == (0, 0, 0) else name]
        ops += act * (price - 1) + (k - act) * DIST_OPS
        divs += act
    pairs = sum(k for k, _ in counts.values())
    print(f"{name} bound: {pairs} occupied slot pairs, {divs} of them "
          f"within the cut or bonded", flush=True)
    return ops, divs


def stencil_bound(name, fs, g, maps, C, n, energy=True):
    """The stencils' bound on this run's planes: planes in (x, bid,
    has-next, partner, interior and, for the Newton-half stencil, the six
    face masks) and forces out once; operations for the pairs the data
    holds (``pair_counts`` over the 27 offsets or the self cell and the
    13 forward ones, priced by ``pair_ops``) and the bonded pairs' terms
    (``bonded_terms``).  Empty j slots need only the bead-id compare,
    which is not counted.  The reciprocals are priced in the form the
    kernel takes (kernels.APPROX_RCP; the tiled stencil always divides
    exactly)."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import kernels_ref as R
    from lammps_le_torch.ops.grid import _OFFSETS

    cap, P = maps.cap, maps.P
    sx, sy, sz = maps.strides
    newton = name == "newton_half_forces"
    offsets = R.HALF_OFFSETS if newton else _OFFSETS
    deltas = {(a, b, c): (lambda t, d=a * sx + b * sy + c * sz:
                          torch.roll(t, -d, -1)) for (a, b, c) in offsets}
    ops, divs = pair_ops(name, pair_counts(fs.gx, fs.bid, fs.hn,
                                           g.interior, n, C.cutsq, offsets,
                                           deltas))
    nbytes = cap * P * (12 + 4 + 1 + 4 + 12) + P * (1 + 6 * newton)
    tiled = name == "tiled_stencil_forces"
    bdivs, bmufu = bonded_terms(fs.bid, fs.hn, g.interior, n, newton, energy,
                                tiled)
    return bound(nbytes, ops, divs=divs + bdivs, mufu=bmufu,
                 approx=K.APPROX_RCP and not tiled)


def window_bound(wargs, n, energy=True):
    """window_forces' bound on these windows (its ``args``): the window
    planes (the margins' copies included) in and the window forces and
    tallies out once; operations for the pairs the windows hold, counted
    as ``stencil_bound`` counts the Newton-half stencil's, each window
    rolled on itself, with the bonded terms of the own slots' links."""
    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import kernels_ref as R

    xw, bidw, hnw, pidw, own, C = wargs[:6]
    period, (sx, sy, sz) = wargs[7], wargs[8]
    cap, Q = bidw.shape

    def roll(t, d):
        return t.reshape(*t.shape[:-1], -1, period).roll(-d, -1).reshape(
            t.shape)

    deltas = {(a, b, c): (lambda t, d=a * sx + b * sy + c * sz: roll(t, d))
              for (a, b, c) in R.HALF_OFFSETS}
    ops, divs = pair_ops("window_forces", pair_counts(
        xw, bidw, hnw, own, n, C.cutsq, R.HALF_OFFSETS, deltas))
    bdivs, bmufu = bonded_terms(bidw, hnw, own, n, True, energy)
    return bound(cap * Q * (12 + 4 + 1 + 4 + 12) + Q + 5 * 4, ops,
                 divs=divs + bdivs, mufu=bmufu, approx=K.APPROX_RCP)


def max_cell_count(fs, system):
    """The most beads one cell would hold at a rebuild now (binned from
    the beads' positions, not the planes, whose cells hold at most cap)."""
    import torch

    from lammps_le_torch.fast.engine import extract_beads
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.ops.cells import cell_coords, wrap_positions
    from lammps_le_torch.parallel.spatial import (ShardedFastState,
                                                  gather_fast_state)

    if isinstance(fs, ShardedFastState):
        fs = gather_fast_state(fs)
    if fs.replicas:
        from lammps_le_torch.fast import replica

        return max(max_cell_count(replica(fs, r), system)
                   for r in range(fs.replicas))
    x, _ = wrap_positions(extract_beads(fs, fast_maps(system))[0], system,
                          fs.img)
    c3 = cell_coords(x, system)
    nb = system.neighbor
    col = (c3[:, 0] * nb.ny + c3[:, 1]) * nb.nz + c3[:, 2]
    return int(torch.bincount(col).max())


def profile_window(segment, fs, system, steps, b0, bend):
    """``steps`` more production steps under torch.profiler: device busy
    share of the wall time and the device time of the top kernels; then
    the copy's flags and fullest cell.  Returns the device ms a step."""
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
    print(f"profile ({card_line()}): {steps} steps in {wall * 1e3:.1f} ms "
          f"under the profiler, device busy {busy_us / 1e3:.1f} ms "
          f"({100 * busy_us / 1e6 / wall:.1f}%)", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:16]:
        print(f"  {e.self_device_time_total / steps:9.2f} us/step  "
              f"{e.count:6d}x  {e.key[:70]}", flush=True)
    flags = fs.flags.tolist()  # a list of each replica's
    print(f"profile: the profiled copy ends at step {fs.step} with flags "
          f"{[hex(f) for f in flags] if fs.replicas else hex(flags)}, at "
          f"most {max_cell_count(fs, system)} beads in a cell", flush=True)
    return busy_us / steps / 1e3


def count_syncs(segment, fs, steps, b0, bend):
    """``steps`` more steps with PyTorch's sync debug mode warning at every
    operation that waits for the card: the host syncs a step, printed with
    where the first happened."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            segment(fs, fs.step, steps, b0, bend)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    where = sorted({f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
                    for w in caught})
    print(f"host syncs ({card_line()}): {len(caught)} in {steps} steps, "
          f"{len(caught) / steps:.4f} a step ({fs.n_launches} step-loop "
          f"launches in the copy's run so far); at {where}", flush=True)
    return len(caught) / steps


def timings(fn, reps, warmup=3):
    """(device ms, wall ms, source of the device ms) per call of ``fn``.
    Device time is the sum of the device activities a torch.profiler trace
    of ``reps`` calls holds (source "profiler").  The profiler now and then
    records no device activity at all, or an activity too few or too many:
    each kernel's mean time then counts as often a call as the trace
    holds it to the nearest whole number (source "profiler, normalised",
    the counts printed; a trace that holds fewer than half of every
    kernel's records counts as empty).  After four empty traces it is the
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
            if busy_us > 0:
                return busy_us / 1e3, wall_ms, "profiler, normalised"
            # fewer than half of each kernel's records: trace again
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


def kick_drift_bound(cap, P, images, R=1):
    """K2a's bound on R replicas' (3, cap, P) planes with the image map
    ``images`` (``place.ImageTensors``): v, f and bid in and v and x out
    at every slot, x in at the slots that write their own, x out at each
    sent image, the interior and own masks and the image map once; 18
    f32 operations a slot and 3 an image's row."""
    own = int(images.own.sum())
    I = int(images.idx.shape[0])
    per = cap * P * (24 + 4 + 24) + cap * own * 12 + cap * images.n_send * 12
    return bound(R * per + 2 * P + 4 * (P + 1) + 20 * I,
                 R * cap * (18 * P + 3 * I))


def kick_drift_phase(args, images, what):
    """kick_drift_halo (K2a) on ``args`` (the plain version's arguments)
    with the image map ``images`` against its plain version, bit for bit
    (planes and any send buffer), then timed beside its plain version and
    its launch floor: an empty kernel at its launch shape
    (``kernels.kick_drift_floor``).  Returns its record (no launch
    count)."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import kernels_ref as R

    got = K.kick_drift_halo(*args, images)
    want = R.kick_drift_halo(*args, images)
    if len(got) != len(want) or not all(
            torch.equal(a, b) for a, b in zip(got, want)):
        fail(f"kick_drift_halo ({what}) differs from its plain version")
    gx = args[0]
    cap, P = gx.shape[-2:]
    reps = gx.shape[0] if gx.dim() == 4 else 1
    shape = K.kick_drift_shape(cap, P, reps)
    rec = dict(
        replaces=REPLACES["kick_drift_halo"], max_abs_err=0.0,
        tol="bitwise", bound=kick_drift_bound(cap, P, images, reps),
        t=timings(lambda: K.kick_drift_halo(*args, images), 50),
        t_plain=timings(lambda: R.kick_drift_halo(*args, images), 20),
        t_floor=timings(lambda: K.kick_drift_floor(cap, P, reps), 50))
    print(f"kick_drift_halo {what} ({card_line()}): planes "
          f"{tuple(gx.shape)}, {int(images.idx.shape[0])} images "
          f"({images.n_send} sent); one launch of {shape[0]} x {shape[2]} "
          f"blocks of {shape[1]} threads; bitwise "
          f"its plain version; device {rec['t'][0]:.4f} ms ({rec['t'][2]}), "
          f"launch floor {rec['t_floor'][0]:.4f} ({rec['t_floor'][2]}), "
          f"bound {rec['bound'][0]:.4f} by {rec['bound'][1]}; plain "
          f"{rec['t_plain'][0]:.4f}", flush=True)
    return rec


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

    system = sim.system
    S = SpringConsts(system, sim.ex_btype)
    n = system.n
    kick = 0.5 * sim.dt / float(system.masses[0])
    recs = {}

    # kick_drift_halo: bitwise
    recs["kick_drift_halo"] = kick_drift_phase(
        (fs.gx, fs.gv, fs.gf, fs.bid, g.interior, g.halo_cols, g.halo_src,
         g.halo_shift, n, kick, sim.dt), g.images, f"{system.n} beads")

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
        replaces=REPLACES["extruder_springs"], max_abs_err=err,
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
        replaces=REPLACES["langevin_kick_monitor"], max_abs_err=err,
        tol="noise bitwise; f, v 3e-5*max|f|",
        bound=langevin_bound(fs.bid, g.interior, n),
        t=timings(lambda: K.langevin_kick_monitor(*lm_args), 50),
        t_plain=timings(lambda: R.langevin_kick_monitor(*lm_args), 5))
    return recs


def loop_line(label, loops, wall, segment=None):
    """Print a step-loop window's launches a step and steps a launch (the
    chain's: one host-driven step a launch), and with ``segment`` its
    graph (one conditional graph; its kernels allocate nothing) and its
    static planes."""
    import torch

    extra = ""
    if segment is not None:
        loop = segment.loop
        kern, nodes = loop.body_nodes()
        extra = (f"; one conditional graph, its body {kern} kernel nodes of "
                 f"{nodes}; static planes and buffers {loop.nbytes()} B; "
                 f"device memory allocated "
                 f"{torch.cuda.memory_allocated()} B, reserved "
                 f"{torch.cuda.memory_reserved()} B")
    print(f"{label}: {loops} step-loop launches in {MEASURE} steps, "
          f"{loops / MEASURE:.4f} a step, {MEASURE / max(loops, 1):.2f} "
          f"steps a launch; {MEASURE / wall:.2f} steps/s ({card_line()})"
          + extra, flush=True)


def chain_witness(fs, fs_c, system, rebuilds, rebuilds_c, wall, wall_c,
                  loops):
    """Path 1 in K2's step loop (``fs``) against the chain from the same
    settled state (``fs_c``): equal extruder tables, types, LE counters,
    last events, flags, clamps, step and rebuild schedule, and bead
    positions within 1e-6 (bitwise expected: the same kernels on the same
    planes in the same order).  Prints both runs' rates."""
    import torch

    same = {
        "tables": torch.equal(fs.ex_left, fs_c.ex_left)
        and torch.equal(fs.ex_right, fs_c.ex_right)
        and torch.equal(fs.types, fs_c.types),
        "counters": [int(fs.n_moves), int(fs.n_loads), int(fs.n_unloads),
                     fs.last_event.tolist(), int(fs.n_clamps)]
        == [int(fs_c.n_moves), int(fs_c.n_loads), int(fs_c.n_unloads),
            fs_c.last_event.tolist(), int(fs_c.n_clamps)],
        "flags": int(fs.flags) == int(fs_c.flags),
        "step": fs.step == fs_c.step,
        "rebuilds": (fs.n_rebuilds, rebuilds) == (fs_c.n_rebuilds,
                                                  rebuilds_c)}
    dx = float((bead_positions(fs, system)
                - bead_positions(fs_c, system)).abs().max())
    bitwise = all(torch.equal(getattr(fs, k), getattr(fs_c, k))
                  for k in ("gx", "gv", "gf"))
    print(f"path 1 witness ({card_line()}): step loop {MEASURE / wall:.2f} "
          f"steps/s, {loops} launches ({loops / MEASURE:.4f} a step); "
          f"chain {MEASURE / wall_c:.2f} steps/s, {MEASURE} launches (1 a "
          f"step); rebuilds {rebuilds} vs {rebuilds_c}; max|dx| {dx:.3g} "
          f"(tol 1e-6); planes bitwise {bitwise}; equal {same}", flush=True)
    if not all(same.values()) or not dx <= 1e-6:
        fail(f"the step loop and the chain differ on path 1: {same}, "
             f"max|dx| {dx}")


def loop_launch_ms(loop, planes, head, limit, reps=20):
    """Device ms of one launch of the step loop ``loop`` (its control
    kernel and its graph, ``loop.launch(*head, limit)``) from the (gx, gv,
    gf) ``planes`` each time: the planes copied into the loop's static
    planes before each launch, outside its pair of CUDA events, every
    launch queued behind a sleep kernel so that the events see device
    time only.  The loop's other planes are those its last call staged;
    its next call stages gx, gv and gf anew."""
    import torch

    def restore():
        for k, t in zip(("gx", "gv", "gf"), planes):
            loop.buf[k].copy_(t)

    for _ in range(2):
        restore()
        loop.launch(*head, limit)
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    # ~20 ms, past the host's time to queue the launches
    torch.cuda._sleep(40_000_000)
    for a, b in pairs:
        restore()
        a.record()
        loop.launch(*head, limit)
        b.record()
    torch.cuda.synchronize()
    for k in ("gx", "gv", "gf"):
        loop.held.pop(k, None)
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def step_loop_phase(fs, sim, g, phases):
    """K2's step loop (``make_step_kernel``) on the card against its plain
    loop on the planes of the run that left ``fs``, as if just rebuilt
    (gx_ref = gx): one step (x bitwise, f and v within 3e-5 max|f|, the
    stats rows 2-7 equal) and a whole launch of LAUNCH_MAX steps (stats
    rows 2-7 equal, x within 1e-3).  That launch must stop at the trigger
    after d < LAUNCH_MAX steps, and equal a launch of limit d from the
    same state (planes bitwise, stats rows equal), each in d iterations of
    the graph's conditional node, and take within 1.05x its device time
    (``loop_launch_ms``, three alternating rounds, medians).  The graph's
    body must hold 4 kernel nodes with zero off and 5 with zero on (K2a
    one launch, the stencil, its fold with the springs, the Langevin
    pass, and zero's sums).
    Times a launch; its bound is the sum of its steps' kernel bounds
    (``phases``: path 1's records; the stencil without energies).
    Returns its record (no launch count)."""
    import torch

    from lammps_le_torch.fast.consts import StencilConsts
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.fast.pallas_step import LAUNCH_MAX, make_step_kernel
    from lammps_le_torch.fixes import Langevin

    system = sim.system
    maps = fast_maps(system)
    lf = next(f for f in sim.fixes if isinstance(f, Langevin))
    real, plain = (make_step_kernel(system, maps, sim.ex_btype, dt=sim.dt,
                                    langevin=lf, g=g, interpret=i)
                   for i in (False, True))
    args = (fs.gx, fs.gv, fs.gf, fs.gx, fs.bid, fs.hn, fs.pid, fs.exl_slot,
            fs.exr_slot, fs.ex_left >= 0, fs.lgm)
    key = (123456789, 987654321)
    head = (fs.step + 1, True, key, 1.0, 0.0)

    def call(f, limit):
        return f(*args, *head, limit)

    (x1, v1, f1, s1), (xp, vp, fp, sp) = call(real, 1), call(plain, 1)
    fmax = float(fp.abs().max())
    err = max(float((f1 - fp).abs().max()), float((v1 - vp).abs().max()))
    *p16, s16 = call(real, LAUNCH_MAX)
    it16 = real.loop.iterations
    xp16, _, _, sp16 = call(plain, LAUNCH_MAX)
    dx = float((p16[0] - xp16).abs().max())
    print(f"step_loop on the 100k planes: one step max|df|, |dv| {err:.3g} "
          f"(tol {F_REL * max(fmax, 1.0):.3g}), x bitwise "
          f"{torch.equal(x1, xp)}, stats {s1.tolist()} vs plain "
          f"{sp.tolist()}; {LAUNCH_MAX}-step launch: {int(s16[7])} steps, "
          f"max|dx| {dx:.3g} (tol 1e-3), stats {s16.tolist()} vs plain "
          f"{sp16.tolist()}", flush=True)
    if (not err <= F_REL * max(fmax, 1.0) or not torch.equal(x1, xp)
            or not torch.equal(s1[2:], sp[2:])
            or not torch.equal(s16[2:], sp16[2:]) or not dx <= 1e-3):
        fail("step_loop differs from its plain loop")
    steps = int(s16[7])
    if not steps < LAUNCH_MAX:
        fail(f"the trigger did not stop a {LAUNCH_MAX}-step launch on path "
             f"1's planes")
    *p_d, s_d = call(real, steps)
    it_d = real.loop.iterations
    same = all(torch.equal(a, b) for a, b in zip(p16, p_d))
    t16, t_d = [], []
    for r in range(3):
        for limit in ((LAUNCH_MAX, steps) if r % 2 == 0
                      else (steps, LAUNCH_MAX)):
            (t16 if limit == LAUNCH_MAX else t_d).append(loop_launch_ms(
                real.loop, (fs.gx, fs.gv, fs.gf), head, limit))
    ratio = float(np.median(t16) / np.median(t_d))
    (k_on, all_on), (k_off, all_off) = (step_graph_nodes(sim, g, fs, z)
                                        for z in (True, False))
    print(f"step_loop ends at the trigger ({card_line()}): a {LAUNCH_MAX}-"
          f"step launch stopped after {steps} steps in {it16} loop "
          f"iterations, a {steps}-step launch in {it_d}; planes bitwise "
          f"{same}, stats equal {torch.equal(s16, s_d)}; device ms a launch "
          f"(control kernel + graph, by events) {np.median(t16):.4f} "
          f"against {np.median(t_d):.4f}: ratio {ratio:.4f} (tol 1.05; "
          f"rounds {[round(t, 4) for t in t16]} and "
          f"{[round(t, 4) for t in t_d]}); one step's graph body: {k_on} "
          f"kernel nodes with zero on ({all_on} nodes), {k_off} with zero "
          f"off ({all_off})", flush=True)
    if not same or not torch.equal(s16, s_d) or it16 != steps or it_d != steps:
        fail("a step-loop launch stopped by the trigger differs from the "
             "launch of its steps, or ran another count of iterations")
    if not ratio <= 1.05:
        fail(f"a stopped {LAUNCH_MAX}-step launch takes {ratio:.4f}x the "
             f"device time of a {steps}-step launch")
    if (k_on, k_off) != (5, 4):
        fail(f"the step loop's body holds {k_on} kernel nodes with zero on "
             f"and {k_off} with it off, want 5 and 4")
    parts = [stencil_bound("stencil_forces", fs, g, maps,
                           StencilConsts(system), system.n, False)]
    parts += [phases[k]["bound"] for k in ("kick_drift_halo",
                                           "extruder_springs",
                                           "langevin_kick_monitor")]
    by = ("operations" if sum(t for t, b in parts if b == "operations")
          > sum(t for t, b in parts if b == "bytes") else "bytes")
    return dict(
        replaces="lammps_le_tpu/fast/pallas_step.py:554", max_abs_err=err,
        tol=f"one step {F_REL}*max|f|={F_REL * max(fmax, 1.0):.3g}, x "
        f"bitwise; {LAUNCH_MAX} steps x 1e-3; stats rows 2-7 equal; "
        f"stopped launch bitwise the launch of its steps, within 1.05x its "
        f"device time",
        steps=steps, ratio=ratio,
        # the launch's steps, each its kernels' bounds
        bound=(steps * sum(t for t, _ in parts), by),
        t=timings(lambda: call(real, LAUNCH_MAX), 20),
        t_plain=timings(lambda: call(plain, LAUNCH_MAX), 1, 1))


def exact_form(fn):
    """fn() with the pair stencils' IEEE reciprocal (kernels.APPROX_RCP
    off for the call)."""
    from lammps_le_torch.fast import kernels as K

    keep = K.APPROX_RCP
    K.APPROX_RCP = False
    try:
        return fn()
    finally:
        K.APPROX_RCP = keep


def rcp_forms(name, call, out, plain, tol):
    """The stencil ``call`` (its wrapper on fixed planes) once more in the
    IEEE form, beside ``out``, its result in the default form, and
    ``plain``, its plain version's: the IEEE form held to the plain one as
    the default is (forces within ``tol``, energies, flags and clamps), and
    both forms' flags and clamps equal.  Prints the largest force
    difference between the two forms.  Returns the IEEE form's timings."""
    import torch

    from lammps_le_torch.fast import kernels as K

    gf_x, en_x, in_x = exact_form(call)
    err_x = float((gf_x - plain[0]).abs().max())
    d_forms = float((out[0] - gf_x).abs().max())
    de = (en_x.double() - plain[1].double()).abs()
    print(f"{name}: default reciprocal "
          f"{'approximate' if K.APPROX_RCP else 'IEEE'}; the IEEE form's "
          f"max_abs_err {err_x:.3g} (tol {tol:.3g}), energies "
          f"{en_x.tolist()}; max|f_default - f_IEEE| {d_forms:.3g}; "
          f"flags/clamps default {out[2].tolist()}, IEEE {in_x.tolist()}",
          flush=True)
    if not err_x <= tol or not bool(
            torch.all(de <= E_ABS + E_REL * plain[1].double().abs())):
        fail(f"{name} in the IEEE form vs its plain version: {err_x} (tol "
             f"{tol}), energies {en_x.tolist()} vs {plain[1].tolist()}")
    if not torch.equal(in_x, out[2]) or not torch.equal(in_x, plain[2]):
        fail(f"{name}: flags/clamps {out[2].tolist()} (default) vs "
             f"{in_x.tolist()} (IEEE) vs {plain[2].tolist()} (plain)")
    return timings(lambda: exact_form(call), 20)


def stencil_phase(fs, sim, g, label="100k"):
    """stencil_forces vs its plain version on the ``label`` planes: forces
    within 3e-5 max|f|, energies, flags and clamps, in the default and in
    the IEEE reciprocal form (``rcp_forms``).  Returns its record (no
    launch count)."""
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
    t_exact = rcp_forms(f"stencil_forces at the {label} planes",
                        lambda: K.stencil_forces(*st_args),
                        (gf_k, en_k, in_k), (gf_r, en_r, in_r),
                        F_REL * max(fmax, 1.0))
    return dict(
        replaces=REPLACES["stencil_forces"], max_abs_err=err,
        tol=f"{F_REL}*max|f|={F_REL * max(fmax, 1.0):.3g}",
        energies=en_k.tolist(), energies_plain=en_r.tolist(),
        bound=stencil_bound("stencil_forces", fs, g, maps, st_args[5], n),
        t_exact=t_exact,
        t=timings(lambda: K.stencil_forces(*st_args), 20),
        t_plain=timings(lambda: R.stencil_forces(*st_args), 3, 1))


def newton_phase(fs, sim, g):
    """newton_half_forces vs its plain version on the config-6 planes at
    the end of that run: forces within 3e-5 max|f|, energies, flags and
    clamps, ghost columns exactly 0, two launches bitwise equal, in the
    default reciprocal form, and in the IEEE one (``rcp_forms``); and vs
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
    t_exact = rcp_forms("newton_half_forces at the config-6 planes",
                        lambda: K.newton_half_forces(*args), k1,
                        (gf_r, en_r, in_r), tol)
    return dict(
        replaces=REPLACES["newton_half_forces"], max_abs_err=err,
        tol=f"{F_REL}*max|f|={tol:.3g}; bitwise run to run", t_exact=t_exact,
        bound=stencil_bound("newton_half_forces", fs, g, maps, C, n),
        bound_full=stencil_bound("stencil_forces", fs, g, maps, C, n),
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
    newton_half_forces.  Returns {sp: the record of window_forces} (no
    launch counts)."""
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
    recs = {}
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
        recs[sp] = r
    return recs


# the hand-written kernels the slab step launches (their symbols in a
# profiler trace); every other device row of its trace is PyTorch's glue
SLAB_KERNELS = ("kick_drift_halo_kernel", "newton_half_kernel",
                "window_finish_kernel", "springs_kernel", "langevin_kernel",
                "langevin_sum_kernel")


def slab_host_ops(sp, n_beads=BEADS, device="cpu", counted=1):
    """The PyTorch operations a slab-resident step issues outside its
    kernels' wrappers (the functions ``kernels.LAUNCHES`` counts), and the
    whole-state chain's on the same slab stencil: (slab-resident, whole)
    a step, each the mean over ``counted`` steps that are neither rebuild
    nor LE event steps, from path 1's serpentine with its seeded
    extruders (no thermalisation: the count does not depend on the
    positions).  Every dispatched ATen operation but a view counts once
    (``TorchDispatchMode``): allocations, copies, index and arithmetic
    operations, host reads.  Runs on the CPU,
    where the wrappers run their plain versions:
    ``python3 -c 'import chip_smoke; chip_smoke.slab_host_ops(2)'``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import make_fast_segment, to_fast
    from lammps_le_torch.integrate import Simulation
    from lammps_le_torch.parallel.spatial import (make_sharded_segment,
                                                  shard_fast_state)
    from lammps_le_torch.state import init_state

    data, system = production_config(n_beads)
    state = seed_extruders(init_state(system, data.x, types=data.types,
                                      seed=11, device=device),
                           N_EX0, n_beads // N_EX0, system.max_extruders)
    sim = Simulation(system=system, dt=0.006, energy_every=100,
                     fixes=le_fixes(), ex_btype=2)
    seg = make_sharded_segment(sim, [torch.device(device)] * sp)
    fs = to_fast(state, sim, kernel_fn=seg.kernel_fn)
    whole, _ = make_fast_segment(sim, pallas=False, kernel_fn=seg.kernel_fn,
                                 device=device)
    inside = [0]

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not inside[0] and not func.is_view:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    def quiet(fn):
        def call(*a, **kw):
            inside[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                inside[0] -= 1
        return call

    saved = {k: getattr(K, k) for k in K.LAUNCHES if hasattr(K, k)}
    out = []
    for run, state_of in ((seg, lambda f: shard_fast_state(f, [
            torch.device(device)] * sp)), (whole, dataclasses.replace)):
        f = state_of(fs)
        b = f.step
        run(f, b, 2, b, b + 2 + counted)
        for k, fn in saved.items():
            setattr(K, k, quiet(fn))
        try:
            Count.n = 0
            with Count():
                run(f, b + 2, counted, b, b + 2 + counted)
        finally:
            for k, fn in saved.items():
                setattr(K, k, fn)
        out.append(Count.n / counted)
    print(f"host operations a step outside the kernels ({n_beads} beads, "
          f"sp={sp}, on {device}): slab-resident {out[0]:.1f}, whole-state "
          f"chain on the slab stencil {out[1]:.1f}", flush=True)
    return tuple(out)


def slab_mesh(sp, first=0):
    """``sp`` slab devices, slab s on cuda:((first + s) % the device
    count): every slab on the one card of a one-card machine, spread over
    the cards of a host of several."""
    import torch

    n = torch.cuda.device_count()
    return [torch.device("cuda", (first + s) % n) for s in range(sp)]


def slab_traffic(label, segment, sfs, steps, b0, bend):
    """``steps`` more steps of a slab-resident run, on a copy of ``sfs``,
    under torch.profiler: the cross-slab copies and their bytes a step
    (shard_step.TRAFFIC: the margins, their reactions, the remote halo
    and fold columns, the springs' anchors, the slabs' monitor values,
    and at rebuilds the gathers and splits), the device time a step of
    the trace's memcpy rows, of the hand-written kernels' rows and of the
    other rows (PyTorch's glue: packing, index, cat, elementwise, the
    rebuilds' placement), beside the wall a step under the profiler.
    Returns them as a dict."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lammps_le_torch.parallel import shard_step as ss

    run = dataclasses.replace(sfs)
    rebuilds0 = run.n_rebuilds
    sync_all()
    ss.reset_traffic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        segment(run, run.step, steps, b0, bend)
        sync_all()
        wall = time.perf_counter() - t0
    traffic = dict(ss.TRAFFIC)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count]

    def us(sel):
        return sum(e.self_device_time_total for e in sel) / steps

    memcpy = [e for e in rows if "memcpy" in e.key.lower()]
    hand = [e for e in rows if any(k in e.key for k in SLAB_KERNELS)]
    out = dict(
        copies=traffic["copies"] / steps, bytes=traffic["bytes"] / steps,
        memcpy_us=us(memcpy), kernels_us=us(hand),
        glue_us=us(rows) - us(memcpy) - us(hand), device_us=us(rows),
        wall_ms=wall / steps * 1e3, rebuilds=run.n_rebuilds - rebuilds0)
    print(f"cross-slab traffic, {label} ({card_line()}; "
          f"{torch.cuda.device_count()} device(s), slabs on "
          f"{[str(d) for d in sfs.mesh]}), {steps} profiled steps "
          f"({out['rebuilds']} rebuilds): {out['copies']:.1f} copies and "
          f"{out['bytes']:.0f} B a step; device us a step: memcpy rows "
          f"{out['memcpy_us']:.2f} ({sum(e.count for e in memcpy)} rows), "
          f"hand-written kernels {out['kernels_us']:.2f}, other glue "
          f"{out['glue_us']:.2f}, all {out['device_us']:.2f}; wall "
          f"{out['wall_ms']:.3f} ms a step under the profiler", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / steps:9.2f} us/step  "
              f"{e.count:6d}x  {e.key[:70]}", flush=True)
    return out


def slab_langevin_phase(sfs, segment, sim, zero=False):
    """The split Langevin pass on the slabs of the state a slab-resident
    run left (``sfs``) at the production gammas: langevin_kick_parts on
    each slab bit for bit its plain version given the same means (the
    plain sums', with ``zero``), and the slabs' monitor merged equal to
    the plain whole-slab monitors merged; with ``zero`` also
    langevin_sums within the f32 round-off of two tree sums of the plain
    sums.  Returns the record of langevin_kick_parts (slab 0's planes),
    or with ``zero`` that of langevin_sums (no launch counts)."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import kernels_ref as R
    from lammps_le_torch.fixes import Langevin
    from lammps_le_torch.parallel.slab_step import merge_monitor

    system = sim.system
    n, units = system.n, system.units
    lf = next(f for f in sim.fixes if isinstance(f, Langevin))
    mass = float(system.masses[0])
    kick = 0.5 * sim.dt * units.ftm2v / mass
    gamma1 = -mass / lf.damp / units.ftm2v
    gamma2 = float(np.sqrt(mass) * np.sqrt(
        24.0 * units.boltz / (lf.damp * sim.dt) / units.mvv2e) / units.ftm2v)
    key = (123456789, 987654321)
    plan = segment.plan(sfs)
    sp = len(sfs.mesh)
    lgm = sfs.lgm or (None,) * sp
    means, sum_err, sum_tol, sums_args = None, 0.0, 0.0, []
    if zero:
        tot = 0.0
        for s in range(sp):
            a = (sfs.gx[s], sfs.bid[s], plan.interior[s], lgm[s], key,
                 sfs.step, n)
            k, r = K.langevin_sums(*a), R.langevin_sums(*a)
            cnt = float(r[3]) if lgm[s] is not None else float(
                R.valid_mask(sfs.bid[s], plan.interior[s], n).sum())
            cap, C = sfs.bid[s].shape
            # two tree sums of cnt terms of |noise| <= 1/2 in f32
            tol = cnt * 2.0 ** -24 * (np.log2(cap * C) + 3)
            sum_err = max(sum_err, float((k - r).abs().max()))
            sum_tol = max(sum_tol, tol)
            tot = tot + r.to(sfs.mesh[0])
            sums_args.append(a)
        inv = (1.0 / n if sfs.lgm is None
               else 1.0 / torch.clamp(tot[3], min=1.0))
        means = tot[:3] * inv
    parts_k, parts_r, err = [], [], 0.0
    for s in range(sp):
        m = None if means is None else means.to(sfs.mesh[s])
        a = (sfs.gx[s], sfs.gx_ref[s], sfs.gv[s], sfs.gf[s], sfs.bid[s],
             plan.interior[s], key, sfs.step, gamma1, gamma2, kick, sim.dt,
             n, True, lgm[s], m)
        k, r = K.langevin_kick_parts(*a), R.langevin_kick_parts(*a)
        if not all(torch.equal(x, y) for x, y in zip(k, r)):
            err = max(err, max(float((x - y).abs().max())
                               for x, y in zip(k, r)))
            fail(f"langevin_kick_parts on slab {s} differs from its plain "
                 f"version ({err})")
        parts_k.append(k[2].to(sfs.mesh[0]))
        parts_r.append(r[2].to(sfs.mesh[0]))
        if s == 0:
            head = a
    ints = [merge_monitor(torch.stack(p), 0.3, 0.2).tolist()
            for p in (parts_k, parts_r)]
    print(f"split Langevin pass on the {sp} slabs ({card_line()}): "
          f"langevin_kick_parts bitwise its plain version; merged monitor "
          f"{ints[0]} vs plain {ints[1]}"
          + (f"; langevin_sums max_abs_err {sum_err:.3g} (tol "
             f"{sum_tol:.3g})" if zero else ""), flush=True)
    if ints[0] != ints[1]:
        fail(f"merged slab monitors {ints}")
    if zero and not sum_err <= sum_tol:
        fail(f"langevin_sums vs its plain version: {sum_err} (tol "
             f"{sum_tol})")
    bid, interior, lg = head[4], head[5], head[14]
    if zero:
        a = sums_args[0]
        cap, C = bid.shape
        w = R.valid_mask(bid, interior, n)
        if lg is not None:
            w = w & (lg != 0)
        # bid, interior and the group plane in, 4 sums out; threefry's
        # three words a member, ~4 f32 operations a slot
        return dict(
            replaces=REPLACES["langevin_sums"], max_abs_err=sum_err,
            tol=f"two f32 tree sums: {sum_tol:.3g}",
            bound=bound(cap * C * (4 + (0 if lg is None else 4)) + C + 16,
                        cap * C * 4, int_ops=3 * int(w.sum()) * THREEFRY_OPS),
            t=timings(lambda: K.langevin_sums(*a), 50),
            t_plain=timings(lambda: R.langevin_sums(*a), 5))
    return dict(
        replaces=REPLACES["langevin_kick_parts"], max_abs_err=err,
        tol="bitwise (given the same means)",
        bound=langevin_bound(bid, interior, n, lg, zero),
        t=timings(lambda: K.langevin_kick_parts(*head), 50),
        t_plain=timings(lambda: R.langevin_kick_parts(*head), 5))


def slab_kernel_phases(sfs, segment, sim):
    """The slab step's per-slab K2a and its springs on the state a
    slab-resident run left (``sfs``), at the shapes the slab step gives
    them, against their plain versions on the same card tensors:
    kick_drift_halo on every slab's (3, cap, C) planes with its image map
    (``SlabPlan.images``: local images in place, the others into its send
    buffer) bit for bit, and ``SlabPlan.halo`` from the send buffers
    bitwise the whole plane's plain kick + drift + halo; extruder_springs on
    the (3, 1, 2E) anchor planes that ``SlabPlan.gather_anchors`` builds
    on mesh[0] from the slabs' planes and the slab stencil's force
    buffers, within path 1's tolerance for the same kernel (F_REL of the
    largest force; energies E_ABS + E_REL).  Returns the records of both
    (slab 0's planes for K2a) and of langevin_kick_parts
    (``slab_langevin_phase``), each with its bound from these tensors (no
    launch counts)."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import kernels_ref as R
    from lammps_le_torch.fast.consts import SpringConsts
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.fast.place import GridConsts

    system = sim.system
    n, units = system.n, system.units
    kick = 0.5 * sim.dt * units.ftm2v / float(system.masses[0])
    plan = segment.plan(sfs)
    sp = len(sfs.mesh)
    recs = {}

    # kick_drift_halo per slab, its sent images included: bitwise; then
    # the exchange from the send buffers gives the whole plane's halo
    xs, sends = [], []
    for s in range(sp):
        a = (sfs.gx[s], sfs.gv[s], sfs.gf[s], sfs.bid[s], plan.interior[s],
             *plan.images[s].halo_lists, n, kick, sim.dt)
        k, r = K.kick_drift_halo(*a, plan.images[s]), R.kick_drift_halo(
            *a, plan.images[s])
        if len(k) != len(r) or not all(torch.equal(x, y)
                                       for x, y in zip(k, r)):
            fail(f"kick_drift_halo on slab {s} differs from its plain "
                 f"version")
        xs.append(k[0])
        sends.append(k[2] if len(k) > 2 else None)
        if s == 0:
            kd = a
    home = sfs.gx[0].device
    whole = [torch.cat([p.to(home) for p in t], -1)
             for t in (sfs.gx, sfs.gv, sfs.gf, sfs.bid)]
    g = GridConsts.build(system, fast_maps(system), home)
    want = R.kick_drift_halo(*whole, g.interior, g.halo_cols, g.halo_src,
                             g.halo_shift, n, kick, sim.dt)[0]
    plan.halo(xs, sends)
    if not torch.equal(torch.cat([x.to(want.device) for x in xs], -1),
                       want):
        fail("the slabs' K2a and halo exchange differ from the whole "
             "plane's kick + drift + halo")
    recs["kick_drift_halo"] = kick_drift_phase(kd, plan.images[0],
                                               f"a slab at sp={sp}")
    recs["kick_drift_halo"]["tol"] = (
        "bitwise, every slab; the exchange bitwise the whole plane")

    # extruder_springs on the anchors gathered onto mesh[0]
    S = SpringConsts(system, sim.ex_btype)
    active = sfs.ex_left >= 0
    n_active = int(active.sum())
    if not n_active:
        fail("no active extruder at the end of the slab-resident window")
    anchors = plan.anchors(sfs.exl_slot, sfs.exr_slot, active)
    bufs = plan.forces(list(sfs.gx),
                       plan.window_ints(sfs.bid, sfs.hn, sfs.pid), False)[0]
    xa, fa = plan.gather_anchors(sfs.gx, bufs, anchors)
    left, right = anchors[1]
    f_k, f_r = fa.clone(), fa.clone()
    eb_k = K.extruder_springs(xa, f_k, left, right, active, S)
    eb_r = R.extruder_springs(xa, f_r, left, right, active, S)
    fmax = float(f_r.abs().max())
    err = float((f_k - f_r).abs().max())
    ek, er = float(eb_k.double().sum()), float(eb_r.double().sum())
    print(f"slab kernels sp={sp} ({card_line()}): kick_drift_halo bitwise "
          f"on every slab (slab 0: {tuple(kd[0].shape)}, "
          f"{int(plan.images[0].idx.shape[0])} images, "
          f"{plan.images[0].n_send} sent), the exchange bitwise the whole "
          f"plane; extruder_springs on the gathered anchors "
          f"{tuple(xa.shape)}, {n_active} active: max_abs_err {err:.3g} "
          f"(bitwise {torch.equal(f_k, f_r)}), energy {ek} vs plain {er}",
          flush=True)
    if not err <= F_REL * max(fmax, 1.0):
        fail(f"extruder_springs on the slab anchors: force error {err} vs "
             f"max|f| {fmax}")
    if not abs(ek - er) <= E_ABS + E_REL * abs(er):
        fail(f"extruder_springs on the slab anchors: energy {ek} vs {er}")
    E = int(left.shape[0])
    scratch = fa.clone()
    recs["extruder_springs"] = dict(
        replaces=REPLACES["extruder_springs"], max_abs_err=err,
        tol=f"{F_REL}*max|f|={F_REL * max(fmax, 1.0):.3g}",
        n_active=n_active,
        # as path 1's: per spring its anchor pair and active bit in, its
        # energy out; per active spring two anchors' x and f in, f out
        bound=bound(E * 13 + n_active * 2 * 36, n_active * 36,
                    divs=n_active * 4),
        t=timings(lambda: K.extruder_springs(xa, scratch, left, right,
                                             active, S), 50),
        t_plain=timings(lambda: R.extruder_springs(xa, scratch, left, right,
                                                   active, S), 20))
    recs["langevin_kick_parts"] = slab_langevin_phase(sfs, segment, sim)
    return recs


def same_state(a, b, names=None):
    """Whether two FastStates hold the same tensors bit for bit (and the
    same host ints): the names of the fields that differ."""
    import torch

    bad = []
    for f in dataclasses.fields(a):
        if names is not None and f.name not in names:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                bad.append(f.name)
        elif x != y:
            bad.append(f.name)
    return bad


def zero_slab_window(sim, start, dev, groups):
    """Path 5's Langevin fix (zero over the group) on the slab-resident
    state at SP_PATH slabs for ZERO_SLAB_STEPS steps from path 5's start,
    against the whole-state chain on the same stencil from the same
    state: the extruder tables, types, counters, flags, rebuilds and step
    equal, the beads' positions within ZERO_X_TOL (the group means' sums
    run over the slabs in another order than over the whole plane), each
    kernel of the slab step launched as ``slab_launches`` says with zero.
    Returns (the record of langevin_sums, the window's launches)."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import make_fast_segment, to_fast
    from lammps_le_torch.parallel.spatial import (
        gather_fast_state, make_sharded_segment, shard_fast_state)

    system = sim.system
    mesh = slab_mesh(SP_PATH)
    seg = make_sharded_segment(sim, mesh)
    fs0 = to_fast(start, sim, groups, kernel_fn=seg.kernel_fn)
    b = fs0.step
    whole, _ = make_fast_segment(sim, pallas=False, kernel_fn=seg.kernel_fn,
                                 device=dev)
    fw = whole(dataclasses.replace(fs0), b, ZERO_SLAB_STEPS, b,
               b + ZERO_SLAB_STEPS)
    sfs = shard_fast_state(fs0, mesh)
    sync_all()
    K.reset_launches()
    t0 = time.perf_counter()
    seg(sfs, b, ZERO_SLAB_STEPS, b, b + ZERO_SLAB_STEPS)
    sync_all()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    got = gather_fast_state(sfs)
    box = torch.as_tensor(np.asarray(system.box_size, np.float32),
                          device=got.gx.device)
    d = bead_positions(got, system) - bead_positions(fw, system)
    dx = float((d - box * torch.round(d / box)).abs().max())
    bad = same_state(got, fw, ("ex_left", "ex_right", "types", "flags",
                               "n_moves", "n_loads", "n_unloads", "step",
                               "n_rebuilds", "img"))
    want = slab_launches(launches, ZERO_SLAB_STEPS, mesh, zero=True)
    print(f"zero+group slab-resident sp={SP_PATH}, {ZERO_SLAB_STEPS} steps "
          f"({card_line()}): {ZERO_SLAB_STEPS / wall:.2f} steps/s; against "
          f"the whole-state chain: beads' max|dx| {dx:.3g} (tol "
          f"{ZERO_X_TOL}), fields that differ {bad}; rebuilds "
          f"{got.n_rebuilds}; launches {launches}", flush=True)
    if bad or not dx <= ZERO_X_TOL:
        fail(f"zero+group slab-resident window vs the whole state: {bad}, "
             f"max|dx| {dx}")
    if launches != want:
        fail(f"zero+group slab-resident launches {launches} (want {want})")
    return slab_langevin_phase(sfs, seg, sim, zero=True), launches


def slab_window(sim, start, dev, sp, profile_steps, sps):
    """Path 1's measured window from ``start`` on the slab-resident state
    at ``sp`` slabs (slab s on cuda:(s % the device count)), healthy with
    ``slab_launches``, and on the whole-state chain on the same slab
    stencil from the same state: both timed (into ``sps``), held bit for
    bit; then the slab-resident run's cross-slab traffic and its per-slab
    kernels against their plain versions (``slab_kernel_phases``).
    Returns (the segment, its ShardedFastState, that state gathered, the
    launches, those kernels' records)."""
    import torch

    from lammps_le_torch.parallel.spatial import (gather_fast_state,
                                                  make_sharded_segment)

    mesh = slab_mesh(sp)
    print(f"{torch.cuda.device_count()} CUDA device(s); sp={sp} slabs on "
          f"{[str(d) for d in mesh]}", flush=True)
    seg = make_sharded_segment(sim, mesh)
    sfs, wall, rebuilds, launches, _ = measured_segment(
        sim, start, dev, WARM, MEASURE, profile_steps, seg.kernel_fn, seg,
        mesh=mesh)
    fs = gather_fast_state(sfs)
    check_run(f"sharded sp={sp} slab-resident", fs, sim.system, wall,
              rebuilds, launches, MEASURE, GRID,
              slab_launches(launches, MEASURE, mesh))
    fw, wall_w, _, _, _ = measured_segment(
        sim, start, dev, WARM, MEASURE, 0, seg.kernel_fn, pallas=False)
    bad = same_state(fs, fw)
    print(f"sharded sp={sp}: slab-resident {MEASURE / wall:.2f} steps/s, "
          f"whole-state {MEASURE / wall_w:.2f} steps/s ({card_line()}); "
          f"fields that differ {bad}", flush=True)
    if bad:
        fail(f"sp={sp} slab-resident window vs the whole state: {bad}")
    sps[f"100k sharded sp={sp}, slab-resident"] = MEASURE / wall
    sps[f"100k sharded sp={sp}, whole state"] = MEASURE / wall_w
    b0 = sfs.step - WARM - MEASURE
    slab_traffic(f"sp={sp}", seg, sfs, TRAFFIC_STEPS, b0,
                 b0 + WARM + MEASURE)
    return seg, sfs, fs, launches, slab_kernel_phases(sfs, seg, sim)


def multi_card_path(sim, settled, start, dev, window4, sps):
    """Path 10, the multi-card paths on the 100k config: the measured
    window slab-resident at SP_WIDE slabs (``slab_window``); then
    dp=DP_REPLICAS x sp=SP_PATH (``make_replicated_sharded_segment``, the
    replicas bench.py's 0 and 1 of the settled state) for DP_STEPS steps,
    each replica bit for bit the sp=SP_PATH segment on it alone on its
    row.  Returns the path's records at SP_WIDE slabs: the slab step's
    per-slab kernels (``slab_kernel_phases``) and, where ``window4`` (its
    kernel phase's record of window_forces) is given, window_forces."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import stack_fast, to_fast
    from lammps_le_torch.parallel.spatial import (
        gather_fast_state, make_replicated_sharded_segment,
        make_sharded_segment, shard_fast_state)

    system = sim.system
    print("path 10", flush=True)
    _, _, _, launches, phases = slab_window(sim, start, dev, SP_WIDE, 0,
                                            sps)
    if window4:
        phases["window_forces"] = window4
    recs = path_records(f"100k sharded sp={SP_WIDE}", phases, launches)

    # dp x sp: a replica a row of SP_PATH slabs
    rows = [slab_mesh(SP_PATH, r * SP_PATH) for r in range(DP_REPLICAS)]
    rseg = make_replicated_sharded_segment(sim, rows)
    if rseg.shard_reason:
        fail(f"dp x sp refused: {rseg.shard_reason}")
    starts = [to_fast(bench_replica(settled, i), sim,
                      kernel_fn=rseg.kernel_fn)
              for i in range(DP_REPLICAS)]
    b = starts[0].step
    runs = shard_fast_state(stack_fast(starts), rows)
    sync_all()
    K.reset_launches()
    t0 = time.perf_counter()
    rseg(runs, b, DP_STEPS, b, b + DP_STEPS)
    sync_all()
    wall = time.perf_counter() - t0
    dp_launches = dict(K.LAUNCHES)
    one = make_sharded_segment(sim, rows[0])
    differ = []
    for r, (run, fs0) in enumerate(zip(runs, starts)):
        alone = one(shard_fast_state(fs0, rows[r]), b, DP_STEPS, b,
                    b + DP_STEPS)
        got = gather_fast_state(run)
        differ.append(same_state(got, gather_fast_state(alone)))
        sick = replica_health(got, system)
        if sick or not bool(torch.isfinite(got.gx).all()):
            fail(f"dp x sp replica {r} unhealthy: {sick}")
    want = slab_launches(dp_launches, DP_STEPS * DP_REPLICAS, rows[0])
    print(f"dp={DP_REPLICAS} x sp={SP_PATH} ({card_line()}; rows "
          f"{[[str(d) for d in row] for row in rows]}): {DP_STEPS} steps of "
          f"{DP_REPLICAS} replicas in {wall:.3f} s, "
          f"{DP_STEPS * DP_REPLICAS / wall:.2f} replica steps/s; each "
          f"replica against the sp={SP_PATH} segment on it alone: fields "
          f"that differ {differ}; rebuilds {[r.n_rebuilds for r in runs]}",
          flush=True)
    if any(differ):
        fail(f"dp x sp replicas differ from their runs alone: {differ}")
    if dp_launches != want:
        fail(f"dp x sp launches {dp_launches} (want {want})")
    sps[f"100k dp={DP_REPLICAS} x sp={SP_PATH} (replica steps)"] = (
        DP_STEPS * DP_REPLICAS / wall)
    return recs


def general_replicas(sim, start, dev):
    """Config 2's GEN_REPLICAS replicas of the warm state (keys folded
    from seed 5) over a mesh of GEN_MESH devices (``make_replica_runner``
    with ``mesh``: contiguous blocks, each stepped by its device's
    make_step, step i on every device before step i + 1) for
    GEN_REPLICA_STEPS steps, against the one-card runner on the same
    replicas: every field bit for bit."""
    import torch

    from lammps_le_torch.parallel import (gather_replica_state,
                                          make_replica_runner,
                                          replicate_state,
                                          sharded_replica_state)

    ndev = torch.cuda.device_count()
    mesh = [torch.device("cuda", i % ndev) for i in range(GEN_MESH)]
    reps = replicate_state(state_on(start, dev), GEN_REPLICAS, seed=5)
    setup1, seg1 = make_replica_runner(sim, device=dev)
    t0 = time.perf_counter()
    one = seg1(setup1(reps), GEN_REPLICA_STEPS)
    sync(dev)
    wall1 = time.perf_counter() - t0
    setup_m, seg_m = make_replica_runner(sim, mesh=mesh)
    t0 = time.perf_counter()
    blocks = seg_m(setup_m(sharded_replica_state(reps, mesh)),
                   GEN_REPLICA_STEPS)
    sync_all()
    wall = time.perf_counter() - t0
    got = gather_replica_state(blocks)
    bad = [k for k in GEN_INTS + ("x", "v", "f", "key", "epair", "ebond")
           if not torch.equal(getattr(got, k), getattr(one, k))]
    print(f"general path config 2, {GEN_REPLICAS} replicas over "
          f"{[str(d) for d in mesh]} ({card_line()}): {GEN_REPLICA_STEPS} "
          f"steps in {wall:.3f} s (one-card runner {wall1:.3f} s); fields "
          f"that differ from the one-card runner {bad}; moves "
          f"{got.n_moves.tolist()}", flush=True)
    if bad or not bool(torch.isfinite(got.x).all()):
        fail(f"general path replicas over a mesh: {bad}")


def shuffle_rows(planes, seed=0):
    """``planes`` (tensors of shape (..., cap, P)) with the rows of each
    column in another order, one random permutation a column from
    ``seed``: planes that no placement packs, on which the stencils must
    give the same forces at the moved slots."""
    import torch

    cap, P = planes[0].shape[-2:]
    gen = torch.Generator(device=planes[0].device).manual_seed(seed)
    order = torch.argsort(torch.rand((cap, P), generator=gen,
                                     device=planes[0].device), dim=0)
    return tuple(torch.take_along_dim(t, order.expand_as(t), dim=-2)
                 for t in planes)


def tiled_phase(fs, sim, g):
    """tiled_stencil_forces vs its plain version on the measured 100k
    planes and on the same planes with each column's rows shuffled
    (forces within 3e-5 max|f|, energies, flags and clamps equal), and vs
    stencil_forces (2e-4 max|f|, flags and clamps equal).  Returns its
    record (no launch count), with stencil_forces' times on the same
    planes in both reciprocal forms."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import kernels_ref as R
    from lammps_le_torch.fast.consts import StencilConsts
    from lammps_le_torch.fast.maps import fast_maps

    system = sim.system
    maps = fast_maps(system)
    n = system.n
    tail = (StencilConsts(system), n, maps.strides, True)
    args = (fs.gx, fs.bid, fs.hn, fs.pid, g.interior) + tail
    gx_s, bid_s, hn_s, pid_s = shuffle_rows((fs.gx, fs.bid, fs.hn, fs.pid))
    shuffled = (gx_s, bid_s, hn_s, pid_s, g.interior) + tail
    gf_s, en_s, in_s = K.stencil_forces(*args)
    errs = []
    for label, a in (("packed", args), ("rows shuffled", shuffled)):
        gf_k, en_k, in_k = K.tiled_stencil_forces(*a)
        gf_r, en_r, in_r = R.tiled_stencil_forces(*a)
        fmax = float(gf_r.abs().max())
        err = float((gf_k - gf_r).abs().max())
        tol = F_REL * max(fmax, 1.0)
        de = (en_k.double() - en_r.double()).abs()
        e_ok = bool(torch.all(de <= E_ABS + E_REL * en_r.double().abs()))
        print(f"tiled_stencil_forces at {tuple(fs.gx.shape)}, {label}: "
              f"max_abs_err {err:.3g} (tol {tol:.3g}), energies "
              f"{en_k.tolist()} vs plain {en_r.tolist()}, flags/clamps "
              f"{in_k.tolist()} vs {in_r.tolist()}", flush=True)
        if not err <= tol or not e_ok or not torch.equal(in_k, in_r):
            fail(f"tiled_stencil_forces vs its plain version ({label}): "
                 f"{err} (tol {tol}), {en_k.tolist()} vs {en_r.tolist()}, "
                 f"{in_k.tolist()} vs {in_r.tolist()}")
        errs.append(err)
        if label == "packed":
            out, tol0, fmax0 = (gf_k, en_k, in_k), tol, fmax
    err_full = float((gf_s - out[0]).abs().max())
    print(f"tiled_stencil_forces vs stencil_forces on the packed planes: "
          f"max|df| {err_full:.3g}, energies {en_s.tolist()}, flags/clamps "
          f"{in_s.tolist()}", flush=True)
    if not err_full <= F_REL_STENCILS * max(fmax0, 1.0) or not torch.equal(
            in_s, out[2]):
        fail(f"tiled_stencil_forces vs stencil_forces: {err_full}, "
             f"{out[2].tolist()} vs {in_s.tolist()}")
    rec = dict(
        replaces="lammps_le_tpu/fast/pallas_kernel.py:59",
        max_abs_err=max(errs),
        tol=f"{F_REL}*max|f|={tol0:.3g}, packed and rows shuffled; vs "
        f"stencil_forces {F_REL_STENCILS}*max|f|",
        bound=stencil_bound("tiled_stencil_forces", fs, g, maps, tail[0],
                            n),
        t=timings(lambda: K.tiled_stencil_forces(*args), 20),
        t_shuffled=timings(lambda: K.tiled_stencil_forces(*shuffled), 20),
        t_plain=timings(lambda: R.tiled_stencil_forces(*args), 3, 1),
        t_full=timings(lambda: K.stencil_forces(*args), 20),
        t_full_exact=timings(
            lambda: exact_form(lambda: K.stencil_forces(*args)), 20))
    print(f"tiled_stencil_forces / stencil_forces on the packed 100k planes "
          f"({card_line()}): device {rec['t'][0]:.4f} / "
          f"{rec['t_full_exact'][0]:.4f} ms (IEEE form) = "
          f"{rec['t'][0] / rec['t_full_exact'][0]:.3f}, / "
          f"{rec['t_full'][0]:.4f} (default form) = "
          f"{rec['t'][0] / rec['t_full'][0]:.3f}; rows shuffled "
          f"{rec['t_shuffled'][0]:.4f} ms", flush=True)
    return rec


def step_graph_nodes(sim, g, fs, zero):
    """(kernel nodes, all nodes) of one step of K2's step loop for ``sim``
    on the planes of ``fs``, its Langevin fix's ``zero`` set as given: the
    body of the loop's conditional graph, built as at its first launch,
    its nodes read by the library from its own graph (cudaGraphGetNodes,
    cudaGraphNodeGetType)."""
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.fast.pallas_step import make_step_kernel
    from lammps_le_torch.fixes import Langevin

    lf = next(f for f in sim.fixes if isinstance(f, Langevin))
    loop = make_step_kernel(sim.system, fast_maps(sim.system), sim.ex_btype,
                            dt=sim.dt, langevin=dataclasses.replace(
                                lf, zero=zero), g=g).loop
    loop._alloc(fs.gx, fs.exl_slot, fs.lgm)
    loop._build()
    return loop.body_nodes()


def zero_group_phase(fs, sim, g):
    """langevin_kick_monitor with ``zero`` over the group plane of the run
    that left ``fs`` (path 5), on its planes at the production gammas:
    against its plain version (forces and velocities within 3e-5 max|f|,
    flags and trigger equal), two launches bitwise equal; the random
    force alone (v, f, gamma1 and the kick 0) summed over the group per
    component within f32 round-off of 0; the forces and velocities of
    every slot outside the group bitwise those of the zero-off call.
    Returns its record (no launch count), with the times
    of the call without zero, with and without the group, on the same
    planes."""
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
        replaces=REPLACES["langevin_kick_monitor"], max_abs_err=err,
        tol=f"{F_REL}*max|f|={tol:.3g}; bitwise run to run; group sum of "
        f"the random force <= {sum_tol:.3g}; outside the group bitwise the "
        f"zero-off call's",
        bound=langevin_bound(fs.bid, g.interior, n, lgm, True),
        bound_nozero=langevin_bound(fs.bid, g.interior, n),
        t=timings(lambda: K.langevin_kick_monitor(*on), 50),
        t_plain=timings(lambda: R.langevin_kick_monitor(*on), 5),
        t_nozero=timings(lambda: K.langevin_kick_monitor(*head), 50),
        t_group=timings(lambda: K.langevin_kick_monitor(*head, lgm), 50))


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


def alternate_ms(fns: dict, rounds: int = 20, calls: int = 10) -> dict:
    """{name: [device ms a call, one a round]} of each function of
    ``fns`` ({name: fn}), timed in turns (``probes.device_ms``: CUDA
    events around ``calls`` calls queued behind a sleep kernel), the order
    reversed every other round, so that drifts of the card's clock fall on
    every form alike."""
    from lammps_le_torch.probes import device_ms

    names = list(fns)
    out = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            out[name].append(device_ms(fns[name], calls))
    return out


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
    one = C.reciprocal_one(xd)
    if not torch.equal(one, got):
        fail("rcp: the float4 form and the one-element form differ")
    t_floor = timings(lambda: C.launch_floor(xd.numel()), 50)
    out.append(("probe P1 precision", "rcp", dict(
        replaces="benchmarks/probe_rcp.py:63", max_abs_err=err,
        tol="max rel err <= 2^-22 over both domains", launches=launches,
        bound=bound(8 * xd.numel(), xd.numel(), mufu=xd.numel()),
        t=timings(lambda: C.reciprocal(xd), 50),
        t_plain=timings(lambda: 1.0 / xd, 50),
        t_lib=timings(lambda: torch.reciprocal(xd), 50), t_floor=t_floor)))
    rec = out[-1][2]
    ab = alternate_ms({
        "float4 form": lambda: C.reciprocal(xd),
        "one-element form": lambda: C.reciprocal_one(xd),
        "empty kernel": lambda: C.launch_floor(xd.numel()),
        "torch.reciprocal": lambda: torch.reciprocal(xd)}, 20, 50)
    print(f"P1 rcp ({C.ROWS}x{C.P}): {rec['t'][0]:.4f} ms a call "
          f"({rec['t'][2]}), bound {rec['bound'][0]:.4f} by "
          f"{rec['bound'][1]}, launch floor (an empty kernel at its launch "
          f"shape, the same profiler) {t_floor[0]:.4f} ms ({t_floor[2]}); "
          f"float4 form bitwise the one-element form; by events, 20 rounds "
          f"in turns, median (quartiles) ms a call: " + "; ".join(
              f"{k} {np.median(v):.5f} ({np.percentile(v, 25):.5f}-"
              f"{np.percentile(v, 75):.5f})" for k, v in ab.items()),
          flush=True)

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


def straddle_explain(gx, bid, hn, pid, valid, C, n, strides, diff, thr):
    """Explain a Newton-half stencil's deviation ``diff`` (3, cap, P),
    float64, from the full stencil on the planes ``gx`` (3, cap, P) f32,
    ``bid``, ``hn``, ``pid`` (cap, P) and ``valid`` (cap, P) bool, numpy
    each, beyond ``thr``: by the pairs that straddle the LJ cut.

    The full stencil gives bead b the pair with j at b's own view of it,
    the slot of j (or its ghost image) in b's 27 cells.  The Newton-half
    one computes each pair once, from the bead that sees the other at a
    forward offset, and gives the other the reaction (through its ghost
    image's fold where that slot is a ghost).  Where b sees j's ghost at
    a backward offset, the two forms' squared distances, x_b - (x_j +
    shift) and x_j - (x_b - shift) in f32 (csrc/stencil.cuh's operand
    order, no FMA), differ by the images' rounding, and a pair whose two
    distances fall on opposite sides of ``cutsq`` adds its LJ force to
    one form only.  Each bead whose deviation passes ``thr`` must have
    such pairs, and its deviation must be their float64 LJ forces'
    (half minus full) within ``thr``.  Returns (beads, pairs, largest
    residual, the beads left unexplained: (bead, pairs, residual))."""
    from lammps_le_torch.ops.grid import _OFFSETS

    cap, P = bid.shape
    sx, sy, sz = strides
    deltas = np.array([a * sx + b * sy + c * sz for a, b, c in _OFFSETS])
    back = np.array([o < (0, 0, 0) for o in _OFFSETS])
    x = gx.reshape(3, -1).astype(np.float32)
    b_of, ok = bid.reshape(-1), valid.reshape(-1)
    pid_of = pid.reshape(-1)
    u1 = np.where(hn.reshape(-1).astype(bool), b_of + 1, n + 2)
    slot_of = np.full(n + 1, -1, np.int64)
    slot_of[b_of[ok]] = np.flatnonzero(ok)
    cut = np.float32(C.cutsq)
    rows = np.arange(cap)[:, None] * P

    def view(s):
        """The occupied slots of s's 27 cells, (cap, 27), and whether
        each lies at a backward offset."""
        q = rows + (s % P + deltas[None, :]) % P
        return q, np.broadcast_to(back, q.shape)

    def rsq32(s, q):
        d = x[:, s] - x[:, q]
        return d[0] * d[0] + d[1] * d[1] + d[2] * d[2], d.astype(np.float64)

    def lj(d):
        r2 = 1.0 / float(d @ d)
        r6 = r2 * r2 * r2
        return d * (r6 * (C.lj1 * r6 - C.lj2) * r2)

    dev = diff.reshape(3, -1)
    over = np.flatnonzero(ok & (np.abs(dev).max(0) > thr))
    n_pairs, worst, left = 0, 0.0, []
    for s in over:
        bi = b_of[s]
        want = np.zeros(3)
        found = 0
        qs, bk = view(s)
        for q in qs[bk & (b_of[qs] < n) & ~ok[qs]]:
            bj = b_of[q]
            if bj == bi or bj == u1[s] or bi == u1[q] or bj == pid_of[s]:
                continue  # bonded or excluded: no LJ at the cut
            sj = slot_of[bj]
            if sj < 0:
                continue
            qj = view(sj)[0].reshape(-1)
            qj = qj[b_of[qj] == bi]
            if qj.size != 1:
                continue
            r_b, d_b = rsq32(s, q)
            r_j, d_j = rsq32(sj, qj[0])
            if (r_b < cut) == (r_j < cut):
                continue
            found += 1
            # the half form's reaction on b, or the full form's force
            want -= lj(d_j) if r_j < cut else lj(d_b)
        res = float(np.abs(dev[:, s] - want).max())
        n_pairs += found
        worst = max(worst, res)
        if not found or res > thr:
            left.append((int(bi), found, res))
    return len(over), n_pairs, worst, left


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
    from its place ``x_full`` at the end of that path.  With ``newton``
    every call whose forces deviate from stencil_forces' by more than
    F_REL x max|f| is also held to stencil_forces: the pairs straddling
    the LJ cut must explain each bead past that (``straddle_explain``).
    Prints the calls with clamps, the largest deviation from
    stencil_forces and the straddles; fails on a disagreement."""
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
    log, straddles = [], []

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
            if float(err_full) > F_REL:
                # held to stencil_forces too: the straddling pairs
                # explain every bead past F_REL, or the run fails
                host = [t.cpu().numpy() for t in (gx, bid, hn, pid, valid)]
                straddles.append((len(log), float(scale), straddle_explain(
                    *host, C, n, maps.strides,
                    (out[0].double() - gf_s.double() * valid).cpu().numpy(),
                    F_REL * float(scale))))
        log.append(torch.cat([torch.stack([err, err_full]).double(),
                              out[2].double(), in_s.double()]))
        return out

    fs = measured_segment(sim, start, dev, WARM, MEASURE, 0, shadowed,
                          pallas=False)[0]
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
    if newton:
        beads = sum(r[0] for _, _, r in straddles)
        pairs = sum(r[1] for _, _, r in straddles)
        resid = max([r[2] / sc for _, sc, r in straddles], default=0.0)
        left = [(k, r[3]) for k, _, r in straddles if r[3] or not r[0]]
        print(f"witness {label} straddles: {len(straddles)} calls past "
              f"{F_REL} x max|f| of stencil_forces, {beads} beads there "
              f"explained by {pairs} pairs straddling the LJ cut in f32 "
              f"(the two forms' images), largest residual {resid:.3g} x "
              f"max|f| (tol {F_REL}); unexplained {left[:5]}", flush=True)
        if left:
            fail(f"witness {label}: deviations from stencil_forces that no "
                 f"straddling pair explains: {left[:5]}")
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
        segment, _ = make_fast_segment(sim, pallas=False,
                                       kernel_fn=kernel_fn, device=dev)
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
    one, on the card in K2's step loop, or as kernel_fn on the chain the
    Newton-half, the tiled or, with two slabs on the run's device, the
    sharded one): the same events, positions within 1e-3; the CPU run
    launches no kernel, the card run each of its kernels once a step."""
    import torch

    from lammps_le_torch.fast import (from_fast, kernels as K,
                                      make_fast_segment, run_fast, to_fast)
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
        st, _ = run_fast(warm, st, 30)
        st = seed_extruders(st, 20, 100, system.max_extruders)
        kernel_fn = kernel_fns[stencil](d)
        segment, _ = make_fast_segment(
            sim, pallas=None if kernel_fn is None else False,
            kernel_fn=kernel_fn, device=d)
        K.reset_launches()
        fs = to_fast(st, sim, kernel_fn=kernel_fn)
        segment(fs, fs.step, steps, fs.step, fs.step + steps)
        out[str(d)] = from_fast(fs, system), dict(K.LAUNCHES), fs.n_launches
    (a, la, _), (b, lb, nl) = out["cpu"], out[str(dev)]
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
    # to_fast evaluates the forces once more
    want = path_launches(lb, stencil, steps, nl)
    want[stencil] = want["extruder_springs"] = steps + 1
    if any(la.values()) or lb != want or (stencil == "stencil_forces") != (
            nl > 0):
        fail(f"small end-to-end launches: cpu {la}, cuda {lb} (want {want}, "
             f"{nl} step-loop launches)")


def sweep_sim(sim):
    """bench.py's sweep Simulation (bench.py:521-527): the production one
    with the static cadence SWEEP_EVERY."""
    from lammps_le_torch.integrate import Simulation

    system = sim.system
    system = system.replace(neighbor=dataclasses.replace(
        system.neighbor, rebuild_every=SWEEP_EVERY))
    return Simulation(system=system, dt=sim.dt,
                      energy_every=sim.energy_every, fixes=sim.fixes,
                      ex_btype=sim.ex_btype)


def replica_health(fs, system, overflowed=False):
    """What fails bench.py's health check (bench.py:602-610) in one run's
    FastState: every bead on an interior slot, no error-class flag, FENE
    clamps <= 20 per move, T in (0.5, 2.0); with ``overflowed`` (its
    flags include FLAG_CELL_OVERFLOW, which drops a bead from the grid)
    only the clamps and T.  Returns [what failed]."""
    import torch

    from lammps_le_torch.fast import thermo_row_fast
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.state import FLAG_FENE_CLAMP

    temp = float(thermo_row_fast(fs, system).temp)
    flags, moves, clamps = (int(t) for t in (fs.flags, fs.n_moves,
                                             fs.n_clamps))
    out = []
    if not overflowed:
        interior = torch.as_tensor(fast_maps(system).interior,
                                   device=fs.gx.device)
        placed = int(((fs.bid < system.n) & interior).sum())
        if placed != system.n:
            out.append(f"{placed} of {system.n} beads on the grid")
        if flags & ~FLAG_FENE_CLAMP:
            out.append(f"error-class flags {flags:#x}")
    if clamps > 20 * max(moves, 1):
        out.append(f"{clamps} FENE clamp events for {moves} moves")
    if not 0.5 < temp < 2.0:
        out.append(f"temperature {temp}")
    return out


def check_replicas(label, fs, system, wall, rebuilds, launches, measure,
                   want):
    """Print a replica-batched window's throughput and each replica's
    health (finite planes of the path's shape, ``replica_health``); fail
    unless each kernel launched ``want[name]`` times for all replicas
    and every replica is healthy, a replica whose flags include
    FLAG_CELL_OVERFLOW (a cell past cap at a rebuild) held to its clamps
    and T only here: ``overflow_witness`` then holds it to the rest.
    Returns (steps a second, the replicas whose flags include
    FLAG_CELL_OVERFLOW)."""
    import torch

    from lammps_le_torch.fast import replica, thermo_row_fast
    from lammps_le_torch.state import FLAG_CELL_OVERFLOW

    R = fs.replicas
    temps = thermo_row_fast(fs, system).temp.tolist()
    flags, moves, clamps = (t.tolist() for t in (fs.flags, fs.n_moves,
                                                 fs.n_clamps))
    sps = measure / wall
    fl = 0
    for f in flags:
        fl |= f
    print(f"{label}: {measure} steps in {wall:.3f} s: {sps:.2f} steps/s, "
          f"{sps * system.n * R:.6g} bead*steps/s over the {R} replicas "
          f"({card_line()}); rebuilds {rebuilds}; mean T "
          f"{sum(temps) / R:.4f}; flags (or) {fl:#x}; moves {sum(moves)}, "
          f"clamps {sum(clamps)}; per replica T {[round(t, 4) for t in temps]}"
          f", moves {moves}, clamps {clamps}", flush=True)
    print(f"{label}: kernel launches in the {measure} measured steps "
          f"{launches}, {sum(launches.values()) / measure:.4f} a step",
          flush=True)
    if tuple(fs.gx.shape) != (R, 3) + GRID or not bool(
            torch.isfinite(fs.gx).all() and torch.isfinite(fs.gv).all()):
        fail(f"{label}: planes of shape {tuple(fs.gx.shape)} or not finite")
    overflowed = [r for r in range(R) if flags[r] & FLAG_CELL_OVERFLOW]
    for r in range(R):
        bad = replica_health(replica(fs, r), system, r in overflowed)
        if bad:
            fail(f"{label} replica {r}: " + "; ".join(bad))
    if sum(moves) <= 0:
        fail(f"{label}: no extrusion move in the run")
    if launches != want:
        fail(f"{label}: kernel launches {launches} (want {want})")
    return sps, overflowed


def numpy_cell_counts(x, system):
    """Beads a cell of the configuration's nx x ny x nz grid at positions
    ``x`` ((N, 3), any image), counted with numpy in f64: each coordinate
    wrapped into the box and binned by its fraction of it (the grid's
    rule, engine.py's placement not used)."""
    nb = system.neighbor
    dims = np.array([nb.nx, nb.ny, nb.nz])
    lo = np.asarray(system.box_lo, np.float64)
    frac = (np.asarray(x, np.float64) - lo) / np.asarray(system.box_size,
                                                          np.float64)
    frac -= np.floor(frac)
    cell = np.minimum((frac * dims).astype(np.int64), dims - 1)
    return np.bincount(np.ravel_multi_index(cell.T, dims),
                       minlength=int(dims.prod()))


def overflow_witness(label, segment, sim, settled, fs, r, b0, bend):
    """Replica ``r`` of path 6's state ``fs``, whose flags include
    FLAG_CELL_OVERFLOW, run again alone on the one-run chain (its key
    folded with SWEEP_SEED + r) a step a call, the flags read after each,
    until the first step whose flags hold the overflow, then on to
    ``fs.step``.  Fails unless the run is healthy (``replica_health``)
    through the step before it, that step is a due rebuild of the static
    schedule, the positions that rebuild binned (the state before the
    step after its kick and drift, K2a; LE events move no bead) put more
    than cap beads in a cell by ``numpy_cell_counts``, and the run ends
    bit for bit as the replica did."""
    import torch

    from lammps_le_torch import rng
    from lammps_le_torch.fast import kernels as K, replica, to_fast
    from lammps_le_torch.fast.engine import extract_beads, rebuild_schedule
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.fast.place import GridConsts
    from lammps_le_torch.state import FLAG_CELL_OVERFLOW

    system = sim.system
    maps = fast_maps(system)
    one = to_fast(settled, sim)
    one = dataclasses.replace(one, key_words=rng.fold_in(
        one.key_words, SWEEP_SEED + r))
    s = b0
    while True:
        before = dataclasses.replace(one, **{
            f.name: getattr(one, f.name).clone()
            for f in dataclasses.fields(one)
            if isinstance(getattr(one, f.name), torch.Tensor)})
        segment(one, s, 1, b0, bend)
        s += 1
        if int(one.flags) & FLAG_CELL_OVERFLOW:
            break
        if s == fs.step:
            fail(f"{label} replica {r}: its one-run chain never overflows")
    segment(one, s, fs.step - s, b0, bend)
    g = GridConsts.build(system, maps, one.gx.device)
    kick = 0.5 * sim.dt * system.units.ftm2v / float(system.masses[0])
    gx, _ = K.kick_drift_halo(before.gx, before.gv, before.gf, before.bid,
                              g.interior, g.halo_cols, g.halo_src,
                              g.halo_shift, system.n, kick, sim.dt, g.images)
    x = extract_beads(dataclasses.replace(before, gx=gx), maps)[0]
    counts = numpy_cell_counts(x.cpu().numpy(), system)
    due = rebuild_schedule(sim, reactive=False)(s)
    bad = replica_health(before, system)
    mine = replica(fs, r)
    same = [k for k in REPLICA_WITNESS
            if not torch.equal(getattr(one, k), getattr(mine, k))]
    print(f"{label} replica {r}: flags {int(mine.flags):#x}; its one-run "
          f"chain with the same key first overflows at step {s} (a due "
          f"rebuild {due}), healthy through step {s - 1} "
          f"({'; '.join(bad) or 'yes'}); that rebuild's positions binned "
          f"by numpy: fullest cell {int(counts.max())} beads, "
          f"{int((counts > maps.cap).sum())} cells past cap {maps.cap}; "
          f"the run ends "
          + ("bit for bit as the replica" if not same
             else f"differently in {same}"), flush=True)
    if bad or not due or counts.max() <= maps.cap or same:
        fail(f"{label} replica {r}: its overflow is not witnessed (due "
             f"{due}, health before {bad}, fullest cell "
             f"{int(counts.max())}, differs in {same})")


def replica_sweep(sim, settled, dev, profile_steps):
    """Path 6, bench.py's --sweep (bench.py:517-583) from path 1's settled
    State: for each R of SWEEP, R replicas (keys folded with SWEEP_SEED +
    i, ``run_fast_replicas``) on the non-reactive chain with the static
    cadence SWEEP_EVERY, 40 warm-up steps, then MEASURE steps in chunks of
    SWEEP_CHUNK, each ending in a host read as bench.py's does; the launch
    counts zeroed just before the measured steps and read just after.
    Host syncs a step over SYNC_STEPS more steps on a copy and, with
    ``profile_steps``, the device busy share.  Replica 0 must end bit for
    bit the same at every R, and a replica that overflows a cell (cap 9 is
    the configuration's limit) is held to ``overflow_witness``.  Returns
    (the R = max(SWEEP) FastState, its window's launches, {R: steps/s})."""
    import torch

    from lammps_le_torch.fast import (kernels as K, make_fast_segment,
                                      replica, run_fast_replicas)

    sim_x = sweep_sim(sim)
    system = sim_x.system
    segment, _ = make_fast_segment(sim_x, pallas=False, reactive=False,
                                   device=dev)
    sps, first, fs = {}, None, None
    for R in SWEEP:
        del fs
        torch.cuda.empty_cache()
        fs = run_fast_replicas(sim_x, settled, R, 0, seed=SWEEP_SEED)
        b0 = fs.step
        bend = b0 + WARM + MEASURE
        segment(fs, b0, WARM, b0, bend)
        torch.cuda.synchronize()
        rebuilds0 = fs.n_rebuilds
        K.reset_launches()
        t0 = time.perf_counter()
        done = 0
        while done < MEASURE:
            this = min(SWEEP_CHUNK, MEASURE - done)
            segment(fs, b0 + WARM + done, this, b0, bend)
            fs.flags.cpu()  # bench.py's device_get of each chunk
            done += this
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        sps[R], overflowed = check_replicas(
            f"replicas R={R}", fs, system, wall, fs.n_rebuilds - rebuilds0,
            launches, MEASURE, path_launches(launches, "stencil_forces"))
        for r in overflowed:
            overflow_witness(f"replicas R={R}", segment, sim_x, settled, fs,
                             r, b0, bend)
        if profile_steps:
            dev_ms = profile_window(segment, dataclasses.replace(fs),
                                    system, profile_steps, b0, bend)
            print(f"replicas R={R}: device busy at the measured rate: "
                  f"{dev_ms:.4f} ms a step x {sps[R]:.2f} steps/s = "
                  f"{100 * dev_ms * sps[R] / 1e3:.1f}%", flush=True)
        count_syncs(segment, dataclasses.replace(fs), SYNC_STEPS, b0, bend)
        zero = replica(fs, 0)
        if first is None:
            first = {k: getattr(zero, k).clone() for k in REPLICA_WITNESS}
        else:
            same = [k for k in REPLICA_WITNESS
                    if not torch.equal(first[k], getattr(zero, k))]
            verdict = "bitwise the same" if not same else f"differs in {same}"
            print(f"replica 0 at R={R} against R={SWEEP[0]}: {verdict}",
                  flush=True)
            if same:
                fail(f"replica 0 at R={R} differs from R={SWEEP[0]} in {same}")
    print(f"path 6 ({card_line()}): " + ", ".join(
        f"R={R} {v:.2f} steps/s, {v * system.n * R:.6g} bead*steps/s"
        for R, v in sps.items()), flush=True)
    return fs, launches, sps


def batched_records(runs, sim, g, one_bound, names):
    """Each chain kernel of ``names`` at R = len(runs) on those runs'
    planes (one run's FastStates, each replica's distinct), stacked: one
    batched launch against the R one-run launches (bitwise) and against
    the plain version (forces at the tolerance the one-run form is held
    to, a stencil's energies, flags and clamps too), timed against the R
    one-run launches; the bound the R one-run bounds
    (``one_bound(name, run)``).  Returns per-kernel records (no launch
    counts)."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import kernels_ref as R
    from lammps_le_torch.fast.consts import SpringConsts, StencilConsts
    from lammps_le_torch.fast.maps import fast_maps

    system = sim.system
    maps = fast_maps(system)
    n, nrep = system.n, len(runs)
    kick = 0.5 * sim.dt / float(system.masses[0])
    C, S = StencilConsts(system), SpringConsts(system, sim.ex_btype)
    keys = [(123456789 + r, 987654321 + 7 * r) for r in range(nrep)]
    words = torch.as_tensor(np.array(keys, np.uint32).view(np.int32),
                            device=runs[0].gx.device)
    step = runs[0].step

    def stacked(*fields):
        return tuple(torch.stack([getattr(f, k) for f in runs])
                     for k in fields)

    cases = {
        "stencil_forces": lambda M: (
            lambda gx, bid, hn, pid: M.stencil_forces(
                gx, bid, hn, pid, g.interior, C, n, maps.strides, True),
            stacked("gx", "bid", "hn", "pid"), None),
        "newton_half_forces": lambda M: (
            lambda gx, bid, hn, pid: M.newton_half_forces(
                gx, bid, hn, pid, g.interior, g.faces, C, n, maps.strides,
                maps.fold_shifts, True),
            stacked("gx", "bid", "hn", "pid"), None),
        "kick_drift_halo": lambda M: (
            lambda gx, gv, gf, bid: M.kick_drift_halo(
                gx, gv, gf, bid, g.interior, g.halo_cols, g.halo_src,
                g.halo_shift, n, kick, sim.dt, g.images),
            stacked("gx", "gv", "gf", "bid"), None),
        # in place on the forces: each check on its own copy of them, the
        # timed calls on one scratch copy (``scratch``)
        "extruder_springs": lambda M: (
            lambda gx, gf, exl, exr, act: (gf, M.extruder_springs(
                gx, gf, exl, exr, act, S)),
            stacked("gx", "gf", "exl_slot", "exr_slot")
            + (stacked("ex_left")[0] >= 0,), None),
        "langevin_kick_monitor": lambda M: (
            lambda gx, gxr, gv, gf, bid, key: M.langevin_kick_monitor(
                gx, gxr, gv, gf, bid, g.interior, key, step, -0.1, 0.7,
                kick, sim.dt, 0.3, 0.2, n, True),
            stacked("gx", "gx_ref", "gv", "gf", "bid"), (words, keys)),
    }
    recs = {}
    for name in names:
        call, batched, key = cases[name](K)
        plain = cases[name](R)[0]
        extra = (key[0],) if key else ()
        inplace = name == "extruder_springs"
        stencil = name in ("stencil_forces", "newton_half_forces")

        def fresh(args, inplace=inplace):
            # the forces a spring pass adds to: a copy for each check
            return (args[0], args[1].clone()) + args[2:] if inplace else args

        def one_run(r, call=call, batched=batched, key=key, fresh=fresh):
            return call(*fresh(tuple(t[r] for t in batched)),
                        *((key[1][r],) if key else ()))

        out = call(*fresh(batched), *extra)
        ref_out = plain(*fresh(batched), *extra)
        bitwise = all(torch.equal(a[r], b) for r in range(nrep)
                      for a, b in zip(out, one_run(r)))
        scratch = fresh(batched)
        fmax = float(ref_out[0].abs().max())
        err = float((out[0] - ref_out[0]).abs().max())
        tol = 0.0 if name == "kick_drift_halo" else F_REL * max(fmax, 1.0)
        ints_ok = (name not in ("stencil_forces", "newton_half_forces",
                                "langevin_kick_monitor")
                   or torch.equal(out[-1], ref_out[-1]))
        de = (out[1].double() - ref_out[1].double()).abs()
        e_ok = not stencil or bool(torch.all(
            de <= E_ABS + E_REL * ref_out[1].double().abs()))
        print(f"{name} at R={nrep} ({tuple(batched[0].shape)}): one launch "
              f"against {nrep} one-run launches bitwise {bitwise}; against "
              f"its plain version max_abs_err {err:.3g} (tol {tol:.3g}), "
              f"ints equal {ints_ok}"
              + (f", energies {out[1].tolist()} vs {ref_out[1].tolist()}"
                 if stencil else ""), flush=True)
        if not bitwise:
            fail(f"{name} at R={nrep} differs from its one-run launches")
        if not err <= tol or not ints_ok or not e_ok:
            fail(f"{name} at R={nrep} vs its plain version: {err} (tol "
                 f"{tol}), ints equal {ints_ok}, energies {e_ok}")
        bounds = [one_bound(name, run) for run in runs]
        recs[name] = dict(
            replaces=REPLACES[name], max_abs_err=err,
            tol=("bitwise" if tol == 0.0 else f"{F_REL}*max|f|={tol:.3g}")
            + f"; bitwise {nrep} one-run launches",
            bound=(sum(b[0] for b in bounds), bounds[0][1]),
            t=timings(lambda: call(*scratch, *extra), 20),
            t_one=timings(lambda: [call(*(t[r] for t in scratch), *(
                (key[1][r],) if key else ())) for r in range(nrep)], 20),
            t_plain=timings(lambda: plain(*scratch, *extra), 2, 1))
        if name == "kick_drift_halo":
            # its launch floor: an empty kernel at its launch shape
            cap, P = batched[0].shape[-2:]
            recs[name]["t_floor"] = timings(
                lambda: K.kick_drift_floor(cap, P, nrep), 50)
    return recs


def one_run_bound(sim, g):
    """``one_bound(name, fs)`` for batched_records: the bound of kernel
    ``name``'s one-run call on one replica's planes, as the one-run
    records count it (kernel_phases, stencil_phase)."""
    from lammps_le_torch.fast.consts import StencilConsts
    from lammps_le_torch.fast.maps import fast_maps

    system = sim.system
    maps = fast_maps(system)
    n, cap, P = system.n, maps.cap, maps.P

    def one_bound(name, fs):
        if name == "kick_drift_halo":
            return kick_drift_bound(cap, P, g.images)
        if name == "extruder_springs":
            act = int((fs.ex_left >= 0).sum())
            return bound(fs.exl_slot.shape[0] * 13 + act * 2 * 36, act * 36,
                         divs=act * 4)
        if name == "langevin_kick_monitor":
            return langevin_bound(fs.bid, g.interior, n)
        return stencil_bound(name, fs, g, maps, StencilConsts(system), n)

    return one_bound


def config6_replicas(sim, fs, dev):
    """Config 6's replicas: C6_REPLICAS replicas of the state ``fs`` (keys
    folded with SWEEP_SEED + i) for C6_REPLICA_STEPS steps of the batched
    non-reactive chain (``run_fast_replicas``, the Newton-half stencil) at
    the sweep's static cadence (``sweep_sim``), the launch counts zeroed
    just before and read just after; each replica healthy.  Returns (the
    replicas' FastState, the launches)."""
    import torch

    from lammps_le_torch.fast import (from_fast, kernels as K,
                                      run_fast_replicas, thermo_row_fast)
    from lammps_le_torch.state import FLAG_FENE_CLAMP

    state = from_fast(fs, sim.system)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    out = run_fast_replicas(sweep_sim(sim), state, C6_REPLICAS,
                            C6_REPLICA_STEPS, seed=SWEEP_SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    # to_fast evaluates the forces once more
    want = path_launches(launches, "newton_half_forces", C6_REPLICA_STEPS)
    want["newton_half_forces"] = want["extruder_springs"] = (
        C6_REPLICA_STEPS + 1)
    temps = thermo_row_fast(out, sim.system).temp.tolist()
    flags = out.flags.tolist()
    print(f"config 6 replicas R={C6_REPLICAS}: {C6_REPLICA_STEPS} steps "
          f"from the window's end in {wall:.3f} s (its to_fast included; "
          f"{card_line()}); T {temps}, flags {[hex(f) for f in flags]}, "
          f"rebuilds {out.n_rebuilds}; launches {launches}", flush=True)
    if launches != want or any(f & ~FLAG_FENE_CLAMP for f in flags) or not (
            all(0.5 < t < 2.0 for t in temps)
            and bool(torch.isfinite(out.gx).all())):
        fail(f"config 6 replicas: launches {launches} (want {want}), flags "
             f"{flags}, T {temps}")
    return out, launches


def print_kernel(path, name, r):
    print(f"kernel {name} on the {path} path: {r['launches']} launches; "
          f"device {r['t'][0]:.4f} ms ({r['t'][2]}; plain "
          f"{r['t_plain'][0]:.4f} ms, {r['t_plain'][2]}; bound "
          f"{r['bound'][0]:.4f} ms by {r['bound'][1]}"
          + (f"; library {r['t_lib'][0]:.4f} ms, {r['t_lib'][2]}"
             if "t_lib" in r else "")
          + (f"; IEEE reciprocal form {r['t_exact'][0]:.4f} ms, "
             f"{r['t_exact'][2]}" if "t_exact" in r else "")
          + (f"; its one-run launches on each replica {r['t_one'][0]:.4f} "
             f"ms, {r['t_one'][2]}" if "t_one" in r else "") + "); wall per "
          f"back-to-back call {r['t'][1]:.4f} ms (plain "
          f"{r['t_plain'][1]:.4f} ms); max_abs_err {r['max_abs_err']:.3g} "
          f"({r['tol']})", flush=True)


def path_launches(launches, stencil, steps=MEASURE, loops=0):
    """The launches a path's measured window must hold: ``steps`` of its
    stencil and of each kernel every path runs, none of the other
    stencils, and ``loops`` step-loop launches (the FastState's
    ``n_launches`` in the window; 0 on the chain).  In the step loop a
    kernel's count is the steps it executed."""
    stencils = ("stencil_forces", "newton_half_forces", "window_forces",
                "tiled_stencil_forces")
    # the split Langevin pass runs on the slab step only (slab_launches)
    slab = ("langevin_sums", "langevin_kick_parts")
    want = {k: 0 if k in stencils + slab else steps for k in launches}
    want[stencil] = steps
    want["step_loop"] = loops
    return want


def slab_launches(launches, steps, mesh, zero=False):
    """The launches a slab-resident window of ``steps`` on ``mesh`` must
    hold: per step K2a and the split Langevin pass once a slab (its sums
    pass with ``zero``), the slab stencil once a device, the springs once
    (on mesh[0]), nothing else."""
    sp = len(mesh)
    want = dict.fromkeys(launches, 0)
    want.update(kick_drift_halo=steps * sp, extruder_springs=steps,
                window_forces=steps * len(set(mesh)),
                langevin_kick_parts=steps * sp,
                langevin_sums=steps * sp if zero else 0)
    return want


def path_records(path, phases, launches):
    """[(path, kernel name, record)] with each record's launch count from
    that path's measured window."""
    out = []
    for name, r in phases.items():
        r["launches"] = launches[name]
        out.append((path, name, r))
    return out


# ---------------------------------------------------------------------------
# path 7: the general path


def general_system(n_chains, chain_len, generator="serpentine", n_types=4,
                   **kw):
    """configs.py:56-83 (_chain_system) on the port: a generated FENE melt
    (``fene_melt``) or a serpentine chain of 4 types without barriers,
    seed 12345; LJ 1.12 shifted, FENE (30, 1.5, 1, 1) + harmonic (10, 1.1)
    extruder bonds, f32; ``kw`` to system_from_data."""
    from lammps_le_torch.io.data import system_from_data
    from lammps_le_torch.scene import fene_melt, serpentine
    from lammps_le_torch.system import (BOND_FENE, BOND_HARMONIC,
                                        BondParams, PairLJCut)

    if generator == "melt":
        data = fene_melt(n_chains, chain_len, seed=12345,
                         n_atom_types=n_types, n_bond_types=2)
    else:
        data = serpentine(chain_len, seed=12345, n_atom_types=n_types,
                          n_bond_types=2, barrier_fraction=0.0)
    ones = np.ones((n_types, n_types))
    pair = PairLJCut(epsilon=ones, sigma=ones, cutoff=1.12 * ones,
                     shift=True)
    bonds = BondParams(
        style=np.array([BOND_FENE, BOND_HARMONIC]),
        coeffs=np.array([[30.0, 1.5, 1.0, 1.0], [10.0, 1.1, 0.0, 0.0]]))
    system, _ = system_from_data(data, pair=pair, bonds=bonds,
                                 dtype="float32", ex_btype=2, **kw)
    return system, data


def general_config(cfg, spec):
    """(system, data, Simulation, thermalizing Simulation or None, init
    seed) of config ``cfg`` (configs.py:86-197, 252-266)."""
    from lammps_le_torch.fixes import (NVE, ExLoad, ExUnload, Extrusion,
                                       Langevin)
    from lammps_le_torch.integrate import Simulation

    lan = (NVE(), Langevin(t_start=1.0, t_stop=1.0, damp=10.0, seed=904297))
    if cfg == 1:
        system, data = general_system(spec["chains"], spec["length"],
                                      generator="melt", n_types=1,
                                      rebuild_every=spec["rebuild_every"])
        return (system, data, Simulation(system=system, dt=spec["dt"],
                                         fixes=lan), None, 1)
    n = spec["length"]
    system, data = general_system(
        1, n, rebuild_every=spec["rebuild_every"], skin=0.25,
        max_extruders=max(64, n // 3),
        **({"cell_cap": spec["cell_cap"]} if "cell_cap" in spec else {}))
    le = dict(btype=2, neutral_type=1, ctcf_left=2, ctcf_right=3)
    load = dict(iatomtype=1, jatomtype=1, cutoff=1.12, btype=2,
                fraction=0.001, seed=684474, imaxbond=1, inewtype=1,
                jmaxbond=1, jnewtype=1)
    unload = dict(btype=2, cutoff=0.5, fraction=0.001, seed=456456)
    fixes = {
        2: (Extrusion(nevery=50, through_prob=1.0, **le),),
        3: (ExLoad(nevery=50, **load), ExUnload(nevery=50, **unload)),
        5: (Extrusion(nevery=100, through_prob=0.5, ctcf_left_right=4, **le),
            ExLoad(nevery=100, **load), ExUnload(nevery=100, **unload)),
    }[cfg]
    sim = Simulation(system=system, dt=spec["dt"], fixes=lan + fixes,
                     ex_btype=2)
    warm = Simulation(system=system, dt=0.003, ex_btype=2, fixes=(
        NVE(), Langevin(t_start=1.0, t_stop=1.0, damp=1.0, seed=7)))
    return system, data, sim, warm, 3


def sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def sync_all():
    """Wait for every card (a slab-resident run spans all of them)."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def state_on(state, dev):
    """A copy of a general-path State on ``dev``, without its neighbour
    structure (``run``'s setup builds it anew)."""
    import torch

    return dataclasses.replace(state, nbr=None, **{
        f.name: getattr(state, f.name).to(dev)
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


GEN_INTS = ("ex_left", "ex_right", "type", "img", "n_moves", "n_loads",
            "n_unloads", "last_event", "flags", "step")


def general_card_checks(sim, start, dev):
    """Config 2's GEN_CHECK_STEPS steps from the same warm state through
    ``run``: twice on the card, which must agree bit for bit (the
    fixed-order scatters), and on the CPU, whose integer fields must be
    the card's and positions within GEN_X_TOL."""
    import torch

    from lammps_le_torch.integrate import run

    outs = [run(sim, state_on(start, d), GEN_CHECK_STEPS)[0]
            for d in (dev, dev, "cpu")]
    a, b, c = outs
    same = all(torch.equal(getattr(a, k), getattr(b, k))
               for k in GEN_INTS + ("x", "v", "f", "epair", "ebond"))
    ints = all(torch.equal(getattr(a, k).cpu(), getattr(c, k))
               for k in GEN_INTS)
    dx = float((a.x.cpu() - c.x).abs().max())
    moves = int(a.n_moves) - int(start.n_moves)
    print(f"general path, config 2, {GEN_CHECK_STEPS} steps from the warm "
          f"state: card twice bitwise {same}; card vs CPU integer fields "
          f"equal {ints}, max|dx| {dx:.3g} (tolerance {GEN_X_TOL}); moves "
          f"{moves}", flush=True)
    if not (same and ints and dx < GEN_X_TOL and moves > 0):
        fail("general path: config 2's card checks")


def general_vs_fast(system, settled):
    """``setup`` of an NVE-only Simulation on path 1's settled state (the
    general path's grid: wrap, build_grid, the Newton-half
    grid_pair_force) against ``from_fast(to_fast(...))`` (the fast
    engine's full stencil K1): max|df| within F_REL_STENCILS x max|f|,
    energies within E_ABS + E_REL.  A bead past the bound must be
    explained as in ROADMAP Queue 3 item 1: a pair within f32 rounding of
    the LJ cut, whose force at the cut the two stencil forms apply to one
    bead or to both, and |df| at most those pairs' force at the cut."""
    import torch

    from lammps_le_torch.fast import from_fast, to_fast
    from lammps_le_torch.fixes import NVE
    from lammps_le_torch.integrate import Simulation, setup
    from lammps_le_torch.ops.cells import minimum_image

    sim = Simulation(system=system, dt=0.006, fixes=(NVE(),), ex_btype=2)
    g = setup(sim, settled)
    fast = from_fast(to_fast(settled, sim), system)
    scale = float(g.f.abs().max())
    df = (g.f - fast.f).abs().max(dim=1).values
    bound = F_REL_STENCILS * scale
    past = torch.nonzero(df > bound).flatten().tolist()
    rc = float(system.pair.cutoff[0, 0])
    r6 = rc ** -6
    f_cut = abs(r6 * (48.0 * r6 - 24.0) / rc)
    unexplained = []
    for i in past:
        d = minimum_image(g.x - g.x[i], system.box_size)
        rsq = (d * d).sum(1)
        near = int(((rsq - rc * rc).abs() < 1e-5 * rc * rc).sum())
        if near == 0 or float(df[i]) > near * f_cut * 1.01 + bound:
            unexplained.append((i, float(df[i]), near))
    de = [abs(float(g.epair) - float(fast.epair)),
          abs(float(g.ebond) - float(fast.ebond))]
    etol = [E_ABS + E_REL * abs(float(fast.epair)),
            E_ABS + E_REL * abs(float(fast.ebond))]
    print(f"general path setup vs the fast engine on path 1's settled "
          f"state ({system.n} beads): max|df| {float(df.max()):.4g} "
          f"({float(df.max()) / scale:.3g} of max|f| {scale:.4g}; bound "
          f"{F_REL_STENCILS} of it); {len(past)} beads past it, "
          f"{len(past) - len(unexplained)} explained by pairs at the LJ cut "
          f"(force there {f_cut:.4g}); |de| pair {de[0]:.4g} bond "
          f"{de[1]:.4g}; flags {int(g.flags):#x} / {int(fast.flags):#x}",
          flush=True)
    if unexplained or de[0] > etol[0] or de[1] > etol[1]:
        fail(f"general path setup vs fast engine: unexplained "
             f"{unexplained[:5]}, |de| {de} (tolerance {etol})")


def general_profile(sim, state, steps, card):
    """``steps`` more steps of a general-path run under torch.profiler:
    the device busy share, the top kernels and the top operations by
    device time.  Returns the device ms a step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lammps_le_torch.integrate import make_step

    step = make_step(sim, device=state.x.device)
    s0 = int(state.step)
    words = tuple(state.key.tolist())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            state = step(state, s0 + i, words)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = prof.key_averages()
    kern = [e for e in evs if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    print(f"general path profile ({card}): {steps} config-5 steps in "
          f"{wall * 1e3:.1f} ms under the profiler, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}%), "
          f"{sum(e.count for e in kern) / steps:.0f} kernels a step",
          flush=True)
    print("  top kernels by device time:", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / steps:9.2f} us/step  "
              f"{e.count:6d}x  {e.key[:70]}", flush=True)
    ops = [e for e in evs if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    print("  top operations by device time:", flush=True)
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / steps:9.2f} us/step  "
              f"{e.count:6d}x  {e.key[:70]}", flush=True)
    return busy_us / steps / 1e3


def general_syncs(sim, state, steps, card):
    """Host syncs a step of ``steps`` general-path steps (PyTorch's sync
    debug mode warns at each operation that waits for the card)."""
    import warnings

    import torch

    from lammps_le_torch.integrate import make_step

    step = make_step(sim, device=state.x.device)
    s0 = int(state.step)
    words = tuple(state.key.tolist())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in range(1, steps + 1):
                state = step(state, s0 + i, words)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    where = sorted({f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
                    for w in caught})
    print(f"general path host syncs ({card}): {len(caught)} in {steps} "
          f"config-5 steps, {len(caught) / steps:.4f} a step; at {where}",
          flush=True)
    return len(caught)


def fast_witness(cfg, sim, start, steps, sps, card):
    """The fast engine (``run_fast``) on the same Simulation from the same
    warm state for the same steps: its wall time against the general
    path's and its T, the witness of the general path's.  Returns T."""
    import torch

    from lammps_le_torch.fast import run_fast
    from lammps_le_torch.integrate import thermo_row

    sync(start.x.device)
    t0 = time.perf_counter()
    fast, _ = run_fast(sim, start, steps)
    sync(start.x.device)
    wall = time.perf_counter() - t0
    t_fast = float(thermo_row(fast, sim.system).temp)
    print(f"general path config {cfg}: the fast engine from the same warm "
          f"state, {steps} steps in {wall:.3f} s, {steps / wall:.2f} "
          f"steps/s with its set-up (the general path's {sps:.2f} steps/s "
          f"is {sps * wall / steps:.4f}x that); T {t_fast:.4f}, flags "
          f"{int(fast.flags):#x}, moves {int(fast.n_moves)} ({card})",
          flush=True)
    return t_fast


def general_path(dev, card, profile_steps=0, specs=None):
    """Path 7: configs 1, 2, 3 and 5 through ``integrate.run`` as
    configs.py runs them (thermalize on a warm Simulation, seeded
    extruders, a warm-up run, the measured run), each printed and held
    healthy (finite; no error-class flag; T in (0.5, 2.0) or within 5% of
    the fast engine's from the same warm state, which config 5 always
    runs (its extruders heat it past 2); a move in configs 2 and 5;
    config 1, which configs.py starts far from equilibrium, only finite
    with no NON_FINITE flag); config 2's card checks; config 5's profile
    and host syncs.  Returns {config name: steps/s}."""
    import torch

    from lammps_le_torch.integrate import run, thermo_row
    from lammps_le_torch.state import (FLAG_FENE_CLAMP, FLAG_NON_FINITE,
                                       init_state)

    on_card = torch.device(dev).type == "cuda"
    out = {}
    for cfg, spec in (specs or GENERAL).items():
        t0 = time.perf_counter()
        system, data, sim, warm, seed = general_config(cfg, spec)
        state = init_state(system, data.x, types=data.types, seed=seed,
                           device=dev)
        if warm is not None:
            state, _ = run(warm, state, spec["thermalize"])
            n = system.n
            state = seed_extruders(state, spec["n_ex"],
                                   max(4, n // spec["n_ex"]),
                                   system.max_extruders, reset_step=False)
        state, _ = run(sim, state, spec["warm"])
        sync(dev)
        set_up = time.perf_counter() - t0
        start = state
        t0 = time.perf_counter()
        state, _ = run(sim, state, spec["measure"])
        sync(dev)
        wall = time.perf_counter() - t0
        row = thermo_row(state, system)
        temp, flags = float(row.temp), int(state.flags)
        moves = int(state.n_moves)
        sps = spec["measure"] / wall
        nb = system.neighbor
        print(f"general path config {cfg} ({spec['name']}, {system.n} beads, "
              f"grid {nb.nx}x{nb.ny}x{nb.nz} cap {nb.cell_cap}, rebuild "
              f"every {nb.rebuild_every}; {card}): {spec['measure']} steps "
              f"in {wall:.3f} s, {sps:.2f} steps/s, {sps * system.n:.4g} "
              f"bead*steps/s; flags {flags:#x}; moves {moves}, loads "
              f"{int(state.n_loads)}, unloads {int(state.n_unloads)}; T "
              f"{temp:.4f}; extruders {int(row.n_extruders)}; set-up "
              f"{set_up:.1f} s", flush=True)
        finite = bool(torch.isfinite(state.x).all()
                      and torch.isfinite(state.v).all())
        if cfg == 1:
            # configs.py's generated melt starts from overlapping random
            # walks with no push-off and heats far past T 2, with cell
            # overflow and skin flags, in the reference too: held finite
            # with no NON_FINITE flag, its T and flags printed
            if not finite or flags & FLAG_NON_FINITE:
                fail(f"general path config 1: non-finite state, flags "
                     f"{flags:#x}")
        else:
            t_fast = None
            if cfg == 5 or not 0.5 < temp < 2.0:
                t_fast = fast_witness(cfg, sim, start, spec["measure"], sps,
                                      card)
            # T outside (0.5, 2.0) is the configuration's own heating when
            # the fast engine from the same warm state gets there too
            t_ok = 0.5 < temp < 2.0 or (
                t_fast is not None and abs(temp - t_fast) <= 0.05 * t_fast)
            if (not finite or flags & ~FLAG_FENE_CLAMP or not t_ok
                    or (cfg in (2, 5) and moves == 0)):
                fail(f"general path config {cfg} unhealthy: flags "
                     f"{flags:#x}, T {temp} (fast engine {t_fast}), moves "
                     f"{moves}")
        out[spec["name"]] = sps
        if cfg == 2:
            general_card_checks(sim, start, dev)
            if on_card:
                # path 10's general-path piece: replicas over a mesh
                general_replicas(sim, start, dev)
        if cfg == 5 and on_card:
            dev_ms = general_profile(sim, state,
                                     max(profile_steps, GEN_PROFILE_STEPS),
                                     card)
            print(f"general path config 5: device busy at the measured rate"
                  f" {dev_ms:.4f} ms a step x {sps:.2f} steps/s = "
                  f"{100 * dev_ms * sps / 1e3:.1f}% ({card})", flush=True)
            if general_syncs(sim, state, SYNC_STEPS, card):
                fail("general path: host syncs between thermo rows")
        del state, start
        if on_card:
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# path 8: the deck front end (deck/, python -m lammps_le_torch)


def deck_dir(n, seed, barrier, name, jitter=0.0):
    """A temporary directory holding ``scene.serpentine(n, ...)``'s data
    file (4 atom types, 2 bond types) as ``name``, written by the port's
    ``write_data``; with ``jitter`` each coordinate moved by a seeded
    normal draw of that scale."""
    import os
    import tempfile

    from lammps_le_torch.io.data import write_data
    from lammps_le_torch.scene import serpentine

    td = tempfile.mkdtemp(prefix="chip_smoke_deck_")
    data = serpentine(n, seed=seed, n_atom_types=4, n_bond_types=2,
                      barrier_fraction=barrier)
    if jitter:
        data.x = data.x + np.random.default_rng(0).normal(
            scale=jitter, size=data.x.shape)
    write_data(os.path.join(td, name), data)
    return td


def write_deck(td, name, text):
    import os

    path = os.path.join(td, name)
    with open(path, "w") as fh:
        fh.write(text)
    return path


class FastCapture:
    """Within the block, the FastState of the fast engine's last run: the
    state ``run_fast`` hands to ``from_fast``, which the deck runner never
    sees (its clamps, planes and launches)."""

    def __enter__(self):
        from lammps_le_torch.fast import engine

        self.engine, self.orig, self.fs = engine, engine.from_fast, None

        def capture(fs, system, replica_index=None):
            self.fs = fs
            return self.orig(fs, system, replica_index)

        engine.from_fast = capture
        return self

    def __exit__(self, *exc):
        self.engine.from_fast = self.orig


def deck_runner(dtype, dev, logged):
    """A DeckRunner on ``dev`` whose log lines go to ``logged``."""
    from lammps_le_torch.deck import DeckRunner

    r = DeckRunner(dtype=dtype, quiet=True, device=dev)
    r.log = logged.append
    return r


def config4_path(dev, card, profile_steps):
    """Config 4 (configs.py:199-249, the README's deck) through the deck
    front end on the card: ``run 300``, then the measured ``run 2000``
    with the launch counts zeroed just before it and read just after.  It
    must take K2's step loop and end healthy (error-class flags 0, FENE
    clamps <= 20 x moves, T in (0.5, 2.0), or within 5% of the same deck
    on the general path); every kernel of the path launches once a step
    (the stencil and the springs once more in the run's set-up).
    Then K1, K2a, K2c and K2d+e on the run's final planes against their
    plain versions.  Returns (records, steps/s)."""
    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.fast import thermo_row_fast
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.fast.place import GridConsts
    from lammps_le_torch.state import FLAG_FENE_CLAMP

    td = deck_dir(C4["beads"], 5, 0.01, "data.le")
    path = write_deck(td, "in.le", CONFIG4_DECK)
    logged = []
    r = deck_runner("float32", dev, logged)
    t0 = time.perf_counter()
    r.run_file(path)
    warm_wall = time.perf_counter() - t0
    K.reset_launches()
    with FastCapture() as cap:
        r.command("run", [str(C4["measure"])])
    launches = dict(K.LAUNCHES)
    fs = cap.fs
    perf = dict(r.last_perf)
    engines = [m for m in logged if m.startswith("Engine:")]
    for m in logged:
        print(f"config 4 deck: {m}", flush=True)
    if len(engines) != 2 or not all("K2 step loop" in m for m in engines):
        fail(f"config 4's runs did not take K2's step loop: {engines}")
    system, sim = r.system, r.sim
    row = thermo_row_fast(fs, system)
    temp, flags = float(row.temp), int(fs.flags)
    moves, clamps = int(fs.n_moves), int(fs.n_clamps)
    n_ex = int((fs.ex_left >= 0).sum())
    sps = perf["steps_per_s"]
    print(f"config 4 ({system.n} beads, dtype float32, {card}): last_perf "
          f"{perf}; {sps:.2f} steps/s, {perf['bead_steps_per_s']:.4g} "
          f"bead*steps/s over the measured run {C4['measure']} (loop time "
          f"with its set-up, thermo rows and pressure); run 300 with its "
          f"set-up and the kernels' first launch {warm_wall:.2f} s; T "
          f"{temp:.4f}; extruders {n_ex}; moves {moves}, loads "
          f"{int(fs.n_loads)}, unloads {int(fs.n_unloads)}; clamps "
          f"{clamps}; flags {flags:#x}; {fs.n_launches} step-loop launches",
          flush=True)
    want = path_launches(launches, "stencil_forces", C4["measure"],
                         loops=fs.n_launches)
    # the run's set-up (to_fast) evaluates the forces once: the stencil
    # and the springs on the chain
    want["stencil_forces"] += 1
    want["extruder_springs"] += 1
    print(f"config 4 launches in the measured run: {launches}", flush=True)
    if launches != want:
        fail(f"config 4 kernel launches {launches}, want {want}")
    x_fin = bool(torch.isfinite(fs.gx).all() and torch.isfinite(fs.gv).all())
    t_gen = None
    if not 0.5 < temp < 2.0:
        t_gen = config4_general(td, path, dev, card)
    t_ok = 0.5 < temp < 2.0 or (t_gen is not None
                                and abs(temp - t_gen) <= 0.05 * t_gen)
    if (not x_fin or flags & ~FLAG_FENE_CLAMP or not t_ok
            or clamps > 20 * max(moves, 1)):
        fail(f"config 4 unhealthy: finite {x_fin}, flags {flags:#x}, T "
             f"{temp} (general path {t_gen}), clamps {clamps} for {moves} "
             f"moves")
    if profile_steps:
        deck_profile(r, profile_steps, sps, card)
    g = GridConsts.build(system, fast_maps(system), dev)
    phases = dict(stencil_forces=stencil_phase(fs, sim, g, "config 4"),
                  **kernel_phases(fs, sim, g))
    del fs, r
    torch.cuda.empty_cache()
    return path_records("config4", phases, launches), sps


def config4_general(td, path, dev, card):
    """Config 4's deck anew on the general path (``LLE_FAST=0``) on the
    card: its T at the end, the witness of a run that heats past 2."""
    import os

    os.environ["LLE_FAST"] = "0"
    try:
        logged = []
        r = deck_runner("float32", dev, logged)
        r.run_file(path)
        r.command("run", [str(C4["measure"])])
    finally:
        os.environ.pop("LLE_FAST", None)
    from lammps_le_torch.integrate import thermo_row

    temp = float(thermo_row(r.state, r.system).temp)
    print(f"config 4 on the general path ({card}): {logged[-4:]}; T "
          f"{temp:.4f}, flags {int(r.state.flags):#x}", flush=True)
    return temp


def deck_profile(r, steps, sps, card):
    """``steps`` more steps of the deck's run under torch.profiler: the
    device busy share at the measured rate and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r.command("run", [str(steps)])
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / steps / 1e3
    print(f"config 4 profile ({card}): {steps} steps, device {dev_ms:.4f} "
          f"ms a step; busy at the measured rate {dev_ms:.4f} x {sps:.2f} "
          f"steps/s = {100 * dev_ms * sps / 1e3:.1f}%", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / steps:9.2f} us/step  "
              f"{e.count:6d}x  {e.key[:70]}", flush=True)


def cli_phase(card):
    """``python -m lammps_le_torch -in in.tiny -log log.txt`` in a
    subprocess, no ``-platform`` (the card): exit 0, the log's thermo
    header, rows, Engine line and loop time, the xyz dump's frames, and
    the data file it writes reading back with 300 atoms."""
    import os
    import subprocess

    from lammps_le_torch.io.data import read_data

    td = deck_dir(300, 7, 0.02, "data.tiny")
    deck = TINY_DECK.replace("run 40", "dump d1 all xyz 20 traj.xyz\nrun 40")
    path = write_deck(td, "in.tiny", deck)
    log = os.path.join(td, "log.txt")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "lammps_le_torch", "-in", path, "-log", log],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    wall = time.perf_counter() - t0
    text = open(log).read() if os.path.exists(log) else ""
    rows = [ln for ln in text.splitlines()
            if ln.split() and ln.split()[0].isdigit()]
    traj = open(os.path.join(td, "traj.xyz")).read().splitlines() \
        if os.path.exists(os.path.join(td, "traj.xyz")) else []
    frames = sum(1 for ln in traj if ln.startswith("Atoms. Timestep:"))
    n_out = (read_data(os.path.join(td, "out.data")).n_atoms
             if os.path.exists(os.path.join(td, "out.data")) else 0)
    engines = [ln for ln in text.splitlines() if ln.startswith("Engine:")]
    print(f"CLI ({card}): exit {res.returncode} in {wall:.1f} s; {len(rows)} "
          f"thermo rows; {engines}; {frames} xyz frames; out.data "
          f"{n_out} atoms", flush=True)
    if res.returncode != 0:
        print(res.stderr[-3000:], flush=True)
    if (res.returncode != 0 or "Step" not in text or "Loop time" not in text
            or len(rows) < 5 or len(engines) != 2 or frames != 2
            or n_out != 300):
        fail("python -m lammps_le_torch on the card")


def restart_phase(dev):
    """The 300-bead deck on the card (K2's step loop), then a fresh runner
    resumed from its ``write_restart`` checkpoint at step 40 for 20 more
    steps: bit for bit the uninterrupted run."""
    import torch

    td = deck_dir(300, 7, 0.02, "data.tiny")
    path = write_deck(td, "in.tiny", TINY_DECK)
    logged = []
    a = deck_runner("float32", dev, logged)
    a.run_file(path)
    b = deck_runner("float32", dev, [])
    b.root = td
    for line in TINY_DECK.strip().splitlines():
        parts = line.split()
        if parts[0] not in ("run", "write_data", "write_restart",
                            "velocity"):
            b.command(parts[0], parts[1:])
    b.command("read_restart", ["out.ckpt.npz"])
    step0 = int(b.state.step)
    b.command("run", ["20"])
    fields = ("x", "v", "img", "type", "ex_left", "ex_right", "step",
              "flags", "n_moves", "n_loads", "n_unloads", "last_event")
    same = {k: torch.equal(getattr(a.state, k), getattr(b.state, k))
            for k in fields}
    print(f"restart on the card: {[m for m in logged if m.startswith('Engine')]}"
          f"; resumed at step {step0}, ends at {int(b.state.step)}; bitwise "
          f"{same}; loads {int(a.state.n_loads)}, moves "
          f"{int(a.state.n_moves)}", flush=True)
    if step0 != 40 or not all(same.values()):
        fail("the resumed deck differs from the uninterrupted run")


def card_vs_cpu_phase(dev):
    """The 300-bead deck with ``LLE_FAST=0`` (the general path) in f64 on
    the card and on the CPU: integer fields equal, max|dx| printed and
    within DECK_X_TOL after its 60 steps."""
    import os

    import torch

    td = deck_dir(300, 7, 0.02, "data.tiny")
    path = write_deck(td, "in.tiny", TINY_DECK)
    os.environ["LLE_FAST"] = "0"
    try:
        runs = []
        for d in (dev, "cpu"):
            logged = []
            r = deck_runner("float64", d, logged)
            r.run_file(path)
            runs.append((r, logged))
    finally:
        os.environ.pop("LLE_FAST", None)
    (a, la), (c, lc) = runs
    ints = ("img", "type", "ex_left", "ex_right", "step", "flags",
            "n_moves", "n_loads", "n_unloads", "last_event")
    same = {k: torch.equal(getattr(a.state, k).cpu(), getattr(c.state, k))
            for k in ints}
    dx = float((a.state.x.cpu() - c.state.x).abs().max())
    engines = {m for m in la + lc if m.startswith("Engine:")}
    print(f"deck card vs CPU (LLE_FAST=0, f64): {sorted(engines)}; integer "
          f"fields equal {same}; max|dx| {dx:.3g} (tol {DECK_X_TOL}) after "
          f"{int(a.state.step)} steps; loads {int(a.state.n_loads)}",
          flush=True)
    if not all(same.values()) or not dx <= DECK_X_TOL or len(engines) != 1 \
            or "Engine: general (LLE_FAST=0)" not in engines:
        fail("the deck on the card and on the CPU differ")


def minimize_phase(dev):
    """A ``minimize`` deck per style (fire, cg) on the jittered 300-bead
    data in f64 on the card and on the CPU: the same iteration count and
    max|F| (as the log prints it, six digits)."""
    td = deck_dir(300, 7, 0.02, "min.data", jitter=0.1)
    for style, args in MIN_RUNS:
        deck = MIN_DECK + f"min_style {style}\nminimize {args}\n"
        path = write_deck(td, f"in.min_{style}", deck)
        out = []
        for d in (dev, "cpu"):
            logged = []
            t0 = time.perf_counter()
            deck_runner("float64", d, logged).run_file(path)
            line = next(m for m in logged if m.startswith("Minimization"))
            it = int(line.split(":")[1].split()[0])
            fmax = float(line.rsplit("=", 1)[1])
            out.append((it, fmax, time.perf_counter() - t0))
        (it_a, f_a, w_a), (it_c, f_c, w_c) = out
        print(f"minimize {style} ({args}): card {it_a} iterations, max|F| "
              f"{f_a:.6g}, {w_a:.2f} s; CPU {it_c} iterations, max|F| "
              f"{f_c:.6g}, {w_c:.2f} s", flush=True)
        if it_a != it_c or f_a != f_c or it_a < 2:
            fail(f"minimize {style} on the card differs from the CPU")


def contract_phase(dev, card, sim5, start, groups):
    """The port's public contract on the card, the reference's calls:
    path 5's ``to_fast(state, sim, groups)`` positionally against its
    keyword form (bitwise); config 4's deck with its extrusion, ex_load
    and ex_unload fixes on a named group of every bead through
    ``DeckRunner``, ``run 300`` and then its measured ``run 2000`` (where
    the LE fixes load and move extruders), which must take K2's step loop
    and end each run bitwise the ungrouped deck (positions, velocities,
    extruder tables, counters);
    and config 5's ``run`` called with the reference's nine positional
    arguments (thermo every 5, ``max_segment`` 3, a boundary callback
    every 4) against its keyword call: the same rows, callback steps and
    final State, bitwise.  Returns the phase's wall seconds."""
    import torch

    from lammps_le_torch.fast import to_fast
    from lammps_le_torch.integrate import run
    from lammps_le_torch.state import init_state

    t0 = time.perf_counter()
    a = to_fast(start, sim5, groups)
    b = to_fast(start, sim5, groups=groups)
    differ = same_state(a, b)
    print(f"contract: path 5's to_fast(state, sim, groups) against "
          f"groups=: {len(differ)} fields differ {differ}; group plane "
          f"sum {float(a.lgm.sum()):.0f}", flush=True)
    if differ or a.lgm is None:
        fail(f"contract: positional to_fast differs in {differ}")
    del a, b

    td = deck_dir(C4["beads"], 5, 0.01, "data.le")
    ends = {}
    for label, deck in (("ungrouped", CONFIG4_DECK), ("grouped", (
            CONFIG4_DECK.replace(
                "read_data data.le\n",
                f"read_data data.le\ngroup chain id 1:{C4['beads']}\n")
            .replace("fix loop all ", "fix loop chain ")
            .replace("fix loading all ", "fix loading chain ")
            .replace("fix unloading all ", "fix unloading chain ")))):
        logged = []
        r = deck_runner("float32", dev, logged)
        r.run_file(write_deck(td, f"in.{label}", deck))
        ends[label] = [r.state]
        r.command("run", [str(C4["measure"])])
        ends[label].append(r.state)
        engine = [m for m in logged if m.startswith("Engine:")]
        print(f"contract: config 4 deck {label}: {engine}", flush=True)
        if len(engine) != 2 or not all("K2 step loop" in m for m in engine):
            fail(f"contract: config 4 {label} did not take K2's step loop: "
                 f"{engine}")
        del r
    for a, b in zip(ends["ungrouped"], ends["grouped"]):
        same = all(torch.equal(getattr(a, k), getattr(b, k)) for k in (
            "x", "v", "ex_left", "ex_right", "step", "n_moves", "n_loads",
            "n_unloads", "flags"))
        print(f"contract: grouped config 4 ends bitwise the ungrouped at "
              f"step {int(a.step)}: {same} (moves {int(a.n_moves)}, loads "
              f"{int(a.n_loads)}, unloads {int(a.n_unloads)}, extruders "
              f"{int((a.ex_left >= 0).sum())})", flush=True)
        if not same:
            fail("contract: the grouped config 4 deck ended elsewhere")
    if int(a.n_moves) == 0 or int(a.n_loads) == 0:
        fail("contract: config 4's LE fixes did not act in its runs")
    del ends

    spec = GENERAL[5]
    system, data, sim, _, seed = general_config(5, spec)
    outs = []
    for positional in (True, False):
        state = init_state(system, data.x, types=data.types, seed=seed,
                           device=dev)
        rows, bounds = [], []

        def on_row(row, st):
            rows.append(row)

        def on_boundary(st):
            bounds.append(int(st.step))

        if positional:
            st, ret = run(sim, state, CONTRACT_STEPS, None, 5, on_row, 3, 4,
                          on_boundary)
        else:
            st, ret = run(sim, state, CONTRACT_STEPS, thermo_every=5,
                          thermo_callback=on_row, boundary_every=4,
                          boundary_callback=on_boundary)
        outs.append((st, ret, rows, bounds))
    (sa, ra, ca, ba), (sb, rb, cb, bb) = outs
    bitwise = all(torch.equal(getattr(sa, k), getattr(sb, k)) for k in (
        "x", "v", "f", "ex_left", "ex_right", "step", "flags"))
    print(f"contract: config 5's run with the reference's positional "
          f"arguments (max_segment 3) against the keyword call: rows "
          f"{[r.step for r in ra]} equal {ra == rb and ca == cb}, "
          f"callbacks at {ba} equal {ba == bb}, final State bitwise "
          f"{bitwise}; T {ra[-1].temp:.6f}", flush=True)
    if not (ra == rb and ca == cb and ba == bb and bitwise
            and len(ra) == 4 and ba == [0, 4, 8, 12]):
        fail("contract: the positional run differs from the keyword call")
    wall = time.perf_counter() - t0
    print(f"contract phase ({card}): {wall:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return wall


def deck_path(dev, card, profile_steps=0):
    """Path 8: config 4 through the deck runner, the CLI, restart, card
    against CPU and minimize.  Returns (records, config 4 steps/s)."""
    recs, sps = config4_path(dev, card, profile_steps)
    cli_phase(card)
    restart_phase(dev)
    card_vs_cpu_phase(dev)
    minimize_phase(dev)
    return recs, sps


# path 9: the observers and the native restart (observe/, io/lammps_restart)


def obs_deck(base, n, coord, every):
    """``base`` (a deck up to its first run) with path 9's observer
    commands in place of its thermo line."""
    head, _ = base.split("\nthermo ", 1)
    tail = base.split("\ntimestep ", 1)[1]
    return (head + OBS_CMDS.format(half=n // 2, half1=n // 2 + 1, n=n,
                                   coord=coord, every=every)
            + "timestep " + tail)


def observer_checks(label, r, st, tol, card, timed=False):
    """Each observer of path 9 on ``st`` (on the card) against the same
    observer on a CPU copy: pe/atom, stress/atom (within ``tol`` x max(1,
    max|value|), the largest difference printed), coord/atom, the rdf's
    counts and flags and the contact map's (bit for bit), group/group and
    the pair/local table (host arithmetic on the same positions: equal).
    With ``timed``, each call's device ms (``timings``) or, for the host
    observers, wall ms.  Returns {observer: ms}."""
    import torch

    from lammps_le_torch.observe import (make_contact_fn, make_coord_atom_fn,
                                         make_peratom_pe_fn, make_rdf_fn,
                                         make_stress_atom_fn)

    system = r.system
    ex = r._ex_btype()
    cpu = state_on(st, "cpu")
    coord = r.computes["co"]["cutoff"]
    fns = {
        "pe/atom": make_peratom_pe_fn(system, ex),
        "stress/atom": make_stress_atom_fn(system, ex),
        "coord/atom": make_coord_atom_fn(system, coord),
        "rdf": (lambda f: lambda s: f(s, torch.zeros(
            50, dtype=torch.float32, device=s.x.device)))(
                make_rdf_fn(system, 50, 2.5)),
        "contact_map": (lambda f: lambda s: f(s, torch.zeros(
            (256, 256), dtype=torch.float32, device=s.x.device)))(
                make_contact_fn(system, 2.0, 256)),
    }
    host = {
        "group/group": lambda s: r._compute_value("gg", s),
        "pair/local": lambda s: r._pair_local_table(
            ["dist", "eng", "force"], "all", s),
    }
    ms = {}
    for name, fn in fns.items():
        got, want = fn(st), fn(cpu)
        if isinstance(got, tuple):
            (got, gfl), (want, wfl) = got, want
            same = torch.equal(got.cpu(), want) and int(gfl) == int(wfl)
            print(f"{label} {name} card vs CPU: counts bitwise {same}, "
                  f"total {float(got.sum()):.0f}, flags {int(gfl):#x}",
                  flush=True)
            if not same:
                fail(f"{label} {name} differs on the card")
        elif name == "coord/atom":
            same = torch.equal(got.cpu(), want)
            print(f"{label} {name} card vs CPU: bitwise {same}, max "
                  f"{float(got.max()):.0f}, mean {float(got.mean()):.4f}",
                  flush=True)
            if not same:
                fail(f"{label} {name} differs on the card")
        else:
            d = float((got.cpu() - want).abs().max())
            lim = tol * max(1.0, float(want.abs().max()))
            print(f"{label} {name} card vs CPU: max|d| {d:.3g} (tol "
                  f"{lim:.3g}), sum {float(got.double().sum()):.6g}",
                  flush=True)
            if not d <= lim:
                fail(f"{label} {name} card vs CPU {d} > {lim}")
        if timed:
            ms[name] = timings(lambda f=fn: f(st), 5, 1)[0]
    for name, fn in host.items():
        got, want = fn(st), fn(cpu)
        same = bool(np.array_equal(np.asarray(got), np.asarray(want)))
        rows = np.asarray(got).shape[0] if np.ndim(got) else got
        print(f"{label} {name} card vs CPU state: equal {same} ({rows})",
              flush=True)
        if not same:
            fail(f"{label} {name} differs between the card's and the "
                 f"CPU's state")
        if timed:
            t0 = time.perf_counter()
            fn(st)
            ms[name] = (time.perf_counter() - t0) * 1e3
    return ms


def native_restart_check(label, r, deck_head, dev):
    """``write_restart`` of the runner's state to a native file, then a
    fresh runner on ``dev`` with ``deck_head`` (the deck's set-up) and
    ``read_restart`` of it: the positions, velocities, images, types and
    step it builds equal the file's fields (in the state's float type)
    bit for bit, and its velocities, types, live extruder pairs and step
    the written state's.  The writer folds a wrap into the image (LAMMPS's
    read_restart needs every atom inside the box), so which beads it
    wrapped is taken from the written state: its shift floor((x - lo) /
    L).  Every bead's image read back is the written image plus that
    shift, and its unwrapped position x + img L within the state type's
    rounding (eps |x| + 4 f64 eps (|x| + (|img| + 1) L)) of the written
    one; a bead the writer did not wrap has the written x bit for bit."""
    import os

    import torch

    from lammps_le_torch.io.lammps_restart import read_lammps_restart

    st = r.state
    r.command("write_restart", ["obs.restart"])
    path = os.path.join(r.root, "obs.restart")
    f = read_lammps_restart(path)
    back = deck_runner("float64" if st.x.dtype == torch.float64
                       else "float32", dev, [])
    back.root = r.root
    for line in deck_head.strip().splitlines():
        parts = line.split()
        if parts[0] == "read_data":
            parts = ["read_restart", "obs.restart"]
        if parts[0] not in ("run", "velocity", "dump", "write_restart"):
            back.command(parts[0], parts[1:])
    back._build()
    b = back.state

    def field(a):
        return torch.as_tensor(a).to(b.x.dtype)

    lo = torch.as_tensor(np.asarray(r.system.box_lo, np.float64))
    box = torch.as_tensor(np.asarray(r.system.box_hi, np.float64)) - lo
    sx, bx = st.x.cpu().double(), b.x.cpu().double()
    simg, bimg = st.img.cpu().long(), b.img.cpu().long()
    shift = torch.floor((sx - lo) / box).long()
    wrapped = (shift != 0).any(dim=1)
    gap = ((bx + bimg * box) - (sx + simg * box)).abs()
    tol = (torch.finfo(st.x.dtype).eps * bx.abs() + 4 * 2.0 ** -52
           * (sx.abs() + (simg.abs() + 1) * box))
    checks = {
        "x": torch.equal(b.x.cpu(), field(f.x)),
        "v": torch.equal(b.v.cpu(), field(f.v)),
        "img": torch.equal(bimg, torch.as_tensor(f.img).long()),
        "type": torch.equal(b.type.cpu(), torch.as_tensor(f.types)),
        "step": int(b.step) == int(st.step) == f.step,
        "v written": torch.equal(b.v, st.v),
        "type written": torch.equal(b.type, st.type),
        "img written + shift": torch.equal(bimg, simg + shift),
        "unwrapped x written": bool((gap <= tol).all()),
        "x written where not wrapped": torch.equal(
            b.x.cpu()[~wrapped], st.x.cpu()[~wrapped]),
    }
    pairs = [sorted(zip(t.ex_left[t.ex_left >= 0].tolist(),
                        t.ex_right[t.ex_left >= 0].tolist()))
             for t in (st, b)]
    checks["extruders"] = pairs[0] == pairs[1]
    print(f"{label} native restart ({os.path.getsize(path)} B, step "
          f"{f.step}, {len(pairs[0])} extruders, {int(wrapped.sum())} "
          f"beads outside the box wrapped by the writer, unwrapped max|d| "
          f"{float(gap.max()):.3g}): read back {checks}", flush=True)
    if not all(checks.values()):
        fail(f"{label}: the native restart read back differs")


def observer_path(dev, card):
    """Path 9: config 4's deck (path 8's) with the observers (pe/atom,
    stress/atom, coord/atom through dump custom and compute reduce; rdf
    past the cell size through fix ave/time in vector mode; group/group
    between the chain's halves; pair/local through dump local) every 500
    steps: ``run 300``, then the measured ``run 2000`` with the launch
    counts zeroed just before it and read just after (K2's step loop;
    each of its kernels launched), healthy; each observer's device time
    on the final state, each held against a CPU copy
    (``observer_checks``), ``contact_map_accumulate`` and ``profile()``;
    ``write_restart`` to a native file read back by a fresh runner
    (``native_restart_check``).  Then the 300-bead deck with the same
    observers in f64 (general path, 40 steps) on the card against a CPU
    copy within 1e-10, and its native restart.  Returns steps/s."""
    import os

    import torch

    from lammps_le_torch.fast import kernels as K
    from lammps_le_torch.integrate import thermo_row
    from lammps_le_torch.observe import contact_map_accumulate, profile
    from lammps_le_torch.state import FLAG_FENE_CLAMP

    td = deck_dir(C4["beads"], 5, 0.01, "data.le")
    deck = obs_deck(CONFIG4_DECK, C4["beads"], 1.5, OBS_EVERY)
    path = write_deck(td, "in.obs", deck)
    logged = []
    r = deck_runner("float32", dev, logged)
    r.root = td
    r.run_file(path)
    K.reset_launches()
    with FastCapture() as cap:
        r.command("run", [str(C4["measure"])])
    launches = dict(K.LAUNCHES)
    perf = dict(r.last_perf)
    sps = perf["steps_per_s"]
    st = r.state
    system = r.system
    row = thermo_row(st, system)
    temp, flags = float(row.temp), int(st.flags)
    engines = [m for m in logged if m.startswith("Engine:")]
    rows = [m for m in logged if m.split() and m.split()[0].isdigit()]
    print(f"path 9, config 4 with observers ({card}): {engines}; last_perf "
          f"{perf}; {sps:.2f} steps/s over the measured run "
          f"{C4['measure']}; T {temp:.4f}; flags {flags:#x}; "
          f"{cap.fs.n_launches} step-loop launches; thermo rows "
          f"{rows[-5:]}; launches {launches}", flush=True)
    missing = [k for k in ("stencil_forces", "kick_drift_halo",
                           "extruder_springs", "langevin_kick_monitor",
                           "step_loop") if launches.get(k, 0) == 0]
    if len(engines) != 2 or not all("K2 step loop" in m for m in engines) \
            or missing:
        fail(f"path 9 did not run K2's step loop's kernels: {engines}, "
             f"not launched {missing}")
    if flags & ~FLAG_FENE_CLAMP or not 0.5 < temp < 2.0 \
            or not bool(torch.isfinite(st.x).all()):
        fail(f"path 9 unhealthy: flags {flags:#x}, T {temp}")
    files = {name: os.path.getsize(os.path.join(td, name))
             for name in ("atoms.dump", "pairs.dump", "rdf.ave")}
    frames = open(os.path.join(td, "atoms.dump")).read().count(
        "ITEM: TIMESTEP")
    print(f"path 9 files: {files}; atoms.dump frames {frames}", flush=True)
    # each run reopens its dumps: the measured run's frames, steps 500,
    # 1000, 1500 and 2000
    if frames != C4["measure"] // OBS_EVERY or not all(files.values()):
        fail(f"path 9's dumps: {frames} frames, sizes {files}")
    ms = observer_checks("path 9 config 4", r, st, OBS_F32_REL, card,
                         timed=True)
    t0 = time.perf_counter()
    cmap = contact_map_accumulate(st, system)
    sync(dev)
    ms["contact_map_accumulate (wall)"] = (time.perf_counter() - t0) * 1e3
    sections = profile(r.sim, st, iters=10)
    print(f"path 9 observers on the card, ms a call ({card}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + f"; contact map total {float(cmap.sum()):.0f}; profile "
          + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in sections.items()),
          flush=True)
    native_restart_check("path 9 config 4", r, deck.split("\nrun ")[0], dev)
    del r, st, cap
    torch.cuda.empty_cache()

    # the 300-bead deck in f64 on the general path
    td = deck_dir(300, 7, 0.02, "data.tiny")
    tiny = obs_deck(TINY_DECK.split("\nwrite_data")[0] + "\n", 300, 1.2, 20)
    path = write_deck(td, "in.obs", tiny)
    os.environ["LLE_FAST"] = "0"
    try:
        r = deck_runner("float64", dev, [])
        r.root = td
        r.run_file(path)
    finally:
        os.environ.pop("LLE_FAST", None)
    observer_checks("path 9 300-bead f64", r, r.state, OBS_F64_REL, card)
    native_restart_check("path 9 300-bead f64", r, tiny.split("\nrun ")[0],
                         dev)
    return sps


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
    from lammps_le_torch.fast import make_fast_segment, replica, to_fast
    from lammps_le_torch.fast.engine import whole_planes_fit
    from lammps_le_torch.fast.maps import fast_maps
    from lammps_le_torch.fast.pallas_kernel import make_pallas_kernel
    from lammps_le_torch.fast.place import GridConsts
    from lammps_le_torch.parallel.shard_step import shardable

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
    if args.profile:
        # CUPTI traces each iteration of a conditional graph node only in
        # graphs instantiated after its first session (a first session
        # saw one step-loop step of each launch): one session before any
        # graph exists
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device=dev).add_(1)
            torch.cuda.synchronize()

    # the 100k path: full 27-offset stencil, within the whole-plane gate
    data, system = production_config(BEADS)
    print(f"{system.n} beads, grid {system.neighbor.nx}x{system.neighbor.ny}"
          f"x{system.neighbor.nz}, cap {system.neighbor.cell_cap}",
          flush=True)
    sim, settled = drive(system, data, dev, replica=None)
    start = bench_replica(settled, 0)
    segment, _ = make_fast_segment(sim, device=dev)
    if getattr(segment, "loop", None) is None:
        fail("path 1 did not take K2's step loop in auto mode")
    fs, wall, rebuilds, launches, loops = measured_segment(
        sim, start, dev, WARM, MEASURE, args.profile, segment=segment)
    # every kernel of the path runs once a production step (in the step
    # loop: its count is the steps it executed); rebuilds and LE events
    # launch none
    check_run("production", fs, system, wall, rebuilds, launches, MEASURE,
              GRID, path_launches(launches, "stencil_forces", loops=loops))
    loop_line("production", loops, wall, segment)
    # the chain from the same settled state: the witness of the step loop
    fs_c, wall_c, rebuilds_c, launches_c, _ = measured_segment(
        sim, start, dev, WARM, MEASURE, args.profile, pallas=False)
    check_run("production chain", fs_c, system, wall_c, rebuilds_c,
              launches_c, MEASURE, GRID,
              path_launches(launches_c, "stencil_forces"))
    chain_witness(fs, fs_c, system, rebuilds, rebuilds_c, wall, wall_c,
                  loops)
    del fs_c
    x_full = bead_positions(fs, system)
    g = GridConsts.build(system, fast_maps(system), dev)
    phases = dict(stencil_forces=stencil_phase(fs, sim, g),
                  **kernel_phases(fs, sim, g))
    phases["step_loop"] = step_loop_phase(fs, sim, g, phases)
    recs += path_records("100k", phases, launches)
    sps = {"100k full stencil, step loop": MEASURE / wall,
           "100k full stencil, chain": MEASURE / wall_c}
    del fs
    general_vs_fast(system, settled)
    torch.cuda.empty_cache()

    # path 3, the sharded slab stencil: the reference's gate, then the
    # same measured phase from the same settled state on the slab-resident
    # state at SP_PATH slabs, slab s on cuda:(s % the device count)
    maps = fast_maps(system)
    for sp in (1, 2, 4):
        print(f"shardable at sp={sp}: "
              f"{shardable(system, maps, [dev] * sp) or 'yes'}", flush=True)
    segment, sfs, fs, launches, slab = slab_window(sim, start, dev, SP_PATH,
                                                   args.profile, sps)
    witness(f"sharded sp={SP_PATH}", sim, start, dev, segment.kernel_fn, fs,
            x_full, newton=True)
    shard = shard_phase(fs, sim, g, dev)
    recs += path_records("100k sharded", dict(
        window_forces=shard[SP_PATH], **slab), launches)
    del fs, sfs, segment
    torch.cuda.empty_cache()

    # path 10, the multi-card paths: sp=SP_WIDE slab-resident, dp x sp
    # (the general path's replicas over a mesh run inside path 7)
    recs += multi_card_path(sim, settled, start, dev, shard[SP_WIDE], sps)
    torch.cuda.empty_cache()

    # path 4, the tiled full stencil as kernel_fn
    tiled_fn = make_pallas_kernel(system, maps, sim.ex_btype)
    fs, wall, rebuilds, launches, _ = measured_segment(
        sim, start, dev, WARM, MEASURE, args.profile, tiled_fn,
        pallas=False)
    check_run("tiled", fs, system, wall, rebuilds, launches, MEASURE, GRID,
              path_launches(launches, "tiled_stencil_forces"))
    sps["100k tiled stencil"] = MEASURE / wall
    witness("tiled", sim, start, dev, tiled_fn, fs, x_full)
    tiled = tiled_phase(fs, sim, g)
    recs += path_records("100k tiled", dict(tiled_stencil_forces=tiled),
                         launches)
    del fs, start
    torch.cuda.empty_cache()

    # path 6, replicas: bench.py's --sweep from the same settled state,
    # then each chain kernel batched over the R = 8 run's planes
    fs, launches, sweep = replica_sweep(sim, settled, dev, args.profile)
    for R, v in sweep.items():
        sps[f"100k replicas R={R} (a replica)"] = v
    recs += path_records(f"100k replicas R={fs.replicas}", batched_records(
        [replica(fs, r) for r in range(fs.replicas)], sweep_sim(sim), g,
        one_run_bound(sim, g), ("stencil_forces", "kick_drift_halo",
                                "extruder_springs", "langevin_kick_monitor")),
        launches)
    del fs, settled
    torch.cuda.empty_cache()

    # path 5, fix langevin zero + group: the production Langevin fix on
    # the group chain (beads 1-90,000) with zero yes, all phases anew
    member = np.zeros(system.n, bool)
    member[:N_CHAIN] = True
    groups = {"chain": member}
    sim5, start = drive(system, data, dev, groups)
    fs, wall, rebuilds, launches, loops = measured_segment(
        sim5, start, dev, WARM, MEASURE, args.profile, groups=groups)
    check_run("zero+group", fs, system, wall, rebuilds, launches, MEASURE,
              GRID, path_launches(launches, "stencil_forces", loops=loops))
    if loops == 0:
        fail("path 5 did not run in K2's step loop")
    loop_line("zero+group", loops, wall)
    sps["100k langevin zero+group"] = MEASURE / wall
    # the same Langevin fix on the slab-resident state: the split pass's
    # sums (langevin_sums) run there
    rec_sums, launches_z = zero_slab_window(sim5, start, dev, groups)
    recs += path_records(f"100k langevin zero+group sharded sp={SP_PATH}",
                         dict(langevin_sums=rec_sums), launches_z)
    t_in, t_out = group_temperatures(fs, system)
    print(f"zero+group: T over the group's {N_CHAIN} beads {t_in:.4f}, over "
          f"the other {system.n - N_CHAIN} {t_out:.4f}", flush=True)
    zg = zero_group_phase(fs, sim5, g)
    recs += path_records("100k langevin zero+group",
                         dict(langevin_kick_monitor=zg), launches)
    print(f"langevin_kick_monitor on the path-5 planes, device ms per call "
          f"({card}): zero+group {zg['t'][0]:.4f} (bound "
          f"{zg['bound'][0]:.4f} by {zg['bound'][1]}), group without zero "
          f"{zg['t_group'][0]:.4f}, without zero and group "
          f"{zg['t_nozero'][0]:.4f} (bound {zg['bound_nozero'][0]:.4f} by "
          f"{zg['bound_nozero'][1]}): zero+group / no zero "
          f"{zg['t'][0] / zg['t_nozero'][0]:.3f}", flush=True)
    print(f"100k steps/s in this call ({card}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in sps.items()), flush=True)
    del fs, g, x_full
    torch.cuda.empty_cache()

    # the port's public contract with the reference on the card
    contract_phase(dev, card, sim5, start, groups)
    del start

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
    sim, settled6 = settle_config6(data, system, dev)
    fs, wall, rebuilds, launches, _ = measured_segment(
        sim, settled6, dev, C6["warm"], C6["measure"], args.profile)
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
    # config 6's replicas: C6_REPLICAS replicas of the window's end on the
    # batched chain, and K3 batched over the settled and the end planes
    fs6, launches6 = config6_replicas(sim, fs, dev)
    recs += path_records(f"config6 replicas R={C6_REPLICAS}", batched_records(
        [to_fast(settled6, sim), fs], sim, g, one_run_bound(sim, g),
        ("newton_half_forces",)), launches6)
    del fs6, settled6
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

    # path 7, the general path: configs 1, 2, 3 and 5 through integrate.run
    gen = general_path(dev, card, args.profile)
    print(f"general path steps/s in this call ({card}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in gen.items()), flush=True)

    # path 8, the deck front end: config 4's deck, the CLI, restart, card
    # against CPU, minimize
    deck_recs, c4_sps = deck_path(dev, card, args.profile)
    for path, name, r in deck_recs:
        print_kernel(path, name, r)
    recs += deck_recs
    print(f"config 4 through the deck runner ({card}): {c4_sps:.2f} steps/s,"
          f" {c4_sps * C4['beads']:.4g} bead*steps/s", flush=True)

    # path 9, the observers and the native restart on config 4's deck
    obs_sps = observer_path(dev, card)
    print(f"config 4 with the observers every {OBS_EVERY} steps ({card}): "
          f"{obs_sps:.2f} steps/s against {c4_sps:.2f} without (path 8)",
          flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "path": path, "route": "cuda",
         "source": "lammps_le_torch/csrc/" + SOURCES.get(name, "step.cu"),
         "replaces": r["replaces"], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["t"][0],
         "ms_source": r["t"][2], "plain_ms": r["t_plain"][0],
         "plain_ms_source": r["t_plain"][2], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1],
         "library_ms": r["t_lib"][0] if "t_lib" in r else None,
         "floor_ms": r["t_floor"][0] if "t_floor" in r else None}
        for path, name, r in recs]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def multi_card():
    """The multi-card paths alone, over every card of the host (slab s on
    cuda:(s % the device count)), for a host of several cards:
    ``python3 -c 'import chip_smoke, sys; sys.exit(chip_smoke.multi_card())'``.
    The 100k config settled as ``main`` settles it, path 3's window
    slab-resident at SP_PATH slabs and path 10 (SP_WIDE slabs, dp x sp),
    each held bit for bit to the whole state or its run alone, and config
    2's replicas over GEN_MESH devices bit for bit the one-card runner.
    Returns 0, or raises on a failure; 2 without a card."""
    import torch

    from lammps_le_torch.csrc.build import build
    from lammps_le_torch.integrate import run
    from lammps_le_torch.state import init_state

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s): {cards}", flush=True)
    build()
    data, system = production_config(BEADS)
    sim, settled = drive(system, data, dev, replica=None)
    start = bench_replica(settled, 0)
    sps = {}
    slab_window(sim, start, dev, SP_PATH, 0, sps)
    multi_card_path(sim, settled, start, dev, None, sps)
    spec = GENERAL[2]
    system, data, sim, warm, seed = general_config(2, spec)
    state = init_state(system, data.x, types=data.types, seed=seed,
                       device=dev)
    state, _ = run(warm, state, spec["thermalize"])
    state = seed_extruders(state, spec["n_ex"],
                           max(4, system.n // spec["n_ex"]),
                           system.max_extruders, reset_step=False)
    state, _ = run(sim, state, spec["warm"])
    general_replicas(sim, state, dev)
    print(f"multi-card steps/s ({card_line()}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in sps.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
