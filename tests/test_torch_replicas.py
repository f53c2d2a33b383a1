"""Replica ensembles and the static rebuild schedule of the port's fast
engine (``make_fast_segment(pallas=False, reactive=False)``,
``run_fast_replicas``), against the reference's ``jax.vmap`` of its
non-reactive XLA chain.

melt32 with all three LE fixes, rebuild every 3 steps and a 3-step hot
window after each extrusion event, two replicas built as
``run_fast_replicas`` builds them (one start, keys folded with 1234 and
1235), 15 steps: cadence, event and hot-window rebuilds.  The port's
replica-batched segment and its one-run segment on each replica give the
reference's extruder tables, counters, flags, step and rebuilds, its
integer planes, slots and anchor slots bit for bit, positions within 1e-3
(tests/test_torch_segment.py's tolerances), and each other bit for bit.
The step loop's one-step launches on the static schedule hold to the
chain; the schedule to the reference's formula; each batched plain kernel
and batched placement to its one-run calls."""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

import lammps_le_tpu.fixes as jf
import lammps_le_torch.fixes as tf
from lammps_le_torch import rng
from lammps_le_torch.fast import (make_fast_segment, replica,
                                  run_fast_replicas, to_fast)
from lammps_le_torch.fast import kernels as K
from lammps_le_torch.fast.consts import SpringConsts, StencilConsts
from lammps_le_torch.fast.engine import extract_beads, rebuild_schedule
from lammps_le_torch.fast.maps import fast_maps
from lammps_le_torch.fast.place import GridConsts, place, place_replicas
from lammps_le_torch.integrate import Simulation
from lammps_le_torch.state import state_from_arrays
from lammps_le_tpu.fast import engine as ref
from lammps_le_tpu.integrate import Simulation as RefSimulation
from torch_parity import (arrays_of, assert_same_run, check_segment_pair,
                          jax_state, le_fixes, melt_arrays)

R, SEED, NSTEPS, HOT = 2, 1234, 15, 3
# the planes and tables that are integers: bitwise against the reference
INT_FIELDS = ("bid", "hn", "pid", "slot_of", "exl_slot", "exr_slot")


def _compiled(fn, *args):
    """``fn(*args)``, compiled with LLVM's optimisations off: the same
    results bit for bit (tests/test_torch_place.py), in less compile
    time."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _sim():
    system, _ = melt_arrays()
    return Simulation(system=system, dt=0.005, energy_every=4,
                      fixes=le_fixes(tf), ex_btype=2)


def _start():
    _, d = melt_arrays()
    return arrays_of(jax_state(d, jnp.float32))


@functools.lru_cache(maxsize=None)
def _ref_run():
    """The reference's vmapped non-reactive chain over R replicas, built
    as its run_fast_replicas builds them (engine.py:1822-1831): the start
    with each replica's key folded in, to_fast."""
    system, d = melt_arrays()
    rsim = RefSimulation(system=system, dt=0.005, energy_every=4,
                         fixes=le_fixes(jf), ex_btype=2)
    segment, _ = ref.make_fast_segment(rsim, pallas=False, reactive=False,
                                       hot_window=HOT)

    # each replica's to_fast of the start with its folded key, stacked
    # (one compile: the reference vmaps the same function)
    js = jax_state(d, jnp.float32)
    to_fast_j = jax.jit(lambda s: ref.to_fast(s, rsim)).lower(js).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    fj = jax.tree.map(lambda *leaves: jnp.stack(leaves), *(
        to_fast_j(js.replace(key=jax.random.fold_in(js.key, SEED + i)))
        for i in range(R)))
    b = jnp.asarray(int(fj.step[0]), jnp.int32)
    return _compiled(jax.vmap(segment, in_axes=(0, None, None, None, None)),
                     fj, b, jnp.asarray(NSTEPS, jnp.int32), b, b + NSTEPS)


def _segment(**kw):
    return make_fast_segment(_sim(), pallas=False, reactive=False,
                             hot_window=HOT, device="cpu", **kw)[0]


@functools.lru_cache(maxsize=None)
def _port_runs():
    """(the port's replica-batched run, its one-run runs of each replica),
    both from the start that run_fast_replicas builds."""
    sim = _sim()
    start = state_from_arrays(_start(), "cpu")
    batched = run_fast_replicas(sim, start, R, 0, seed=SEED)
    b = batched.step
    _segment()(batched, b, NSTEPS, b, b + NSTEPS)
    runs = []
    for i in range(R):
        fs = to_fast(start, sim)
        fs = dataclasses.replace(
            fs, key_words=rng.fold_in(fs.key_words, SEED + i))
        runs.append(_segment()(fs, b, NSTEPS, b, b + NSTEPS))
    return batched, runs


def _check_replica(fj, ft):
    system, _ = melt_arrays()
    check_segment_pair(system, fj, ft)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(fj, name)),
            getattr(ft, name).numpy().astype(np.asarray(
                getattr(fj, name)).dtype), err_msg=name)


@pytest.mark.parametrize("form", ["batched", "one_run"])
def test_replicas_match_reference_vmap(form):
    """Each replica of the port's batched segment (``batched``) or the
    port's one-run segment on it (``one_run``) against the reference's
    vmapped chain; the two port forms bit for bit."""
    fjs = _ref_run()
    batched, runs = _port_runs()
    assert batched.replicas == R and batched.gx.shape[0] == R
    for r in range(R):
        fj = jax.tree.map(lambda leaf: leaf[r], fjs)
        ft = replica(batched, r) if form == "batched" else runs[r]
        _check_replica(fj, ft)
        assert_same_run(replica(batched, r), runs[r])
        for name in INT_FIELDS + ("img", "gx_ref"):
            assert torch.equal(getattr(replica(batched, r), name),
                               getattr(runs[r], name)), name
    # the replicas' keys differ: so do their runs
    assert not torch.equal(batched.gx[0], batched.gx[1])


def test_step_loop_static_schedule_holds_to_the_chain():
    """The step loop's non-reactive segment (one-step launches, the
    schedule served before each launch's drift, as the reference's
    launch_pallas serves it) against the non-reactive chain on one
    replica: the same tables, counters, flags and step, positions within
    1e-3 and energies within 0.1 (the two rebuild the grid on either side
    of a drift: their slots and so their force sums' order differ), no
    trigger armed and no launch counted."""
    system, _ = melt_arrays()
    _, runs = _port_runs()
    chain = runs[0]
    sim = _sim()
    seg, _ = make_fast_segment(sim, pallas="interpret", reactive=False,
                               hot_window=HOT, device="cpu")
    fs = to_fast(state_from_arrays(_start(), "cpu"), sim)
    fs = dataclasses.replace(fs, key_words=rng.fold_in(fs.key_words, SEED))
    b = fs.step
    seg(fs, b, NSTEPS, b, b + NSTEPS)
    for name in ("ex_left", "ex_right", "types", "flags", "n_moves",
                 "n_loads", "n_unloads", "last_event"):
        assert torch.equal(getattr(fs, name), getattr(chain, name)), name
    assert fs.step == chain.step and fs.skin_pend == 0
    assert fs.n_launches == 0 and fs.n_rebuilds >= chain.n_rebuilds
    x_loop = extract_beads(fs, fast_maps(system))[0]
    x_chain = extract_beads(chain, fast_maps(system))[0]
    box = torch.tensor(system.box_size)
    d = x_loop - x_chain
    assert float((d - box * torch.round(d / box)).abs().max()) < 1e-3
    assert abs(float(fs.epair) - float(chain.epair)) < 0.1
    assert abs(float(fs.ebond) - float(chain.ebond)) < 0.1


def _schedule_formula(K, phases, hot, sstep):
    """engine.py:1193-1200 as written there, for one step."""
    due = (sstep % K) == 0
    for nev, ph in phases:
        due = due | ((sstep % nev) == ph)
    for nev, ph, w in hot:
        due = due | (((sstep - ph) % nev) < w)
    return bool(due)


@pytest.mark.parametrize("case", [
    dict(rebuild_every=3, hot_window=None, reactive=False),
    dict(rebuild_every=3, hot_window=4, reactive=False),
    dict(rebuild_every=4, hot_window=None, reactive=False, bench=True),
    dict(rebuild_every=40, hot_window=8, reactive=True, bench=True),
])
def test_rebuild_schedule_is_the_reference_formula(case):
    """rebuild_schedule against the formula, default hot window (min(150,
    max(nevery // 4, 1))) included, on the test fixes' cadences and on
    bench.py's (extrusion every 1000, load/unload every 700); reactive
    segments have no hot window."""
    system, _ = melt_arrays()
    system = system.replace(neighbor=dataclasses.replace(
        system.neighbor, rebuild_every=case["rebuild_every"]))
    fixes = le_fixes(tf)
    if case.get("bench"):
        fixes = (fixes[0], fixes[1],
                 dataclasses.replace(fixes[2], nevery=1000, phase=17),
                 dataclasses.replace(fixes[3], nevery=700),
                 dataclasses.replace(fixes[4], nevery=700, phase=350))
    sim = Simulation(system=system, dt=0.005, fixes=fixes, ex_btype=2)
    due = rebuild_schedule(sim, case["reactive"], case["hot_window"])
    events = [f for f in fixes
              if isinstance(f, (tf.Extrusion, tf.ExLoad, tf.ExUnload))]
    phases = [(f.nevery, f.phase) for f in events]
    w = case["hot_window"]
    hot = [] if case["reactive"] else [
        (f.nevery, f.phase,
         w if w is not None else min(150, max(f.nevery // 4, 1)))
        for f in events if isinstance(f, tf.Extrusion)]
    steps = range(0, 2200)
    got = [s for s in steps if due(s)]
    assert got == [s for s in steps
                   if _schedule_formula(case["rebuild_every"], phases, hot,
                                        s)]
    if not case["reactive"] and case.get("bench"):
        # the default window after each extrusion event: 150 steps
        assert all(due(s) for s in range(1017, 1167))
        assert not due(1167) or 1167 % case["rebuild_every"] == 0


def _three_runs():
    """Three distinct replicas' planes after two steps, and one-run
    constants."""
    sim = _sim()
    start = state_from_arrays(_start(), "cpu")
    fs = run_fast_replicas(sim, start, 3, 2, seed=7)
    return sim, fs


@pytest.mark.parametrize("kernel", [
    "stencil_forces", "newton_half_forces", "kick_drift_halo",
    "extruder_springs", "langevin_kick_monitor", "place"])
def test_batched_plain_forms_are_one_run_calls(kernel):
    """Each replica-batched plain kernel at R = 3 (and placement, which
    sorts all replicas at once) against three one-run calls, bit for
    bit; the Langevin kernel with zero and a group plane."""
    sim, fs = _three_runs()
    system = sim.system
    maps = fast_maps(system)
    g = GridConsts.build(system, maps, "cpu")
    C, n = StencilConsts(system), system.n
    kick = 0.5 * sim.dt
    assert not torch.equal(fs.gx[0], fs.gx[1])
    if kernel == "stencil_forces":
        def call(gx, bid, hn, pid):
            return K.stencil_forces(gx, bid, hn, pid, g.interior, C, n,
                                    maps.strides, True)
        batched, per = (fs.gx, fs.bid, fs.hn, fs.pid), None
    elif kernel == "newton_half_forces":
        def call(gx, bid, hn, pid):
            return K.newton_half_forces(gx, bid, hn, pid, g.interior,
                                        g.faces, C, n, maps.strides,
                                        maps.fold_shifts, True)
        batched, per = (fs.gx, fs.bid, fs.hn, fs.pid), None
    elif kernel == "kick_drift_halo":
        def call(gx, gv, gf, bid):
            return K.kick_drift_halo(gx, gv, gf, bid, g.interior,
                                     g.halo_cols, g.halo_src, g.halo_shift,
                                     n, kick, sim.dt)
        batched, per = (fs.gx, fs.gv, fs.gf, fs.bid), None
    elif kernel == "extruder_springs":
        S = SpringConsts(system, sim.ex_btype)

        def call(gx, gf, exl, exr, active):
            gf = gf.clone()
            eb = K.extruder_springs(gx, gf, exl, exr, active, S)
            return gf, eb
        batched = (fs.gx, fs.gf, fs.exl_slot, fs.exr_slot, fs.ex_left >= 0)
        per = None
    elif kernel == "langevin_kick_monitor":
        keys = [rng.fold_in((5, 6), r) for r in range(3)]
        lgm = (fs.bid < 300).to(fs.gx.dtype)

        def call(gx, gx_ref, gv, gf, bid, lgm, key):
            return K.langevin_kick_monitor(
                gx, gx_ref, gv, gf, bid, g.interior, key, fs.step, -0.1,
                0.7, kick, sim.dt, 0.3, 0.2, n, True, lgm, True)
        batched = (fs.gx, fs.gx_ref, fs.gv, fs.gf, fs.bid, lgm)
        words = np.array(keys, np.uint32).view(np.int32)
        per = (torch.as_tensor(words), keys)
    else:
        x, v, f = extract_beads(fs, maps)

        def call(x, v, f, left, right, img):
            # R replicas' arrays: place_replicas; one run's: place
            fn = place_replicas if x.dim() == 3 else place
            return fn(system, maps, g, x, v, f, left, right, img)
        batched, per = (x, v, f, fs.ex_left, fs.ex_right, fs.img), None
    out = call(*batched, *(per[:1] if per else ()))
    for r in range(3):
        one = call(*(t[r] for t in batched), *((per[1][r],) if per else ()))
        for a, b in zip(out, one):
            assert torch.equal(a[r], b)
