"""Shared builders for the lammps_le_torch parity tests: one small system,
one start state handed to both engines (as numpy arrays), and converters
between the reference's jax State and the port's torch State."""

import functools

import numpy as np
import torch

import jax.numpy as jnp

import lammps_le_tpu.state as jstate
from lammps_le_tpu.io.data import system_from_data
from lammps_le_tpu.scene import serpentine
from lammps_le_tpu.system import (BOND_FENE, BOND_HARMONIC, BondParams,
                                  PairLJCut)

# one intra-op thread for the port's plain versions: their tensors are
# small, and the parallel test run puts several workers on each core,
# where more threads only contend (the port's tests are timed so, too)
torch.set_num_threads(1)

STATE_FIELDS = ("x", "v", "f", "img", "type", "ex_left", "ex_right", "key",
                "step", "flags", "epair", "ebond", "n_moves", "n_loads",
                "n_unloads", "last_event")


def make_system(n=500, dtype="float32", skin=0.3, cap=8, rebuild_every=3,
                max_extruders=16, seed=3, fene_sigma=1.0, ex_style=None):
    """The 500-bead melt32 geometry of tests/test_pallas_step.py:27-57."""
    data = serpentine(n, spacing=0.97, row_gap=1.1, seed=seed,
                      barrier_fraction=0.01)
    ones = np.ones((4, 4))
    pair = PairLJCut(epsilon=ones, sigma=ones, cutoff=1.12 * ones,
                     shift=True)
    ex = ([3.0, 1.1, 0.0, 0.0] if ex_style in (None, BOND_HARMONIC)
          else [20.0, 2.0, 1.0, 1.0])
    bonds = BondParams(
        style=np.array([BOND_FENE, ex_style or BOND_HARMONIC]),
        coeffs=np.array([[30.0, 1.5, 1.0, fene_sigma], ex]))
    system, _ = system_from_data(
        data, pair=pair, bonds=bonds, dtype=dtype, ex_btype=2,
        max_extruders=max_extruders, skin=skin,
        rebuild_every=rebuild_every, cell_cap=cap)
    return system, data


def le_fixes(mod, fraction=0.3, load_cutoff=1.6):
    """NVE + Langevin + the three LE fixes at test cadences (5 / 7), with
    a load cutoff wide enough that a short run loads extruders."""
    return (
        mod.NVE(),
        mod.Langevin(t_start=1.0, t_stop=1.0, damp=10.0, seed=904297),
        mod.Extrusion(nevery=5, neutral_type=1, ctcf_left=2, ctcf_right=3,
                      through_prob=0.5, btype=2, ctcf_left_right=4),
        mod.ExLoad(nevery=7, iatomtype=1, jatomtype=1, cutoff=load_cutoff,
                   btype=2, fraction=fraction, seed=684474, imaxbond=1,
                   inewtype=1, jmaxbond=1, jnewtype=1),
        mod.ExUnload(nevery=7, btype=2, cutoff=0.5, fraction=fraction,
                     seed=456456),
    )


@functools.lru_cache(maxsize=None)
def melt_arrays(n=500, dtype="float32", warm_steps=40):
    """A thermalized start state as numpy arrays (thermalized with the
    port's plain path on CPU), with six extruders seeded at (i, i+2)."""
    from lammps_le_torch.fast import run_fast
    from lammps_le_torch.fixes import NVE, Langevin
    from lammps_le_torch.integrate import Simulation
    from lammps_le_torch.state import init_state

    system, data = make_system(n, dtype)
    warm = Simulation(system=system, dt=0.005, ex_btype=2,
                      fixes=(NVE(), Langevin(1.0, 1.0, 1.0, seed=5)))
    st = init_state(system, data.x, types=data.types, seed=11,
                    device="cpu")
    st, _ = run_fast(warm, st, warm_steps)
    d = {k: getattr(st, k).numpy().copy() for k in STATE_FIELDS}
    e = system.max_extruders
    d["ex_left"] = np.full(e, -1, np.int64)
    d["ex_right"] = np.full(e, -1, np.int64)
    sites = np.arange(6) * 80 + 3
    d["ex_left"][:6] = sites
    d["ex_right"][:6] = sites + 2
    d["flags"] = np.zeros((), np.int64)
    return system, d


def jax_state(d, dtype):
    """The reference State holding the arrays of ``d``."""
    i32 = jnp.int32
    return jstate.State(
        x=jnp.asarray(d["x"], dtype), v=jnp.asarray(d["v"], dtype),
        f=jnp.asarray(d["f"], dtype), img=jnp.asarray(d["img"], i32),
        type=jnp.asarray(d["type"], i32),
        ex_left=jnp.asarray(d["ex_left"], i32),
        ex_right=jnp.asarray(d["ex_right"], i32),
        key=jnp.asarray(d["key"], jnp.uint32),
        step=jnp.asarray(d["step"], i32),
        flags=jnp.asarray(d["flags"], jnp.uint32),
        epair=jnp.asarray(d["epair"], dtype),
        ebond=jnp.asarray(d["ebond"], dtype),
        n_moves=jnp.asarray(d["n_moves"], i32),
        n_loads=jnp.asarray(d["n_loads"], i32),
        n_unloads=jnp.asarray(d["n_unloads"], i32),
        last_event=jnp.asarray(d["last_event"], i32),
        therm_e=jnp.zeros((), dtype))


def arrays_of(js):
    """A reference State as the dict ``state_from_arrays`` takes."""
    return {k: np.asarray(getattr(js, k)) for k in STATE_FIELDS}


def check_segment_pair(system, fj, ft):
    """A reference FastState ``fj`` and the port's ``ft`` after the same
    segment: extruder tables, types, LE counters, flags, rebuilds, the
    last event counts and the step equal, with at least one move, load
    and unload; positions within 1e-3, images equal, energies within
    0.1, T within 1e-4 (tests/test_pallas_step.py:105-128)."""
    from lammps_le_torch.fast import from_fast, thermo_row_fast
    from lammps_le_tpu.fast import engine as ref

    np.testing.assert_array_equal(np.asarray(fj.ex_left), ft.ex_left.numpy())
    np.testing.assert_array_equal(np.asarray(fj.ex_right),
                                  ft.ex_right.numpy())
    np.testing.assert_array_equal(np.asarray(fj.types), ft.types.numpy())
    for name in ("n_moves", "n_loads", "n_unloads", "flags", "n_rebuilds"):
        assert int(getattr(fj, name)) == int(getattr(ft, name)), name
    np.testing.assert_array_equal(np.asarray(fj.last_event),
                                  ft.last_event.numpy())
    assert int(fj.step) == ft.step
    assert int(ft.n_moves) > 0 and int(ft.n_loads) > 0
    assert int(ft.n_unloads) > 0
    sj = ref.from_fast(fj, system)
    st = from_fast(ft, system)
    assert float(np.abs(np.asarray(sj.x) - st.x.numpy()).max()) < 1e-3
    np.testing.assert_array_equal(np.asarray(sj.img), st.img.numpy())
    assert abs(float(fj.epair) - float(ft.epair)) < 0.1
    assert abs(float(fj.ebond) - float(ft.ebond)) < 0.1
    rt = ref.thermo_row_fast(fj, system)
    tt = thermo_row_fast(ft, system)
    assert abs(float(rt.temp) - float(tt.temp)) < 1e-4
    assert int(rt.n_extruders) == int(tt.n_extruders)


MULTISTEP_STATE = ("gx", "gv", "gf", "ex_left", "ex_right", "types", "flags",
                   "epair", "ebond", "n_moves", "n_loads", "n_unloads",
                   "n_clamps", "last_event")


def start_state():
    """The port's State at the melt32 start, on the CPU."""
    from lammps_le_torch.state import state_from_arrays

    _, d = melt_arrays()
    return state_from_arrays(arrays_of(jax_state(d, jnp.float32)), "cpu")


def fast_start(sim, groups=None):
    """The port's FastState at the melt32 start, on the CPU."""
    from lammps_le_torch.fast import to_fast

    return to_fast(start_state(), sim, groups=groups)


def port_run(sim, nsteps, pallas):
    """The port's segment of ``nsteps`` from the melt32 start, on the CPU,
    with ``make_fast_segment``'s ``pallas``."""
    from lammps_le_torch.fast import make_fast_segment

    segment, _ = make_fast_segment(sim, pallas=pallas, device="cpu")
    fs = fast_start(sim)
    b = fs.step
    return segment(fs, b, nsteps, b, b + nsteps)


def chain_run(sim, nsteps):
    """The port's chain from the melt32 start, one step a call:
    (FastState, the steps whose look-ahead trigger fired)."""
    from lammps_le_torch.fast import make_fast_segment

    segment, _ = make_fast_segment(sim, pallas=False, device="cpu")
    fs = fast_start(sim)
    b = fs.step
    fired = set()
    for i in range(nsteps):
        segment(fs, b + i, 1, b, b + nsteps)
        if fs.skin_pend:
            fired.add(b + i + 1)
    return fs, fired


def launch_schedule(sim, step0, length, fired):
    """The launches of the reference's multi-step segment (its
    loop, engine.py:1713-1735): up to LAUNCH_MAX steps, stopped short of
    the next step of each cadence (LE event phases, the rebuild backstop,
    energy steps), energy steps alone, each launch ending after a step in
    ``fired``."""
    from lammps_le_torch.fast.pallas_step import LAUNCH_MAX
    from lammps_le_torch.fixes import ExLoad, Extrusion, ExUnload

    cadences = [(f.nevery, f.phase) for f in sim.fixes
                if isinstance(f, (Extrusion, ExLoad, ExUnload))]
    cadences += [(sim.system.neighbor.rebuild_every, 0),
                 (sim.energy_every, 0)]
    done = launches = 0
    while done < length:
        sstep = step0 + done + 1
        lim = min(LAUNCH_MAX, length - done)
        for nev, ph in cadences:
            dist = (ph - sstep) % nev
            lim = min(lim, nev if dist == 0 else dist)
        if sstep % sim.energy_every == 0:
            lim = 1
        d = next((k + 1 for k in range(lim) if sstep + k in fired), lim)
        done += d
        launches += 1
    return launches


def assert_same_run(a, b):
    """Two port FastStates of the same run, bit for bit."""
    for name in MULTISTEP_STATE:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in ("step", "n_rebuilds", "skin_pend"):
        assert getattr(a, name) == getattr(b, name), name


# ---------------------------------------------------------------------------
# the general path (integrate.run) against the reference's, from the
# melt32 start: tests/test_torch_verlet*.py

GENERAL_STEPS, GENERAL_EVERY = 20, 10
GENERAL_INTS = ("ex_left", "ex_right", "type", "img", "n_moves", "n_loads",
                "n_unloads", "last_event", "flags", "step")
_HALF = np.arange(500) < 250
GROUPS = {"a": _HALF, "b": ~_HALF}


def general_fixes(mod, name):
    """The fix sets of the general-path trajectories: the LE mix; GJF
    vhalf with tally, zero and a group; GJF vfull; nve/limit + a grouped
    nve, two grouped Langevin fixes with a t ramp (zero on one, tally on
    the other), fix momentum and fix viscous."""
    if name == "le":
        return le_fixes(mod)
    if name == "gjf_vhalf":
        return (mod.NVE(), mod.Langevin(1.0, 1.0, 2.0, seed=21, gjf="vhalf",
                                        tally=True, zero=True, group="a"))
    if name == "gjf_vfull":
        return (mod.NVE(), mod.Langevin(1.0, 1.0, 1.0, seed=22,
                                        gjf="vfull"))
    return (mod.NVELimit(xmax=0.006, group="a"), mod.NVE(group="b"),
            mod.Langevin(1.0, 1.5, 1.0, seed=3, group="a", zero=True),
            mod.Langevin(1.2, 0.8, 2.0, seed=4, group="b", tally=True),
            mod.Momentum(nevery=5), mod.Viscous(gamma=0.2))


@functools.lru_cache(maxsize=None)
def general_system(dtype):
    return make_system(dtype=dtype)[0]


def general_sims(name, dtype):
    """(reference Simulation, port Simulation) of fix set ``name``;
    energy_every 4 for the "mixed" set."""
    import lammps_le_torch.fixes as tf
    import lammps_le_tpu.fixes as jf
    from lammps_le_torch.integrate import Simulation
    from lammps_le_tpu.integrate import Simulation as RefSimulation

    kw = dict(system=general_system(dtype), dt=0.005, ex_btype=2,
              energy_every=4 if name == "mixed" else 1)
    return (RefSimulation(fixes=general_fixes(jf, name), **kw),
            Simulation(fixes=general_fixes(tf, name), **kw))


@functools.lru_cache(maxsize=None)
def general_start(dtype):
    """The melt32 start (thermalized, six extruders) as numpy arrays in
    ``dtype``."""
    _, d = melt_arrays()
    d = dict(d)
    for k in ("x", "v", "f", "epair", "ebond"):
        d[k] = np.asarray(d[k], dtype)
    return arrays_of(jax_state(d, jnp.dtype(dtype)))


def _compiled(fn, *args):
    """``fn`` compiled for ``args`` with LLVM's optimisations off (the
    same results, less compile time)."""
    import jax

    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


class UnoptimisedJax:
    """``jax`` as a reference module sees it (set as its module attribute
    ``jax``), with ``jit`` compiling each function once, at its first
    call, with LLVM's optimisations off (``_compiled``): for functions
    called with one signature throughout, the same results for less
    compile time.  A call with another signature raises."""

    def __init__(self):
        import jax

        self._jax = jax

    def __getattr__(self, name):
        return getattr(self._jax, name)

    def jit(self, fn):
        done = []

        def call(*args):
            if not done:
                done.append(_compiled(fn, *args))
            return done[0](*args)

        return call


@functools.lru_cache(maxsize=None)
def _ref_setup(dtype):
    """The reference's setup, compiled once: it reads only the system and
    ex_btype, which every fix set shares."""
    from lammps_le_tpu.integrate import verlet

    rsim, _ = general_sims("le", dtype)
    return _compiled(lambda s: verlet.setup(rsim, s),
                     jax_state(general_start(dtype), jnp.dtype(dtype)))


def ref_general_run(rsim, d, groups):
    """The reference's ``run`` of GENERAL_STEPS with a thermo row every
    GENERAL_EVERY (verlet.py:631-709: setup, then segments): (final
    State, the rows) as numpy, the rows stacked, the first after setup."""
    import jax
    from lammps_le_tpu.integrate import verlet

    step = verlet.make_step(rsim, groups)
    begin = int(d["step"])
    rb, re = jnp.int32(begin), jnp.int32(begin + GENERAL_STEPS)
    st = _ref_setup(str(np.asarray(d["x"]).dtype))(
        jax_state(d, jnp.asarray(d["x"]).dtype))

    def segments(s):
        def chunk(s, _):
            s = jax.lax.fori_loop(0, GENERAL_EVERY,
                                  lambda i, s: step(s, rb, re), s)
            return s, verlet.thermo_row(s, rsim.system)

        return jax.lax.scan(chunk, s, None,
                            length=GENERAL_STEPS // GENERAL_EVERY)

    row0 = verlet.thermo_row(st, rsim.system)
    st, rows = _compiled(segments, st)(st)
    rows = jax.tree.map(lambda a, b: np.concatenate([np.asarray(a)[None],
                                                     np.asarray(b)]),
                        row0, rows)
    return jax.tree.map(np.asarray, st), rows


@functools.lru_cache(maxsize=None)
def general_pair(name, dtype="float64"):
    """(reference (State, rows), port (State, rows)) of one run of fix set
    ``name`` from the same start."""
    from lammps_le_torch.integrate import run
    from lammps_le_torch.state import state_from_arrays

    rsim, tsim = general_sims(name, dtype)
    d = general_start(dtype)
    groups = None if name == "le" else GROUPS
    return (ref_general_run(rsim, d, groups),
            run(tsim, state_from_arrays(d, "cpu"), GENERAL_STEPS,
                groups=groups, thermo_every=GENERAL_EVERY))


def check_general_ints(rs, ts):
    for k in GENERAL_INTS:
        np.testing.assert_array_equal(getattr(rs, k), getattr(ts, k).numpy(),
                                      err_msg=k)


def check_general_f64(name):
    """A general-path run against the reference's in f64: integer fields
    bit for bit; x and v within 1e-9, f within 1e-9 x max(1, max|f|),
    the tally within 1e-9, thermo values within 1e-8 x max(1, |value|)."""
    (rs, rows), (ts, trows) = general_pair(name)
    check_general_ints(rs, ts)
    for k in ("x", "v"):
        assert float(np.abs(getattr(rs, k) - getattr(ts, k).numpy()).max()) \
            <= 1e-9, k
    assert float(np.abs(rs.f - ts.f.numpy()).max()) <= 1e-9 * max(
        1.0, float(np.abs(rs.f).max()))
    assert abs(float(rs.therm_e) - float(ts.therm_e)) <= 1e-9
    assert len(trows) == len(rows.step)
    for i, row in enumerate(trows):
        assert (row.step, row.n_extruders) == (int(rows.step[i]),
                                               int(rows.n_extruders[i]))
        for k in ("temp", "epair", "ebond", "ke", "etotal"):
            want = float(getattr(rows, k)[i])
            assert abs(getattr(row, k) - want) <= 1e-8 * max(1.0, abs(want))
    return ts
