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
    st = run_fast(warm, st, warm_steps)
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
