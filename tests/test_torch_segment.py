"""The port's fast engine end to end against the reference's: melt32 with
all three LE fixes for 20 steps gives the same extruder tables, LE
counters, flags, step and rebuild schedule as make_fast_segment(
pallas=False), positions within 1e-3 and epair within 0.1 (the
tolerances of tests/test_pallas_step.py:105-128), on the full stencil, on
the Newton-half stencil of grids past the whole-plane gate, on the
sharded slab stencil at sp=2 (make_sharded_segment) and on the tiled
full stencil (make_pallas_kernel as kernel_fn), all against the same
reference run; one step also against the fused Pallas kernel in
interpret mode.  The port runs where jax is absent without loading the
reference package, its entry points default to the card, and it refuses
what it does not cover."""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

import lammps_le_tpu.fixes as jf
import lammps_le_torch.fixes as tf
from lammps_le_torch import rng
from lammps_le_torch.fast import (fast_block_reason, from_fast,
                                  make_fast_segment, thermo_row_fast,
                                  to_fast)
from lammps_le_torch.fast.blocked_kernel import make_blocked_kernel
from lammps_le_torch.fast.maps import fast_maps
from lammps_le_torch.fast.pallas_kernel import make_pallas_kernel
from lammps_le_torch.integrate import Simulation
from lammps_le_torch.parallel.spatial import make_sharded_segment
from lammps_le_torch.state import init_state, state_from_arrays
from lammps_le_tpu.fast import engine as ref
from lammps_le_tpu.integrate import Simulation as RefSimulation
from torch_parity import arrays_of, jax_state, le_fixes, melt_arrays

REPO = Path(__file__).resolve().parents[1]


def _sims(system, energy_every, fixes=le_fixes):
    return (RefSimulation(system=system, dt=0.005, energy_every=energy_every,
                          fixes=fixes(jf), ex_btype=2),
            Simulation(system=system, dt=0.005, energy_every=energy_every,
                       fixes=fixes(tf), ex_btype=2))


@functools.lru_cache(maxsize=None)
def _ref_to_fast():
    """The reference's to_fast, jitted once: it reads only the system and
    the extruder bond type, which every Simulation here shares."""
    system, _ = melt_arrays()
    rsim = _sims(system, 1)[0]
    return jax.jit(lambda s: ref.to_fast(s, rsim))


@functools.lru_cache(maxsize=None)
def _ref_run(nsteps, energy_every, pallas=False):
    """The reference's segment from the melt32 start state: (start
    arrays, its FastState)."""
    system, d = melt_arrays()
    rsim = _sims(system, energy_every)[0]
    js = jax_state(d, jnp.float32)
    segment, _ = ref.make_fast_segment(rsim, pallas=pallas)
    fj = _ref_to_fast()(js)
    b = int(fj.step)
    fj = jax.jit(segment)(fj, jnp.asarray(b, jnp.int32), nsteps,
                          jnp.asarray(b, jnp.int32),
                          jnp.asarray(b + nsteps, jnp.int32))
    return arrays_of(js), fj


def _run_both(nsteps, energy_every, pallas=False, kernel_fn=None,
              mesh=None):
    """Both engines from the same start; the port on ``kernel_fn``, or on
    make_sharded_segment over ``mesh``."""
    system, _ = melt_arrays()
    sim = _sims(system, energy_every)[1]
    start, fj = _ref_run(nsteps, energy_every, pallas)
    b = int(start["step"])
    if mesh is None:
        tseg = make_fast_segment(sim, "cpu", kernel_fn)
    else:
        tseg = make_sharded_segment(sim, mesh)
        kernel_fn = tseg.kernel_fn
    ft = to_fast(state_from_arrays(start, "cpu"), sim, kernel_fn)
    ft = tseg(ft, b, nsteps, b, b + nsteps)
    return system, fj, ft


def _check_segment(kernel_fn=None, mesh=None):
    system, fj, ft = _run_both(20, energy_every=4, kernel_fn=kernel_fn,
                               mesh=mesh)
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


def test_segment_matches_reference_xla_chain():
    _check_segment()


def test_newton_half_segment_matches_reference_xla_chain():
    """The Newton-half stencil (the blocked kernel's counterpart) against
    the same reference run."""
    system, _ = melt_arrays()
    _check_segment(make_blocked_kernel(system, fast_maps(system), 2))


@pytest.mark.parametrize("path", ["sharded_sp2", "tiled"])
def test_kernel_path_segment_matches_reference_xla_chain(path):
    """The sharded slab stencil (K4's counterpart, two slabs) through
    make_sharded_segment, and the tiled full stencil (K5's counterpart)
    as kernel_fn, against the same reference run."""
    system, _ = melt_arrays()
    if path == "tiled":
        _check_segment(make_pallas_kernel(system, fast_maps(system), 2))
    else:
        _check_segment(mesh=["cpu"] * 2)


def test_one_step_matches_fused_pallas_interpret():
    """One step against the fused whole-step kernel (interpret mode):
    forces, positions and velocities at its f32 parity tolerances
    (tests/test_pallas_step.py:89-102)."""
    _, fp, ft = _run_both(1, energy_every=1, pallas="interpret")
    gf = np.asarray(fp.gf)
    scale = max(float(np.abs(gf).max()), 1.0)
    assert float(np.abs(gf - ft.gf.numpy()).max()) < 3e-5 * scale
    assert float(np.abs(np.asarray(fp.gx) - ft.gx.numpy()).max()) < 1e-6
    assert float(np.abs(np.asarray(fp.gv) - ft.gv.numpy()).max()) < (
        3e-5 * scale)
    assert abs(float(fp.epair) - float(ft.epair)) < 2e-2
    assert abs(float(fp.ebond) - float(ft.ebond)) < 2e-2
    assert int(fp.flags) == int(ft.flags) == 0


def test_to_fast_round_trip():
    """to_fast -> from_fast returns the (wrapped) beads and the initial
    forces of the reference's to_fast."""
    system, d = melt_arrays()
    sim = _sims(system, 1)[1]
    js = jax_state(d, jnp.float32)
    sj = ref.from_fast(_ref_to_fast()(js), system)
    st = from_fast(to_fast(state_from_arrays(arrays_of(js), "cpu"), sim),
                   system)
    np.testing.assert_array_equal(np.asarray(sj.x), st.x.numpy())
    np.testing.assert_array_equal(np.asarray(sj.v), st.v.numpy())
    f = np.asarray(sj.f)
    assert float(np.abs(f - st.f.numpy()).max()) < 3e-5 * np.abs(f).max()


@pytest.mark.parametrize("change", [
    dict(fix=tf.Langevin(1.0, 1.0, 1.0, zero=True)),
    dict(fix=tf.Langevin(1.0, 1.0, 1.0, group="chain")),
    dict(fix=tf.NVE(group="chain")),
    dict(fix=None),
    dict(special_lj=(0.0, 0.5, 1.0)),
])
def test_block_reason_raises(change):
    system, _ = melt_arrays()
    fixes = [tf.NVE(), tf.Langevin(1.0, 1.0, 1.0)]
    if "fix" in change:
        fixes = [tf.NVE()] if change["fix"] is None else [change["fix"]]
        if change["fix"] is None:
            fixes = []
        elif not isinstance(change["fix"], tf.NVE):
            fixes = [tf.NVE(), change["fix"]]
    else:
        system = dataclasses.replace(system, **change)
    sim = Simulation(system=system, dt=0.005, fixes=tuple(fixes),
                     ex_btype=2)
    with pytest.raises(NotImplementedError):
        fast_block_reason(sim)
    with pytest.raises(NotImplementedError):
        make_fast_segment(sim, "cpu")


@pytest.mark.parametrize("entry", ["init_state", "state_from_arrays",
                                   "uniform"])
def test_entry_points_default_to_the_card(entry):
    """Called without a device, the entry points run on the card, and
    without one they raise instead of running on the CPU."""
    system, d = melt_arrays()
    call = {"init_state": lambda: init_state(system, d["x"]).x,
            "state_from_arrays": lambda: state_from_arrays(d).x,
            "uniform": lambda: rng.uniform((1, 2), 8)}[entry]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


_NO_JAX = r"""
import sys
sys.modules["jax"] = sys.modules["flax"] = None
import numpy as np, torch
from lammps_le_torch.io.data import system_from_data
from lammps_le_torch.scene import serpentine
from lammps_le_torch.system import BOND_FENE, BOND_HARMONIC, BondParams, PairLJCut
from lammps_le_torch.fast import from_fast, run_fast, to_fast
from lammps_le_torch.fast.blocked_kernel import make_blocked_kernel
from lammps_le_torch.fast.engine import select_kernel
from lammps_le_torch.fast.maps import fast_maps
from lammps_le_torch.fast.pallas_kernel import make_pallas_kernel
from lammps_le_torch.parallel.shard_step import shardable
from lammps_le_torch.parallel.spatial import make_sharded_segment
from lammps_le_torch.csrc import build
from lammps_le_torch.fixes import NVE, Langevin, Extrusion
from lammps_le_torch.integrate import Simulation
from lammps_le_torch.state import init_state
data = serpentine(200, spacing=0.97, row_gap=1.1, seed=1)
ones = np.ones((4, 4))
system, _ = system_from_data(
    data, pair=PairLJCut(ones, ones, 1.12 * ones, shift=True),
    bonds=BondParams(np.array([BOND_FENE, BOND_HARMONIC]),
                     np.array([[30.0, 1.5, 1.0, 1.0], [3.0, 1.1, 0, 0]])),
    ex_btype=2, max_extruders=4, skin=0.4, cell_cap=10)
sim = Simulation(system=system, dt=0.005, ex_btype=2, fixes=(
    NVE(), Langevin(1.0, 1.0, 1.0),
    Extrusion(nevery=2, neutral_type=1, ctcf_left=2, ctcf_right=3,
              through_prob=0.5, btype=2)))
st = init_state(system, data.x, types=data.types, seed=3, device="cpu")
st = st.replace(ex_left=torch.tensor([20, -1, -1, -1]),
                ex_right=torch.tensor([22, -1, -1, -1]))
assert select_kernel(system, fast_maps(system), 2).__qualname__.startswith(
    "make_kernel")
st = run_fast(sim, st, 2,
              kernel_fn=make_blocked_kernel(system, fast_maps(system), 2))
st = run_fast(sim, st, 2,
              kernel_fn=make_pallas_kernel(system, fast_maps(system), 2))
assert shardable(system, fast_maps(system), ["cpu"] * 2) is None
seg = make_sharded_segment(sim, ["cpu"] * 2)
fs = to_fast(st, sim, seg.kernel_fn)
seg(fs, 4, 2, 4, 6)
st = from_fast(fs, system)
assert int(st.step) == 6 and bool(torch.isfinite(st.x).all())
assert not any(m.split(".")[0] in ("jax", "flax", "lammps_le_tpu")
               and sys.modules[m] for m in list(sys.modules))
print("ok", int(st.n_moves))
"""


def test_port_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[0] == "ok"
    assert int(res.stdout.split()[1]) > 0
