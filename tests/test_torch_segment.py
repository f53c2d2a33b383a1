"""The port's fast engine end to end against the reference's: melt32 with
all three LE fixes for 20 steps gives the same extruder tables, LE
counters, flags, step and rebuild schedule as make_fast_segment(
pallas=False), positions within 1e-3 and epair within 0.1 (the
tolerances of tests/test_pallas_step.py:105-128), on the full stencil, on
the Newton-half stencil of grids past the whole-plane gate, on the
slab-resident state at sp=2 (shard_fast_state, make_sharded_segment,
gather_fast_state) and on the tiled
full stencil (make_pallas_kernel as kernel_fn), all against the same
reference run; one step also against the fused Pallas kernel in
interpret mode.  The port runs where jax is absent without loading the
reference package, its entry points default to the card, and it refuses
what it does not cover, the reference's general-engine Langevin options
tally and gjf among it."""

import dataclasses
import functools
import re
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
                                  make_fast_segment, run_fast,
                                  run_fast_replicas, to_fast)
from lammps_le_torch.fast.blocked_kernel import make_blocked_kernel
from lammps_le_torch.fast.maps import fast_maps
from lammps_le_torch.fast.pallas_kernel import make_pallas_kernel
from lammps_le_torch.integrate import Simulation
from lammps_le_torch.parallel.spatial import (gather_fast_state,
                                              make_sharded_segment,
                                              shard_fast_state)
from lammps_le_torch.state import init_state, state_from_arrays
from lammps_le_tpu.fast import engine as ref
from lammps_le_tpu.integrate import Simulation as RefSimulation
from torch_parity import (arrays_of, assert_same_run, chain_run,
                          check_segment_pair, jax_state, launch_schedule,
                          le_fixes, melt_arrays, port_run)

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
    make_sharded_segment over ``mesh`` (the state sharded into slabs by
    shard_fast_state, stepped slab-resident, gathered back)."""
    system, _ = melt_arrays()
    sim = _sims(system, energy_every)[1]
    start, fj = _ref_run(nsteps, energy_every, pallas)
    b = int(start["step"])
    if mesh is None:
        tseg, _ = make_fast_segment(sim, kernel_fn=kernel_fn, device="cpu")
    else:
        tseg = make_sharded_segment(sim, mesh)
        kernel_fn = tseg.kernel_fn
    ft = to_fast(state_from_arrays(start, "cpu"), sim, kernel_fn=kernel_fn)
    if mesh is None:
        ft = tseg(ft, b, nsteps, b, b + nsteps)
    else:
        ft = gather_fast_state(tseg(shard_fast_state(ft, mesh), b, nsteps,
                                    b, b + nsteps))
    return system, fj, ft


def _check_segment(kernel_fn=None, mesh=None):
    system, fj, ft = _run_both(20, energy_every=4, kernel_fn=kernel_fn,
                               mesh=mesh)
    check_segment_pair(system, fj, ft)


def test_segment_matches_reference_xla_chain():
    _check_segment()


def test_newton_half_segment_matches_reference_xla_chain():
    """The Newton-half stencil (the blocked kernel's counterpart) against
    the same reference run."""
    system, _ = melt_arrays()
    _check_segment(make_blocked_kernel(system, fast_maps(system), 2))


@pytest.mark.parametrize("path", ["sharded_sp2", "tiled"])
def test_kernel_path_segment_matches_reference_xla_chain(path):
    """The slab-resident state on the sharded slab stencil (K4's
    counterpart, two slabs) through make_sharded_segment, and the tiled
    full stencil (K5's counterpart) as kernel_fn, against the same
    reference run."""
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


def test_multistep_matches_reference_xla_chain():
    """K2's step loop (make_fast_segment(pallas="interpret")) against the
    same reference run: the checks above, its run the port's chain bit
    for bit, its launches those of the reference's multi-step segment.
    (The reference's fused kernel in interpret mode compiles for ~58 s on
    one core; the shared chain run costs nothing more here.)"""
    system, _ = melt_arrays()
    sim = _sims(system, 4)[1]
    _, fj = _ref_run(20, 4, False)  # the key _run_both uses
    ft = port_run(sim, 20, "interpret")
    check_segment_pair(system, fj, ft)
    chain, fired = chain_run(sim, 20)
    assert_same_run(chain, ft)
    assert ft.n_launches == launch_schedule(sim, ft.step - 20, 20, fired)
    assert 0 < ft.n_launches < 20


def test_run_fast_rows_match_reference():
    """run_fast returns (State, rows): rows at the start, at every fourth
    step and at the end (each also passed to thermo_callback), the last
    one the reference's thermo_row_fast of the same 20 steps (T within
    1e-4, energies within 0.1), the State within 1e-3 of its beads."""
    system, d = melt_arrays()
    sim = _sims(system, 4)[1]
    _, fj = _ref_run(20, 4, False)  # the key _run_both uses
    start = state_from_arrays(arrays_of(jax_state(d, jnp.float32)), "cpu")
    seen = []
    st, rows = run_fast(sim, start, 20, thermo_every=4,
                        thermo_callback=lambda row, s: seen.append(row.step))
    b = int(start.step)
    assert [r.step for r in rows] == seen == list(range(b, b + 21, 4))
    rt = ref.thermo_row_fast(fj, system)
    last = rows[-1]
    assert last.step == int(fj.step) == int(st.step)
    assert abs(float(rt.temp) - last.temp) < 1e-4
    assert abs(float(rt.epair) - last.epair) < 0.1
    assert abs(float(rt.ebond) - last.ebond) < 0.1
    assert int(rt.n_extruders) == last.n_extruders
    sj = ref.from_fast(fj, system)
    assert float(np.abs(np.asarray(sj.x) - st.x.numpy()).max()) < 1e-3


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
    dict(fix="Langevin", kw=dict(tally=True)),
    dict(fix="Langevin", kw=dict(gjf="vhalf")),
    dict(fix="NVE", kw=dict(group="chain")),
    dict(fix=None),
    dict(special_lj=(0.0, 0.5, 1.0)),
])
def test_block_reason_raises(change):
    """fast_block_reason gives the reference's reason on the same
    Simulation, and make_fast_segment refuses it."""
    system, _ = melt_arrays()

    def fixes(mod):
        if "fix" not in change:
            return (mod.NVE(), mod.Langevin(1.0, 1.0, 1.0))
        if change["fix"] is None:
            return ()
        if change["fix"] == "NVE":
            return (mod.NVE(**change["kw"]),)
        return (mod.NVE(), mod.Langevin(1.0, 1.0, 1.0, **change["kw"]))

    if "special_lj" in change:
        system = dataclasses.replace(system, special_lj=change["special_lj"])
    rsim, sim = (S(system=system, dt=0.005, fixes=fixes(mod), ex_btype=2)
                 for S, mod in ((RefSimulation, jf), (Simulation, tf)))
    want = ref.fast_block_reason(rsim)
    assert want is not None
    assert fast_block_reason(sim) == want
    with pytest.raises(NotImplementedError, match=re.escape(want)):
        make_fast_segment(sim, device="cpu")


@pytest.mark.parametrize("entry", ["init_state", "state_from_arrays",
                                   "uniform", "run_fast_replicas"])
def test_entry_points_default_to_the_card(entry):
    """Called without a device, the entry points run on the card, and
    without one they raise instead of running on the CPU (run_fast_
    replicas runs where its state lies: a state made without a device)."""
    system, d = melt_arrays()
    sim = _sims(system, 4)[1]
    call = {"init_state": lambda: init_state(system, d["x"]).x,
            "state_from_arrays": lambda: state_from_arrays(d).x,
            "uniform": lambda: rng.uniform((1, 2), 8),
            "run_fast_replicas": lambda: run_fast_replicas(
                sim, state_from_arrays(d), 2, 1).gx}[entry]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


_NO_JAX = r"""
import sys
sys.modules["jax"] = sys.modules["flax"] = None
import numpy as np, torch
torch.set_num_threads(1)  # as torch_parity pins the test workers
from lammps_le_torch.io.data import system_from_data
from lammps_le_torch.scene import serpentine
from lammps_le_torch.system import BOND_FENE, BOND_HARMONIC, BondParams, PairLJCut
from lammps_le_torch.fast import (from_fast, run_fast, run_fast_replicas,
                                  thermo_row_fast, to_fast)
from lammps_le_torch.fast.blocked_kernel import make_blocked_kernel
from lammps_le_torch.fast.engine import select_kernel
from lammps_le_torch.fast.maps import fast_maps
from lammps_le_torch.fast.pallas_kernel import make_pallas_kernel
from lammps_le_torch.parallel.shard_step import shardable
from lammps_le_torch.parallel.spatial import (
    gather_fast_state, make_sharded_segment, shard_fast_state)
from lammps_le_torch.csrc import build
from lammps_le_torch.fixes import NVE, Langevin, Extrusion
from lammps_le_torch.integrate import Simulation
from lammps_le_torch.probes import probe_bf16, probe_rcp
from lammps_le_torch.state import init_state
xp = torch.linspace(1.0, 2.0, 64).reshape(2, 32)
assert torch.isfinite(probe_rcp.rcp_chain(xp, True, 3)).all()
assert probe_rcp.precision(0.1, 1.0, device="cpu")[2] <= 2.0 ** -24
for dt in (torch.float32, torch.bfloat16):
    assert torch.isfinite(probe_bf16.chain(xp, dt, 3)).all()
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
st, _ = run_fast(sim, st, 2,
                 kernel_fn=make_blocked_kernel(system, fast_maps(system), 2))
st, _ = run_fast(sim, st, 2,
                 kernel_fn=make_pallas_kernel(system, fast_maps(system), 2))
assert shardable(system, fast_maps(system), ["cpu"] * 2) is None
seg = make_sharded_segment(sim, ["cpu"] * 2)
fs = to_fast(st, sim, kernel_fn=seg.kernel_fn)
fs = gather_fast_state(seg(shard_fast_state(fs, ["cpu"] * 2), 4, 2, 4, 6))
st = from_fast(fs, system)
assert int(st.step) == 6 and bool(torch.isfinite(st.x).all())
fr = run_fast_replicas(sim, st, 2, 2)
assert fr.replicas == 2 and fr.step == 8 and bool(torch.isfinite(fr.gx).all())
assert tuple(thermo_row_fast(fr, system).temp.shape) == (2,)
from lammps_le_torch.integrate import run
from lammps_le_torch.parallel import make_replica_runner, replicate_state
from lammps_le_torch.scene import chromosome, fene_melt
gst, rows = run(sim, st, 2, thermo_every=1)
assert int(gst.step) == 8 and len(rows) == 3
setup_fn, segment = make_replica_runner(sim, device="cpu")
rep = segment(setup_fn(replicate_state(gst, 2)), 1)
assert tuple(rep.x.shape) == (2, 200, 3) and int(rep.step[1]) == 9
assert fene_melt(2, 5).n_atoms == 10 and chromosome(20).n_atoms == 20
import os, tempfile
import lammps_le_torch.__main__
from lammps_le_torch.deck import DeckRunner, parse_deck
from lammps_le_torch.integrate.fire import minimize
from lammps_le_torch.integrate.min_cg import minimize_cg
from lammps_le_torch.io.checkpoint import load_checkpoint, save_checkpoint
from lammps_le_torch.io.data import read_data, write_data
from lammps_le_torch.io.dump import DumpSpec, run_with_dumps
from lammps_le_torch.observe.pressure import make_pressure_fn
assert bool(torch.isfinite(make_pressure_fn(system, 2)(gst)))
assert parse_deck("run 5").commands[0].args == ["5"]
with tempfile.TemporaryDirectory() as td:
    save_checkpoint(os.path.join(td, "c.npz"), gst)
    back = load_checkpoint(os.path.join(td, "c.npz"), like=gst)
    assert bool((back.x == gst.x).all()) and int(back.step) == 8
    write_data(os.path.join(td, "d.data"), data)
    assert read_data(os.path.join(td, "d.data")).n_atoms == 200
assert not any(m.split(".")[0] in ("jax", "flax", "lammps_le_tpu")
               and sys.modules[m] for m in list(sys.modules))
print("ok", int(st.n_moves))
"""


TINY_DECK = """
units lj
atom_style bond
special_bonds fene
read_data d.data
neighbor 0.3 bin
bond_style fene
bond_coeff 1 30.0 1.5 1.0 1.0
pair_style lj/cut 1.12
pair_coeff * * 1.0 1.0 1.12
velocity all create 1.0 87287
fix 1 all nve
thermo 5
timestep 0.005
run 10
"""


def test_cli_runs_a_deck(tmp_path):
    """``python -m lammps_le_torch -platform cpu -in deck -quiet`` runs a
    deck and writes its log; without ``-platform`` the CLI runs on the
    card, so without one it exits with an error."""
    from lammps_le_torch.io.data import write_data
    from lammps_le_torch.scene import serpentine

    write_data(str(tmp_path / "d.data"), serpentine(120, seed=1))
    (tmp_path / "in.t").write_text(TINY_DECK)
    cmd = [sys.executable, "-m", "lammps_le_torch", "-in",
           str(tmp_path / "in.t"), "-quiet"]
    res = subprocess.run(cmd + ["-platform", "cpu", "-log",
                                str(tmp_path / "log.txt")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout == ""
    log = (tmp_path / "log.txt").read_text()
    assert "Step" in log and "Loop time" in log and "Engine: general" in log
    if not torch.cuda.is_available():
        res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode != 0 and "device='cpu'" in res.stderr


def test_port_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[0] == "ok"
    assert int(res.stdout.split()[1]) > 0
