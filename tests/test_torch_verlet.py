"""The general path (``lammps_le_torch.integrate``: ``run``, ``setup``,
``make_step``; ``parallel.replica``; ``scene.fene_melt`` /
``chromosome``) against the JAX package's, on the 500-bead melt32 system
of ``torch_parity``, from its thermalized start with six seeded
extruders.

The LE production mix in f64 through ``run`` for 20 steps with thermo
rows every 10, against the reference's run (``torch_parity
.check_general_f64``: integer fields bit for bit, x and v within 1e-9, f
within 1e-9 x max(1, max|f|), thermo values within 1e-8 x max(1,
|value|)); the other fix sets are in test_torch_verlet_gjf.py and
test_torch_verlet_fixes.py, one file each so that each stays short.
Here also: setup against the port's fast engine at t0 (1e-10 x max|f|,
energies 1e-8), the replica keys bit for bit, the replica runner bit for
bit against one-run runs, the scenes bit for bit, the reference's
validation errors."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lammps_le_tpu.scene as jscene
import lammps_le_torch.fixes as tf
from lammps_le_torch import scene as tscene
from lammps_le_torch.fast import from_fast, to_fast
from lammps_le_torch.integrate import Simulation, make_step, run, setup
from lammps_le_torch.parallel import (gather_replica_state,
                                      make_replica_runner, replicate_state,
                                      sharded_replica_state)
from lammps_le_torch.state import state_from_arrays
from lammps_le_tpu.parallel import replica as jreplica
from torch_parity import (GENERAL_INTS, check_general_f64, general_sims,
                          general_start, jax_state, le_fixes, make_system)


def test_trajectory_le():
    """The LE production mix in f64: every event kind fires."""
    ts = check_general_f64("le")
    assert int(ts.n_moves) > 0 and int(ts.n_loads) > 0
    assert int(ts.n_unloads) > 0


def test_setup_against_fast_engine():
    """The general path's setup against the port's fast engine at t0
    (to_fast / from_fast) in f64 (tests/test_fastpath.py:79-90)."""
    _, tsim = general_sims("le", "float64")
    st = state_from_arrays(general_start("float64"), "cpu")
    g = setup(tsim, st)
    fast = from_fast(to_fast(st, tsim), tsim.system)
    scale = float(g.f.abs().max())
    assert float((fast.f - g.f).abs().max()) < 1e-10 * max(scale, 1.0)
    assert abs(float(g.epair) - float(fast.epair)) < 1e-8
    assert abs(float(g.ebond) - float(fast.ebond)) < 1e-8
    assert int(g.flags) == int(fast.flags) == 0


def test_replicate_state_keys():
    st = state_from_arrays(general_start("float64"), "cpu")
    rep = replicate_state(st, 3, seed=17)
    ref = jreplica.replicate_state(
        jax_state(general_start("float64"), jnp.float64), 3, seed=17)
    np.testing.assert_array_equal(np.asarray(ref.key), rep.key.numpy())
    assert tuple(rep.x.shape) == (3, 500, 3)
    assert torch.equal(rep.x[2], st.x)


def test_replica_runner():
    """Two replicas through make_replica_runner, bit for bit two one-run
    runs of make_step with their keys."""
    _, tsim = general_sims("le", "float32")
    st = state_from_arrays(general_start("float32"), "cpu")
    setup_fn, segment = make_replica_runner(tsim, device="cpu")
    out = segment(setup_fn(replicate_state(st, 2, seed=5)), 8)
    step = make_step(tsim, device="cpu")
    for r in range(2):
        one = setup(tsim, st.replace(key=replicate_state(st, 2, 5).key[r]))
        words = tuple(one.key.tolist())
        for i in range(1, 9):
            one = step(one, int(st.step) + i, words)
        for k in GENERAL_INTS + ("x", "v", "f"):
            assert torch.equal(getattr(out, k)[r], getattr(one, k)), k
    assert not torch.equal(out.x[0], out.x[1])


def test_replica_runner_over_a_mesh(monkeypatch):
    """Four replicas in f64 over a mesh of two CPU devices (two blocks,
    each stepped by its own device's make_step, step i issued on both
    before step i + 1): bit for bit the one-card runner; and against the
    reference's meshed runner (a jax.sharding.Mesh over 4 virtual CPU
    devices, its segment compiled with LLVM's optimisations off) from the
    reference's setup of the same start: integer fields bit for bit, x
    and v within 1e-9, the general path's tolerance."""
    import jax
    from jax.sharding import Mesh

    from torch_parity import UnoptimisedJax, _ref_setup

    rsim, tsim = general_sims("le", "float64")
    d = general_start("float64")
    st = state_from_arrays(d, "cpu")
    mesh = ["cpu", torch.device("cpu", 0)]
    setup_fn, segment = make_replica_runner(tsim, mesh=mesh)
    blocks = sharded_replica_state(replicate_state(st, 4, seed=5), mesh)
    assert [b.key.shape[0] for b in blocks] == [2, 2]
    got = gather_replica_state(segment(setup_fn(blocks), 4))
    setup1, segment1 = make_replica_runner(tsim, device="cpu")
    one = segment1(setup1(replicate_state(st, 4, seed=5)), 4)
    for k in GENERAL_INTS + ("x", "v", "f", "key"):
        assert torch.equal(getattr(got, k), getattr(one, k)), k
    with pytest.raises(ValueError, match="divisible"):
        sharded_replica_state(replicate_state(st, 3), mesh)

    monkeypatch.setattr(jreplica, "jax", UnoptimisedJax())
    jmesh = Mesh(np.asarray(jax.devices()[:4]), ("dp",))
    _, jsegment = jreplica.make_replica_runner(rsim, mesh=jmesh)
    js = jreplica.sharded_replica_state(jreplica.replicate_state(
        _ref_setup("float64")(jax_state(d, jnp.float64)), 4, seed=5), jmesh)
    rs = jsegment(js, 4)
    for k in GENERAL_INTS:
        np.testing.assert_array_equal(np.asarray(getattr(rs, k)),
                                      getattr(got, k).numpy(), err_msg=k)
    for k in ("x", "v"):
        assert float(np.abs(np.asarray(getattr(rs, k))
                            - getattr(got, k).numpy()).max()) <= 1e-9, k


@pytest.mark.parametrize("gen", ["fene_melt", "chromosome"])
def test_scenes_bitwise(gen):
    args = ((4, 25), dict(seed=3)) if gen == "fene_melt" else (
        (300,), dict(barrier_fraction=0.05, seed=9))
    a = getattr(jscene, gen)(*args[0], **args[1])
    b = getattr(tscene, gen)(*args[0], **args[1])
    for field in dataclasses.fields(a):
        va, vb = getattr(a, field.name), getattr(b, field.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, field.name
            np.testing.assert_array_equal(va, vb, err_msg=field.name)
        else:
            assert va == vb, field.name


@dataclasses.dataclass(frozen=True)
class _Mystery:
    group: str = None


@pytest.mark.parametrize("fixes,match", [
    ((tf.NVELimit(xmax=0.1), tf.Langevin(1.0, 1.0, 1.0, gjf="vfull")),
     "exactly one group-all fix nve"),
    ((tf.NVE(), tf.Langevin(1.0, 1.0, 1.0, gjf="bogus")), "vfull"),
    ((tf.NVE(), tf.Langevin(1.0, 1.0, 1.0, gjf="vhalf"),
      tf.Langevin(1.0, 1.0, 1.0, gjf="vfull")), "at most one fix langevin"),
    ((tf.NVE(), tf.Langevin(1.0, 1.0, 1.0, tally=True),
      tf.Langevin(1.0, 1.0, 2.0, tally=True)), "tally yes"),
    ((tf.NVE(), _Mystery()), "registered fix style"),
])
def test_validation_errors(fixes, match):
    """The reference's errors (test_langevin_gjf.py:178,
    test_fix_registry.py:95)."""
    system, _ = make_system()
    with pytest.raises(ValueError, match=match):
        make_step(Simulation(system=system, dt=0.1, fixes=fixes),
                  device="cpu")


def test_special_bonds_with_extruders_rejected():
    system, _ = make_system()
    system = system.replace(special_lj=(0.0, 0.5, 1.0))
    with pytest.raises(ValueError, match="special_bonds"):
        make_step(Simulation(system=system, dt=0.005, ex_btype=2,
                             fixes=le_fixes(tf)), device="cpu")
    with pytest.raises(KeyError, match="undefined group"):
        make_step(Simulation(system=system, dt=0.005,
                             fixes=(tf.NVE(group="nowhere"),)), device="cpu")


def test_make_step_defaults_to_the_card():
    """Without a device make_step builds on the card, and without one it
    raises rather than run on the CPU; ``run`` runs where its state
    lies."""
    _, tsim = general_sims("le", "float32")
    if torch.cuda.is_available():
        make_step(tsim)
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make_step(tsim)
    st, rows = run(tsim, state_from_arrays(general_start("float32"), "cpu"), 2)
    assert st.x.device.type == "cpu" and rows == []
