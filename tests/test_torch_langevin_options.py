"""fix langevin zero and group on the port's fast engine, against the
reference's (tests/test_langevin_options_fast.py pins the reference).

melt32 with all three LE fixes and a Langevin fix that thermostats only
the id-range group ``chain`` (beads 1-400 of 500) with ``zero yes``, for
20 steps: the port's segment gives the reference XLA chain's extruder
tables, counters, flags, step and rebuilds, positions within 1e-3, and
its group plane after the rebuilds is the reference's bit for bit.  Zero
moves each member's force by one per-component constant and leaves the
non-members' alone; a named group without the deck's masks is refused."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

import lammps_le_tpu.fixes as jf
import lammps_le_torch.fixes as tf
from lammps_le_torch.fast import kernels as K
from lammps_le_torch.fast import make_fast_segment, to_fast
from lammps_le_torch.fast.maps import fast_maps
from lammps_le_torch.integrate import Simulation
from lammps_le_torch.state import state_from_arrays
from lammps_le_tpu.fast import engine as ref
from lammps_le_tpu.integrate import Simulation as RefSimulation
from torch_parity import (arrays_of, check_segment_pair, jax_state,
                          le_fixes, melt_arrays)

N_CHAIN = 400  # group chain id 1:400


def _groups(n):
    member = np.zeros(n, bool)
    member[:N_CHAIN] = True
    return {"chain": member}


def _fixes(mod, zero=True):
    """le_fixes with its Langevin fix on the group ``chain``."""
    fixes = list(le_fixes(mod))
    fixes[1] = mod.Langevin(t_start=1.0, t_stop=1.0, damp=10.0, seed=904297,
                            zero=zero, group="chain")
    return tuple(fixes)


@functools.lru_cache(maxsize=None)
def _ref_run(nsteps=20, energy_every=4):
    """The reference's XLA chain from the melt32 start with zero + group:
    (start arrays, its FastState)."""
    system, d = melt_arrays()
    rsim = RefSimulation(system=system, dt=0.005, energy_every=energy_every,
                         fixes=_fixes(jf), ex_btype=2)
    groups = _groups(system.n)
    js = jax_state(d, jnp.float32)
    segment, _ = ref.make_fast_segment(rsim, pallas=False)
    fj = _compiled(lambda s: ref.to_fast(s, rsim, groups=groups), js)
    b = jnp.asarray(int(fj.step), jnp.int32)
    args = (fj, b, jnp.asarray(nsteps, jnp.int32), b, b + nsteps)
    return arrays_of(js), _compiled(segment, *args)


def _compiled(fn, *args):
    """``fn(*args)``, compiled with LLVM's optimisations off: the same
    results bit for bit (tests/test_torch_place.py), in less compile
    time."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _port_run(nsteps, fixes, energy_every=4):
    """The port's segment from the melt32 start, on the CPU."""
    system, d = melt_arrays()
    start = arrays_of(jax_state(d, jnp.float32))
    sim = Simulation(system=system, dt=0.005, energy_every=energy_every,
                     fixes=fixes, ex_btype=2)
    b = int(start["step"])
    ft = to_fast(state_from_arrays(start, "cpu"), sim,
                 groups=_groups(system.n))
    segment, _ = make_fast_segment(sim, device="cpu")
    return segment(ft, b, nsteps, b, b + nsteps)


@functools.lru_cache(maxsize=None)
def _runs():
    """(reference FastState, port FastState) after the 20 steps."""
    return _ref_run()[1], _port_run(20, _fixes(tf))


def test_zero_group_segment_matches_reference_xla_chain():
    system, _ = melt_arrays()
    fj, ft = _runs()
    check_segment_pair(system, fj, ft)


def test_group_plane_after_rebuilds_is_the_reference():
    """The group plane, re-placed through the old slots at each of the
    run's rebuilds, is the reference's bit for bit."""
    fj, ft = _runs()
    assert int(ft.n_rebuilds) > 1
    np.testing.assert_array_equal(np.asarray(fj.lgm), ft.lgm.numpy())
    assert float(ft.lgm.sum()) == N_CHAIN


def test_zero_shifts_group_forces_uniformly():
    """One step with zero on and off: each member's force moves by the
    same per-component constant (minus the group's random-force mean),
    each non-member's not at all (fix_langevin.cpp's zeroflag pass)."""
    system, _ = melt_arrays()
    on, off = (_port_run(1, (tf.NVE(), _fixes(tf, zero)[1]))
               for zero in (True, False))
    capP = on.gf.shape[1] * on.gf.shape[2]
    slot = torch.clamp(on.slot_of, 0, capP - 1)
    df = (on.gf.reshape(3, capP)[:, slot]
          - off.gf.reshape(3, capP)[:, slot]).numpy()
    member = _groups(system.n)["chain"]
    assert np.max(np.abs(df[:, ~member])) == 0.0
    for c in range(3):
        d = df[c, member]
        assert np.max(np.abs(d - d.mean())) < 1e-4 * max(1.0,
                                                         abs(d.mean()))
        assert abs(d.mean()) > 0.0


@pytest.mark.parametrize("zero,group", [(True, False), (True, True),
                                        (False, True)])
def test_langevin_force_matches_reference(zero, group):
    """The Langevin random force alone (v, f, the friction and the kick 0)
    of the port's langevin_kick_monitor on the melt32 planes, against
    engine.py:1421-1435 written out in jnp on the same planes: within
    1e-6 (the group sums of ~400 terms in another order); with zero, its
    sum over the group is 0 within f32 round-off, 2e-5 a component."""
    system, d = melt_arrays()
    n = system.n
    lan = tf.Langevin(1.0, 1.0, 10.0, zero=zero,
                      group="chain" if group else None)
    sim = Simulation(system=system, dt=0.005, fixes=(tf.NVE(), lan),
                     ex_btype=2)
    ft = to_fast(state_from_arrays(arrays_of(jax_state(d, jnp.float32)),
                                   "cpu"), sim, groups=_groups(n))
    interior = torch.as_tensor(fast_maps(system).interior)
    key, sstep, gamma2 = (12345, 67890), 7, 0.9
    nil = torch.zeros_like(ft.gx)
    got = K.langevin_kick_monitor(
        ft.gx, ft.gx, nil, nil, ft.bid, interior, key, sstep, 0.0, gamma2,
        0.0, 0.005, 9.0, 9.0, n, True, ft.lgm, zero)[0].numpy()

    bid = jnp.asarray(ft.bid.numpy())
    valid = ((bid < n) & jnp.asarray(interior.numpy())[None]).astype(
        jnp.float32)[None]
    noise = ref._uniform3(jnp.asarray(key, jnp.uint32), bid,
                          jnp.asarray(sstep, jnp.int32), jnp.float32) - 0.5
    w_lan = valid
    inv_cnt = 1.0 / n
    if group:
        lgm = jnp.asarray(ft.lgm.numpy())
        w_lan = valid * lgm[None]
        inv_cnt = 1.0 / jnp.maximum(jnp.sum(lgm), 1.0)
    if zero:
        noise = noise - jnp.sum(noise * w_lan, axis=(1, 2),
                                keepdims=True) * inv_cnt
    want = np.asarray(gamma2 * noise * w_lan)
    assert np.abs(got - want).max() <= 1e-6
    if zero:
        assert np.abs(got.astype(np.float64).sum((1, 2))).max() <= 2e-5


def test_named_group_needs_groups():
    system, d = melt_arrays()
    sim = Simulation(system=system, dt=0.005, fixes=_fixes(tf), ex_btype=2)
    with pytest.raises(ValueError, match="chain"):
        to_fast(state_from_arrays(d, "cpu"), sim)
