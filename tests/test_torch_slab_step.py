"""The slab-resident segment (parallel/slab_step.py through
``make_sharded_segment`` on a ``shard_fast_state``) against the
whole-state chain on the same slab stencil (``make_fast_segment(sim,
pallas=False, kernel_fn=make_sharded_kernel(...))``), on melt32 with the
three LE fixes at dt 0.014, one step a call for 11 steps: the window holds
rebuilds, LE events and a fired skin trigger (checked), at sp = 2 and 4,
with the Langevin fix on all beads, on the group of beads 1-400, and on
that group with ``zero``.

Integer planes, slots, tables, counters, flags and the trigger of every
step are bit for bit the whole-state run's.  Positions and velocities
are too, but with ``zero``: its group means are sums over all slabs, and
the slab step adds the slabs' sums in slab order where the whole plane
sums at once, so the means differ in their last bits (f32: ~1e-7 of a mean); after 11
steps positions stay within 2e-6 and velocities within 1e-4 (2.4e-7 and
4.3e-6 measured: each step's noise force moves by the means' shift,
and the melt's dynamics amplify it).  The reference's own 20-step run is held to the slab-resident
path in tests/test_torch_segment.py."""

import dataclasses

import numpy as np
import pytest
import torch

import lammps_le_torch.fixes as tf
from lammps_le_torch.fast import make_fast_segment, to_fast
from lammps_le_torch.integrate import Simulation
from lammps_le_torch.parallel.spatial import (ShardedFastState,
                                              gather_fast_state,
                                              make_sharded_segment,
                                              shard_fast_state)
from torch_parity import le_fixes, melt_arrays, start_state

STEPS = 11
INTS = ("bid", "hn", "pid", "slot_of", "exl_slot", "exr_slot", "types",
        "img", "ex_left", "ex_right", "flags", "n_moves", "n_loads",
        "n_unloads", "n_clamps", "last_event")
FLOATS = ("gx", "gv", "gf", "gx_ref", "epair", "ebond")


def _sim(lan):
    """melt32 at dt 0.014 (its skin trigger fires in the window), rebuild
    every 40, energies every 4, the LE fixes with the Langevin fix on
    all beads, on ``chain``, or on ``chain`` with zero."""
    system, _ = melt_arrays()
    system = system.replace(neighbor=dataclasses.replace(
        system.neighbor, rebuild_every=40))
    fixes = list(le_fixes(tf))
    if lan != "all":
        fixes[1] = tf.Langevin(t_start=1.0, t_stop=1.0, damp=10.0,
                               seed=904297, zero=lan == "zero",
                               group="chain")
    return Simulation(system=system, dt=0.014, energy_every=4,
                      fixes=tuple(fixes), ex_btype=2)


def _groups(lan):
    member = np.arange(500) < 400
    return None if lan == "all" else {"chain": member}


def _stepped(segment, fs):
    """``STEPS`` steps one a call: (the state, each step's trigger)."""
    b = fs.step
    fired = []
    for i in range(STEPS):
        segment(fs, b + i, 1, b, b + STEPS)
        fired.append(fs.skin_pend)
    return fs, fired


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("lan", ["all", "group", "zero"])
def test_slab_segment_matches_whole_state(sp, lan):
    sim = _sim(lan)
    mesh = ["cpu"] * sp
    seg = make_sharded_segment(sim, mesh)
    assert seg.shard_reason is None
    start = to_fast(start_state(), sim, _groups(lan),
                    kernel_fn=seg.kernel_fn)
    whole, _ = make_fast_segment(sim, pallas=False, kernel_fn=seg.kernel_fn,
                                 device="cpu")
    want, fired = _stepped(whole, dataclasses.replace(start))
    sfs, got_fired = _stepped(seg, shard_fast_state(start, mesh))
    assert isinstance(sfs, ShardedFastState) and len(sfs.gx) == sp
    got = gather_fast_state(sfs)
    assert got_fired == fired and any(fired[:-1])
    assert (got.step, got.n_rebuilds) == (want.step, want.n_rebuilds)
    assert want.n_rebuilds > sum(fired) and int(want.n_moves) > 0
    assert int(want.n_loads) > 0 and int(want.n_unloads) > 0
    for name in INTS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if lan != "zero":
        for name in FLOATS:
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        return
    assert torch.equal(got.lgm, want.lgm)
    assert float((got.gx - want.gx).abs().max()) <= 2e-6
    assert float((got.gv - want.gv).abs().max()) <= 1e-4
    assert not torch.equal(got.gv, want.gv)


def test_sharded_segment_takes_the_slab_resident_state():
    """A whole FastState raises TypeError naming shard_fast_state; a
    state of another slab count ValueError."""
    sim = _sim("all")
    seg = make_sharded_segment(sim, ["cpu"] * 2)
    fs = to_fast(start_state(), sim, kernel_fn=seg.kernel_fn)
    with pytest.raises(TypeError, match="shard_fast_state"):
        seg(fs, fs.step, 1, fs.step, fs.step + 1)
    with pytest.raises(ValueError, match="4 slabs"):
        seg(shard_fast_state(fs, ["cpu"] * 4), fs.step, 1, fs.step,
            fs.step + 1)
