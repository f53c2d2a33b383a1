"""K2's step loop and the multi-step segment of the port
(``make_fast_segment(pallas="interpret")``, lammps_le_torch/fast/
pallas_step.py) against the port's own chain, and the repaired
``run_fast`` / ``make_fast_segment`` contract: (segment, step_core) and
(state, thermo rows), the reference's keywords, the device keyword-only.
The comparisons with the reference's runs are in tests/test_torch_
segment.py, which shares them; the kernels' side (``pallas="real"``) is in
tests/test_torch_cuda.py."""

import dataclasses

import pytest

import torch

import lammps_le_torch.fixes as tf
from lammps_le_torch.fast import from_fast, make_fast_segment, run_fast
from lammps_le_torch.fast.maps import fast_maps
from lammps_le_torch.fast.pallas_step import LAUNCH_MAX, make_step_kernel
from lammps_le_torch.fast.place import GridConsts
from lammps_le_torch.integrate import Simulation
from test_torch_segment import _sims
from torch_parity import (assert_same_run, chain_run, fast_start,
                          launch_schedule, melt_arrays, port_run)


def test_quiet_window_multistep_is_the_chain_bitwise():
    """The quiet window of tests/test_pallas_step.py:252-278 (rebuild
    every 40, energy every 25, NVE + Langevin, 50 steps) in the port: the
    step loop's run is the chain's bit for bit, in the launches of the
    reference's multi-step segment, fewer than the steps."""
    system, _ = melt_arrays()
    sysq = system.replace(neighbor=dataclasses.replace(system.neighbor,
                                                       rebuild_every=40))
    sim = Simulation(system=sysq, dt=0.005, energy_every=25, ex_btype=2,
                     fixes=(tf.NVE(), tf.Langevin(1.0, 1.0, 10.0,
                                                  seed=904297)))
    chain, fired = chain_run(sim, 50)
    multi = port_run(sim, 50, "interpret")
    assert_same_run(chain, multi)
    assert chain.n_launches == 0 and int(multi.flags) == 0
    assert multi.n_launches == launch_schedule(sim, multi.step - 50, 50,
                                               fired) < 50


def test_zero_group_multistep_is_the_chain_bitwise():
    """fix langevin zero + group with all three LE fixes, 20 steps: the
    step loop's run (its group plane re-placed at each rebuild, ahead of
    the launch that commits it) is the chain's bit for bit."""
    from test_torch_langevin_options import _fixes, _groups

    system, _ = melt_arrays()
    sim = Simulation(system=system, dt=0.005, energy_every=4, ex_btype=2,
                     fixes=_fixes(tf))
    runs = []
    for pallas in (False, "interpret"):
        segment, _ = make_fast_segment(sim, pallas=pallas, device="cpu")
        fs = fast_start(sim, _groups(system.n))
        b = fs.step
        runs.append(segment(fs, b, 20, b, b + 20))
    assert_same_run(*runs)
    assert torch.equal(runs[0].lgm, runs[1].lgm)
    assert runs[1].n_launches > 0 and runs[1].n_rebuilds > 1


def test_step_loop_stops_where_the_trigger_fires():
    """A bead fast enough to pass the look-ahead bound within a few steps:
    a 16-step launch stops after the step whose trigger fires, and its
    steps are the chain's steps (one-step launches) bit for bit."""
    system, _ = melt_arrays()
    sim = Simulation(system=system, dt=0.005, ex_btype=2,
                     fixes=(tf.NVE(), tf.Langevin(1.0, 1.0, 10.0, seed=9)))
    fs = fast_start(sim)
    slot = int(fs.slot_of[250])
    cap, P = fs.bid.shape
    fs.gv[:, slot // P, slot % P] = torch.tensor([6.0, 0.0, 0.0])
    g = GridConsts.build(system, fast_maps(system), "cpu")
    call = make_step_kernel(system, fast_maps(system), 2, dt=0.005,
                            langevin=sim.fixes[1], g=g, interpret=True)
    planes = (fs.gv, fs.gf, fs.gx_ref, fs.bid, fs.hn, fs.pid, fs.exl_slot,
              fs.exr_slot, fs.ex_left >= 0, None)
    key = (7, 9)
    gx, gv, gf, stats = call(fs.gx, *planes, fs.step + 1, True, key, 1.0,
                             0.0, LAUNCH_MAX)
    d = int(stats[7])
    assert 1 < d < LAUNCH_MAX and stats[6] == 1.0
    x1, v1, f1 = fs.gx, fs.gv, fs.gf
    for s in range(d):
        x1, v1, f1, st1 = call(x1, v1, f1, *planes[2:], fs.step + 1 + s,
                               True, key, 1.0, 0.0, 1)
        assert int(st1[6]) == (s == d - 1)
    assert torch.equal(x1, gx) and torch.equal(v1, gv)
    assert torch.equal(f1, gf)


def test_stopped_launch_is_the_launch_of_its_steps():
    """The property K2's conditional graph rests on: a launch of limit 16
    that the look-ahead trigger stops after d steps is a launch of limit
    d from the same state, planes bit for bit and stats rows 2-7 equal
    (the plain loop, on the melt with a fast bead)."""
    system, _ = melt_arrays()
    sim = Simulation(system=system, dt=0.005, ex_btype=2,
                     fixes=(tf.NVE(), tf.Langevin(1.0, 1.0, 10.0, seed=9)))
    fs = fast_start(sim)
    slot = int(fs.slot_of[250])
    cap, P = fs.bid.shape
    fs.gv[:, slot // P, slot % P] = torch.tensor([6.0, 0.0, 0.0])
    g = GridConsts.build(system, fast_maps(system), "cpu")
    call = make_step_kernel(system, fast_maps(system), 2, dt=0.005,
                            langevin=sim.fixes[1], g=g, interpret=True)
    args = (fs.gx, fs.gv, fs.gf, fs.gx_ref, fs.bid, fs.hn, fs.pid,
            fs.exl_slot, fs.exr_slot, fs.ex_left >= 0, None, fs.step + 1,
            True, (7, 9), 1.0, 0.0)
    *planes16, st16 = call(*args, LAUNCH_MAX)
    d = int(st16[7])
    assert 1 < d < LAUNCH_MAX and st16[6] == 1.0
    *planes_d, st_d = call(*args, d)
    assert all(torch.equal(a, b) for a, b in zip(planes16, planes_d))
    assert torch.equal(st16[2:], st_d[2:])


def test_segment_contract():
    """make_fast_segment returns (segment, step_core) and run_fast (State,
    rows), a positional thermo_every a row a step; a positional
    thermo_every does not reach make_fast_segment's device; reactive=False and hot windows
    raise; the thermo cadence lowers the energy cadence to their gcd;
    pallas='real' needs the card, and its call CUDA tensors."""
    system, _ = melt_arrays()
    sim = _sims(system, 4)[1]
    segment, step_core = make_fast_segment(sim, device="cpu")
    fs = fast_start(sim)
    b = fs.step
    step_core(fs, b + 1, b, b + 2)
    segment(fs, b + 1, 1, b, b + 2)
    assert fs.step == b + 2
    st, rows = run_fast(sim, from_fast(fs, system), 2, 1)
    assert int(st.step) == b + 4
    assert [r.step for r in rows] == [b + 2, b + 3, b + 4]
    with pytest.raises(TypeError):
        make_fast_segment(sim, "cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        make_fast_segment(sim, reactive=False, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        make_fast_segment(sim, hot_window=8, device="cpu")
    with pytest.raises(ValueError):
        make_fast_segment(sim, pallas="real", device="cpu")
    g = GridConsts.build(system, fast_maps(system), "cpu")
    call = make_step_kernel(system, fast_maps(system), 2, dt=0.005,
                            langevin=None, g=g)
    with pytest.raises(ValueError, match="CUDA"):
        call(fs.gx, fs.gv, fs.gf, fs.gx_ref, fs.bid, fs.hn, fs.pid,
             fs.exl_slot, fs.exr_slot, fs.ex_left >= 0, None, b + 3, True,
             (0, 0), 1.0, 0.0, 1)
    # energy every 4 and thermo every 6: energies every 2 steps, so the
    # second step (an even one) evaluates them
    seg6, _ = make_fast_segment(sim, 6, pallas="interpret", device="cpu")
    seg4, _ = make_fast_segment(sim, pallas="interpret", device="cpu")
    fs4, fs6 = fast_start(sim), fast_start(sim)
    e0 = float(fs4.epair)
    seg4(fs4, b, 2, b, b + 2)
    seg6(fs6, b, 2, b, b + 2)
    assert (b + 2) % 4 and not (b + 2) % 2
    assert float(fs4.epair) == e0 != float(fs6.epair)
