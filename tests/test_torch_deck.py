"""The port's deck runner against the reference's on the CPU.

One deck (tests/test_deck.py's DECK: FENE + harmonic extruder springs,
nve + langevin + extrusion + ex_load + ex_unload, 40 + 20 steps) in f64 on
a 250-bead serpentine through both runners, with custom thermo columns
(``f_loop[2]`` and the other LE counters, live ``v_`` variables), a
custom dump with an atom-style variable and a local bond dump,
``write_data`` and a checkpoint: thermo rows within 1e-9 x max(1,
|value|), integer fields and the LE counters bit for bit, the dump files
equal.  Both runners take the general path (a small CPU run), the
reference's run computed once for the module.  The computes and the
averaging fixes are held to the reference in
``test_torch_deck_script.py``."""

import functools
import os
import tempfile

import numpy as np
import pytest
import torch

import torch_parity as tp
from lammps_le_torch.deck import DeckError, DeckRunner
from lammps_le_torch.io.data import read_data
from lammps_le_tpu.io.data import write_data
from lammps_le_tpu.scene import serpentine

DECK = """
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
variable tt equal temp*2
variable ke atom vx*vx+vy*vy+vz*vz
thermo_style custom step temp epair emol etotal press pe ke extruders f_loop[1] f_loop[2] f_loading[2] f_unloading[2] v_tt
thermo 20
timestep 0.005
dump d1 all custom 20 traj.dump id mol type x y z vx ix iy iz v_ke
compute bl all property/local btype batom1 batom2
dump d2 all local 20 bonds.dump c_bl[1] c_bl[2] c_bl[3]
run 40
write_data out.data
write_restart out.ckpt.npz
run 20
"""

INTS = ("img", "type", "ex_left", "ex_right", "step", "flags", "n_moves",
        "n_loads", "n_unloads", "last_event")
OUT_FILES = ("traj.dump", "bonds.dump")


def _deck_dir():
    td = tempfile.mkdtemp(prefix="deck_")
    data = serpentine(250, seed=7, n_atom_types=4, n_bond_types=2,
                      barrier_fraction=0.02)
    write_data(os.path.join(td, "data.tiny"), data)
    with open(os.path.join(td, "in.tiny"), "w") as fh:
        fh.write(DECK)
    return td


def _run(runner):
    logged = []
    runner.log = logged.append
    td = _deck_dir()
    runner.run_file(os.path.join(td, "in.tiny"))
    return runner, logged, td


@functools.lru_cache(maxsize=None)
def ref_run():
    """The reference's run, its general path's segment, setup and
    pressure compiled with LLVM's optimisations off."""
    import lammps_le_tpu.integrate.verlet as jverlet
    import lammps_le_tpu.observe.pressure as jpressure
    from lammps_le_tpu.deck import DeckRunner as RefRunner

    saved = jverlet.jax, jpressure.jax
    jverlet.jax = jpressure.jax = tp.UnoptimisedJax()
    try:
        return _run(RefRunner(dtype="float64", quiet=True))
    finally:
        jverlet.jax, jpressure.jax = saved


@functools.lru_cache(maxsize=None)
def port_run():
    return _run(DeckRunner(dtype="float64", quiet=True, device="cpu"))


def _rows(logged):
    return [line.split() for line in logged
            if line.split() and line.split()[0].lstrip("-").isdigit()]


def test_deck_thermo_matches_reference():
    """Same headers, Engine lines and rows (six significant digits as
    printed, each within 1e-9 x max(1, |value|) of the reference's), and
    every thermo keyword live at the end within 1e-9."""
    (rr, rlog, _), (tr, tlog, _) = ref_run(), port_run()
    heads = [line for line in rlog if line.split()[0] == "Step"]
    assert heads and heads == [line for line in tlog
                               if line.split()[0] == "Step"]
    assert [line for line in rlog if line.startswith("Engine:")] == \
        [line for line in tlog if line.startswith("Engine:")]
    rrows, trows = _rows(rlog), _rows(tlog)
    assert len(rrows) == len(trows) == 5
    for a, b in zip(rrows, trows):
        assert len(a) == len(b) == 14
        for u, v in zip(a, b):
            u, v = float(u), float(v)
            assert abs(u - v) <= 1e-9 * max(1.0, abs(u)), (a, b)
    for key in ("temp", "epair", "emol", "etotal", "press", "pe", "ke",
                "vol", "density", "extruders", "step", "f_loop[1]",
                "f_loop[2]", "f_loading[2]", "f_unloading[2]"):
        want = rr.live_value(key)
        got = tr.live_value(key)
        assert abs(got - want) <= 1e-9 * max(1.0, abs(want)), key
    assert int(tr.state.n_loads) > 0 and int(tr.state.n_moves) > 0


def test_deck_state_matches_reference():
    """Integer fields and the LE counters bit for bit; positions and
    velocities within 1e-9; the State's int64 key words are the
    reference's uint32 ones."""
    (rr, _, _), (tr, _, _) = ref_run(), port_run()
    rs, ts = rr.state, tr.state
    for k in INTS + ("key",):
        np.testing.assert_array_equal(np.asarray(getattr(rs, k)),
                                      getattr(ts, k).numpy(), err_msg=k)
    for k in ("x", "v"):
        assert float(np.abs(np.asarray(getattr(rs, k))
                            - getattr(ts, k).numpy()).max()) <= 1e-9, k
    assert int(ts.step) == 60 and int(ts.flags) == 0
    assert tr.last_perf["steps"] == 20


@pytest.mark.parametrize("name", OUT_FILES)
def test_deck_outputs_match_reference(name):
    """The dump frames of the second run (custom with an atom-style
    variable, local bond frames with the live extruder bonds; each run
    opens its dumps anew) are the reference's, byte for byte."""
    (_, _, rtd), (_, _, ttd) = ref_run(), port_run()
    with open(os.path.join(rtd, name)) as a, open(os.path.join(ttd,
                                                             name)) as b:
        want, got = a.read(), b.read()
    assert want.count("ITEM: TIMESTEP") == 2
    assert got == want


def test_deck_write_data_matches_reference():
    """``write_data`` at step 40 reads back to the reference's arrays:
    integers equal, coordinates and velocities within 1e-9."""
    (_, _, rtd), (_, _, ttd) = ref_run(), port_run()
    a = read_data(os.path.join(rtd, "out.data"))
    b = read_data(os.path.join(ttd, "out.data"))
    assert b.n_atoms == 250 and a.n_bonds == b.n_bonds
    for k in ("types", "molecule", "image", "bonds", "masses"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)
    for k in ("x", "v"):
        assert float(np.abs(getattr(a, k) - getattr(b, k)).max()) <= 1e-9


def test_deck_restart_resume_bitwise():
    """Resuming from the port's ``write_restart`` checkpoint (step 40) in a
    fresh runner and running 20 steps is bit for bit the uninterrupted
    run; the reference loads the same checkpoint to the same State."""
    from lammps_le_tpu.io.checkpoint import load_checkpoint

    (rr, _, _), (tr, _, ttd) = ref_run(), port_run()
    r2 = DeckRunner(dtype="float64", quiet=True, device="cpu")
    r2.root = ttd
    for line in DECK.strip().splitlines():
        parts = line.split()
        if parts[0] in ("run", "write_data", "write_restart", "velocity",
                        "dump", "variable", "thermo_style", "compute"):
            continue
        r2.command(parts[0], parts[1:])
    r2.command("read_restart", ["out.ckpt.npz"])
    assert int(r2.state.step) == 40
    r2.log = lambda msg: None
    r2.command("run", ["20"])
    for k in INTS + ("x", "v"):
        np.testing.assert_array_equal(getattr(r2.state, k).numpy(),
                                      getattr(tr.state, k).numpy(),
                                      err_msg=k)
    back = load_checkpoint(os.path.join(ttd, "out.ckpt.npz"),
                           like=rr.state)
    assert int(back.step) == 40


def test_compute_pair_nsub_known_reference_fault():
    """``compute ID all pair lj/cut 1`` is accepted by both runners for a
    plain lj/cut pair style (runner.py:796): a known fault of the
    reference (ROADMAP Queue 3 item 3; LAMMPS's compute_pair.cpp refuses
    an nsub for a style that is not hybrid), ported as it is.  nsub 2 is
    refused by both."""
    from lammps_le_tpu.deck import DeckRunner as RefRunner
    from lammps_le_tpu.deck.runner import DeckError as RefError

    for r in (RefRunner(quiet=True), DeckRunner(quiet=True, device="cpu")):
        r.command("compute", ["p", "all", "pair", "lj/cut", "1"])
        assert r.computes["p"] == {"style": "pair", "group": "all"}
    with pytest.raises(RefError):
        RefRunner(quiet=True).command(
            "compute", ["p", "all", "pair", "lj/cut", "2"])
    with pytest.raises(DeckError):
        DeckRunner(quiet=True, device="cpu").command(
            "compute", ["p", "all", "pair", "lj/cut", "2"])


def test_deck_runner_needs_a_card_unless_asked_for_the_cpu():
    """``DeckRunner()`` runs on the card: without one it raises, and
    ``device="cpu"`` runs on the CPU."""
    assert DeckRunner(device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert DeckRunner().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeckRunner()
