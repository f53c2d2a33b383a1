"""The deck's host modules against the reference's on the CPU, and the
port's runner through control flow.

``parse_deck``, the ``ScriptInterpreter`` (variables, loop/label/jump/
next, if/else, include, print, run upto) against a recording runner,
``AtomExpr``, the runner's computes, ``fix ave/time`` and ``fix
ave/chunk`` on the same states: equal (the same host arithmetic on the
same arrays).  Then tiny decks through the port's ``DeckRunner``: loops,
if/else, include with ``run upto``, and the unknown thermo column
error."""

import os

import numpy as np
import pytest

from lammps_le_torch.deck import DeckError, DeckRunner
from lammps_le_tpu.io.data import write_data
from lammps_le_tpu.scene import serpentine

HEADER = """
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
thermo 10
timestep 0.005
"""

PARSE_TEXT = """
# a comment line
variable T equal 1.5
units lj   # trailing comment
pair_coeff * * 1.0 1.0 &
    1.12
fix 2 all langevin $T ${T} 10.0 "904297"
thermo_style custom step temp v_x
print "a b   c"
run 10
"""

SCRIPT = """
variable T equal 2*3+1
variable name string hot
variable i loop 3
label top
print "stage $i of ${name}"
if "$i == 2" then "run 5" "print two" else "run 7"
next i
jump SELF top
variable w index a b
print "w=$w"
next w
print "w=$w"
variable n equal 4
if "($n > 3) && (${name} == hot)" then "print both"
include inc.txt
variable z equal $T*2
variable z delete
run 50 upto
run 50 upto
print "T=$T"
"""


class RecordingRunner:
    """What the ScriptInterpreter needs of a runner, recording the
    commands and log lines it is handed; ``run`` advances the step."""

    def __init__(self, root):
        self.root = root
        self.state = None
        self.timestep0 = 0
        self.atom_vars = {}
        self.atom_var_scalars = {}
        self.script_vars = {}
        self.seen = []

    def log(self, msg):
        self.seen.append(("log", msg))

    def command(self, name, args, raw=""):
        self.seen.append((name, tuple(args)))
        if name == "run":
            self.timestep0 += int(args[0])

    def live_value(self, key):
        return 3.0


def test_parse_deck_matches_reference():
    """Comments, continuation lines, ``$x`` / ``${x}`` substitution and
    quotes parse to the reference's commands."""
    from lammps_le_torch.deck import parse_deck
    from lammps_le_tpu.deck import parse_deck as ref_parse

    def flat(deck):
        return [(c.name, tuple(c.args), c.raw) for c in deck.commands]

    got = flat(parse_deck(PARSE_TEXT, {"x": "7"}))
    assert got == flat(ref_parse(PARSE_TEXT, {"x": "7"}))
    assert ("pair_coeff", ("*", "*", "1.0", "1.0", "1.12")) in [
        g[:2] for g in got]


def test_script_interpreter_matches_reference(tmp_path):
    """One script through the reference's and the port's interpreter on a
    recording runner: the same commands, log lines and variables."""
    from lammps_le_torch.deck.script import ScriptInterpreter
    from lammps_le_tpu.deck.script import ScriptInterpreter as RefInterp

    with open(os.path.join(tmp_path, "inc.txt"), "w") as fh:
        fh.write("print included\nrun 3\n")
    path = os.path.join(tmp_path, "in.script")
    with open(path, "w") as fh:
        fh.write(SCRIPT)
    out = []
    for cls in (RefInterp, ScriptInterpreter):
        runner = RecordingRunner(str(tmp_path))
        interp = cls(runner, {"extra": "1"})
        interp.run_file(path)
        out.append((runner.seen, {k: str(v) for k, v in interp.vars.items()},
                    runner.timestep0))
    assert out[0] == out[1]
    seen = out[1][0]
    assert ("log", "stage 2 of hot") in seen and ("log", "two") in seen
    assert ("log", "w=b") in seen and ("log", "both") in seen
    assert out[1][2] == 50  # 7 + 5 + 7 + 3, then upto 50, then nothing


def _built_pair(tmp_path, body):
    """The reference's and the port's runner (f64, CPU) after ``HEADER +
    body`` with the system and start state built, no step run."""
    from lammps_le_tpu.deck import DeckRunner as RefRunner

    td = str(tmp_path)
    os.makedirs(td, exist_ok=True)
    write_data(os.path.join(td, "data.tiny"),
               serpentine(200, seed=7, n_atom_types=4, n_bond_types=2,
                          barrier_fraction=0.02))
    path = os.path.join(td, "in.deck")
    with open(path, "w") as fh:
        fh.write(HEADER + body)
    out = []
    for r in (RefRunner(dtype="float64", quiet=True),
              DeckRunner(dtype="float64", quiet=True, device="cpu")):
        r.run_file(path)
        r._build()
        out.append(r)
    return out


def _snapshots(rr, tr, n=5):
    """The same n States for both runners: the built start moved along a
    fixed displacement and velocity field, at steps 0, 5, 10, ..."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(1)
    dx = rng.normal(scale=0.05, size=(200, 3))
    dv = rng.normal(scale=0.2, size=(200, 3))
    x0 = np.asarray(rr.state.x)
    v0 = np.asarray(rr.state.v)
    np.testing.assert_array_equal(x0, tr.state.x.numpy())
    np.testing.assert_array_equal(v0, tr.state.v.numpy())
    out = []
    for k in range(n):
        x, v = x0 + k * dx, v0 + k * dv
        f = np.sin(x) * k
        out.append((
            rr.state.replace(x=jnp.asarray(x), v=jnp.asarray(v),
                             f=jnp.asarray(f),
                             step=jnp.asarray(5 * k, jnp.int32)),
            tr.state.replace(x=torch.as_tensor(x), v=torch.as_tensor(v),
                             f=torch.as_tensor(f),
                             step=torch.tensor(5 * k))))
    return out


COMPUTES = """
group t1 type 1
compute rg all gyration
compute rg1 t1 gyration
compute msd all msd
compute msd1 t1 msd
compute k all ke
compute k1 t1 ke
compute c all com
compute t all temp
compute tc all temp/com
compute tp all temp/partial 1 0 1
compute va all vacf
compute mol all chunk/atom molecule
compute typ all chunk/atom type
compute cm all com/chunk typ
compute gc all gyration/chunk typ
compute mc all msd/chunk typ
compute vc all vcm/chunk typ
compute ic all inertia/chunk mol
compute ac all angmom/chunk mol
compute qc all torque/chunk mol
compute tk all temp/chunk typ com yes
compute ka all ke/atom
compute da all displace/atom
compute pa all property/atom xu vz fx type mol
compute red all reduce sum c_ka
compute rmax all reduce max c_pa[2]
variable ke atom vx*vx+vy*vy+vz*vz
variable two equal 2.0
compute rv all reduce ave v_ke
fix avg all ave/time 5 2 10 c_t file temp.ave
fix avv all ave/time 5 2 10 c_cm[*] mode vector file vec.ave
fix ach all ave/chunk 5 2 10 typ vx x v_ke c_ka c_pa[1] file chunk.ave
"""

SCALARS = ("c_rg", "c_rg1", "c_msd", "c_msd1", "c_k", "c_k1", "c_c[1]",
           "c_c[2]", "c_c[3]", "c_t", "c_tc", "c_tp", "c_va[1]", "c_va[4]",
           "c_cm[3]", "c_gc[2]", "c_mc[1]", "c_tk[2]", "c_red", "c_rmax",
           "c_rv")
ATOM_EXPRS = ("vx*vx+vy*vy+vz*vz", "sqrt(x*x+y*y)/v_two", "xu-zu+yu",
              "type*mol+id", "fx-fy*fz", "exp(-abs(vz))", "floor(x)")


def test_computes_and_averages_match_reference(tmp_path):
    """The runner's scalar computes, per-chunk tables, per-atom computes
    and atom-style expressions on five shared States, and the ave/time
    (scalar and vector) and ave/chunk files they feed: the reference's
    values within 1e-12 and its files equal."""
    from lammps_le_torch.deck.atomvars import AtomExpr
    from lammps_le_tpu.deck.atomvars import AtomExpr as RefExpr

    rr, tr = _built_pair(tmp_path / "a", COMPUTES)
    tr.root = str(tmp_path / "b")
    os.makedirs(tr.root)
    for d in tr.dumps:
        d.path = os.path.join(tr.root, os.path.basename(d.path))
    scal = {"two": 2.0}
    for rs, ts in _snapshots(rr, tr):
        rr.state, tr.state = rs, ts
        for key in SCALARS:
            want = rr.live_value(key)
            assert abs(tr.live_value(key) - want) <= 1e-12 * max(
                1.0, abs(want)), key
        for cid in ("cm", "gc", "mc", "vc", "ic", "ac", "qc", "tk"):
            np.testing.assert_allclose(tr._chunk_table(cid, ts),
                                       rr._chunk_table(cid, rs),
                                       rtol=1e-12, atol=1e-12, err_msg=cid)
        for cid in ("ka", "da", "pa"):
            np.testing.assert_allclose(tr._peratom_value(cid, ts),
                                       rr._peratom_value(cid, rs),
                                       rtol=1e-12, atol=1e-12, err_msg=cid)
        for text in ATOM_EXPRS:
            np.testing.assert_array_equal(
                AtomExpr("e", text).evaluate(ts, tr.system, scal),
                RefExpr("e", text).evaluate(rs, rr.system, scal))
        for r, s in ((rr, rs), (tr, ts)):
            for d in r.dumps:
                d.sample(s, r.system)
    for r in (rr, tr):
        for d in r.dumps:
            d.close()
    for name in ("temp.ave", "vec.ave", "chunk.ave"):
        with open(os.path.join(rr.root, name)) as a, \
                open(os.path.join(tr.root, name)) as b:
            want, got = a.read(), b.read()
        assert want.count("\n") >= 3 and got == want, name


def _port(tmp_path, body):
    td = str(tmp_path)
    write_data(os.path.join(td, "data.tiny"),
               serpentine(200, seed=7, n_atom_types=4, n_bond_types=2,
                          barrier_fraction=0.02))
    with open(os.path.join(td, "stage.inc"), "w") as fh:
        fh.write("run 15\n")
    path = os.path.join(td, "in.deck")
    with open(path, "w") as fh:
        fh.write(HEADER + body)
    r = DeckRunner(dtype="float32", quiet=True, device="cpu")
    logged = []
    r.log = logged.append
    return r, path, logged


@pytest.mark.parametrize("body,steps,lines", [
    ("variable i loop 3\nlabel stage\nprint \"stage $i begins\"\nrun 10\n"
     "next i\njump SELF stage\nprint done\n", 30,
     ["stage 1 begins", "stage 2 begins", "stage 3 begins", "done"]),
    ("variable mode string hot\n"
     "if \"${mode} == hot\" then \"run 10\" else \"run 20\"\n"
     "variable n equal 2*5+10\nif \"$n > 15\" then \"run $n\"\n", 30, []),
    ("include stage.inc\nrun 40 upto\nrun 40 upto\n", 40, []),
], ids=["loop_jump_next", "if_else", "include_run_upto"])
def test_port_deck_control_flow(tmp_path, body, steps, lines):
    """Staged decks through the port's runner on the CPU: the step count
    the control flow implies (tests/test_deck_controlflow.py's cases),
    the printed lines, thermo rows on the general path and no flags."""
    r, path, logged = _port(tmp_path, body)
    r.run_file(path)
    assert int(r.state.step) == steps
    assert [m for m in logged if m in lines] == lines
    assert any(m.startswith("Engine: general (small CPU run") for m in logged)
    assert int(r.state.flags) == 0


def test_port_unknown_thermo_column_errors(tmp_path):
    """An unknown thermo column is refused at the run (thermo.cpp
    parse_fields), before a step."""
    r, path, _ = _port(tmp_path, "thermo_style custom step temp "
                                 "f_nosuch[1]\nrun 10\n")
    with pytest.raises(DeckError, match="f_nosuch"):
        r.run_file(path)
    assert int(r.state.step) == 0
