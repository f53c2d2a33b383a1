"""The port's native LAMMPS restart (``lammps_le_torch.io.lammps_restart``)
and the deck's ``write_restart`` / ``read_restart`` of a native file,
against the JAX package's on the CPU.

``tests/data/ref_le.restart`` was written by the compiled LAMMPS binary
(120 beads, step 120, one live extruder bond): the port's reader parses
it to the reference reader's fields bit for bit, and to the binary's own
text ``write_data`` of the same state.  The writer produces the
reference writer's bytes; write -> read round trips bit for bit.  Both
runners resume from the binary's file to the same State, and a state the
port's runner writes with ``write_restart`` reads back into a fresh
runner with the same positions, velocities, images, types and extruder
table (a native restart keeps no RNG state or bond counts, so only the
fields it carries are held)."""

import functools
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lammps_le_torch.deck import DeckRunner
from lammps_le_torch.io import lammps_restart as tr
from lammps_le_tpu.io import lammps_restart as jr
from lammps_le_tpu.io.data import read_data as ref_read_data

HERE = os.path.dirname(__file__)
RST = os.path.join(HERE, "data", "ref_le.restart")
DAT = os.path.join(HERE, "data", "ref_le.data")
FIELDS = ("natoms", "ntypes", "nbondtypes", "step", "dt", "units", "box_lo",
          "box_hi", "special_lj", "masses", "pair_style", "pair_coeffs",
          "bond_styles", "x", "v", "img", "types", "molecule", "bonds",
          "version")
STATE = ("x", "v", "img", "type", "ex_left", "ex_right", "step")

HEAD = """
units lj
atom_style bond
special_bonds fene
{source}
neighbor 0.4 bin
bond_style hybrid
bond_coeff 1 fene 30.0 1.5 1.0 1.0
bond_coeff 2 harmonic 3.0 1.1
pair_style lj/cut 1.12
pair_modify shift yes
pair_coeff * * 1.0 1.0 1.12
fix 1 all nve
fix 2 all langevin 1.0 1.0 10.0 904297
fix loop all extrusion 40 1 2 3 0.5 2 4
"""


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("field", FIELDS)
def test_parse_of_the_binary_file_matches_reference(field):
    """Every field of the LAMMPS binary's restart, bit for bit and in the
    reference reader's type."""
    _same(getattr(jr.read_lammps_restart(RST), field),
          getattr(tr.read_lammps_restart(RST), field))


def test_parse_matches_the_binary_write_data():
    """The binary's own text write_data of the same state: positions,
    velocities, types and images exact; one extruder bond and 119
    backbone bonds."""
    r = tr.read_lammps_restart(RST)
    d = ref_read_data(DAT)
    assert (r.natoms, r.step, r.dt) == (120, 120, 0.006)
    for a, b in ((r.x, d.x), (r.v, d.v), (r.types, d.types),
                 (r.img, d.image)):
        np.testing.assert_array_equal(a, b)
    assert len(r.bonds[r.bonds[:, 0] == 2]) == 1
    assert len(r.bonds[r.bonds[:, 0] == 1]) == 119


def _writer_args():
    data = ref_read_data(DAT)
    ones = np.ones((4, 4))
    return data, dict(step=120, dt=0.006, special_lj=(0.0, 1.0, 1.0),
                      pair=(ones, ones, 1.12 * ones), pair_shift=True,
                      bond_styles=np.array([1, 2]),
                      bond_coeffs=np.array([[30.0, 1.5, 1.0, 1.0],
                                            [3.0, 1.1, 0.0, 0.0]]))


def test_writer_bytes_match_reference(tmp_path):
    """write_lammps_restart writes the reference writer's bytes for the
    same DataFile (hybrid bonds), and its single-style form too."""
    data, kw = _writer_args()
    for styles in (np.array([1, 2]), np.array([1, 1])):
        kw["bond_styles"] = styles
        a, b = tmp_path / "ref.restart", tmp_path / "port.restart"
        jr.write_lammps_restart(str(a), data, **kw)
        tr.write_lammps_restart(str(b), data, **kw)
        assert a.read_bytes() == b.read_bytes()


def test_write_read_round_trip_is_bitwise(tmp_path):
    """A DataFile written and read back: positions wrapped into the box
    with the shift folded into the images, so the unwrapped positions,
    velocities, types, molecules and bonds come back bit for bit."""
    data, kw = _writer_args()
    data.x = data.x + np.array([0.0, data.box_hi[1] - data.box_lo[1], 0.0])
    path = str(tmp_path / "rt.restart")
    tr.write_lammps_restart(path, data, **kw)
    r = tr.read_lammps_restart(path)
    box = np.asarray(data.box_hi) - np.asarray(data.box_lo)
    np.testing.assert_array_equal(r.x + r.img * box, data.x + data.image * box)
    np.testing.assert_array_equal(r.img[:, 1], data.image[:, 1] + 1)
    np.testing.assert_array_equal(r.v, data.v)
    np.testing.assert_array_equal(r.types, data.types)
    np.testing.assert_array_equal(r.molecule - 1, data.molecule)
    assert sorted(map(tuple, r.bonds - np.array([0, 1, 1]))) == sorted(
        (int(t) + 1, int(a), int(b)) for t, a, b in data.bonds)
    assert (r.step, r.dt) == (120, 0.006)


def test_reader_refuses_what_it_cannot_parse(tmp_path):
    """Not a restart, a truncated one: RestartError, as the reference."""
    bad = tmp_path / "bad.restart"
    bad.write_bytes(b"not a restart file at all")
    with pytest.raises(tr.RestartError, match="not a LAMMPS"):
        tr.read_lammps_restart(str(bad))
    bad.write_bytes(open(RST, "rb").read()[:400])
    with pytest.raises(tr.RestartError, match="truncated"):
        tr.read_lammps_restart(str(bad))


@functools.lru_cache(maxsize=None)
def resumed():
    """Both runners (f64, CPU) after HEAD with ``read_restart`` of the
    binary's file, built, no step run."""
    from lammps_le_tpu.deck import DeckRunner as RefRunner

    out = []
    for make in (lambda: RefRunner(dtype="float64", quiet=True),
                 lambda: DeckRunner(dtype="float64", quiet=True,
                                    device="cpu")):
        td = tempfile.mkdtemp(prefix="rst_")
        shutil.copy(RST, os.path.join(td, "ref_le.restart"))
        with open(os.path.join(td, "in.deck"), "w") as fh:
            fh.write(HEAD.format(source="read_restart ref_le.restart"))
        r = make()
        r.run_file(os.path.join(td, "in.deck"))
        r._build()
        out.append(r)
    return out


def test_runner_resumes_from_the_binary_file_as_reference():
    """read_restart of the binary's file: the State both runners build
    (step 120, the extruder table holding the file's live bond) and the
    restored dt, bit for bit."""
    rr, pr = resumed()
    for k in STATE:
        np.testing.assert_array_equal(getattr(pr.state, k).numpy(),
                                      np.asarray(getattr(rr.state, k)),
                                      err_msg=k)
    assert int(pr.state.step) == 120 and pr.sim.dt == rr.sim.dt == 0.006
    assert int((pr.state.ex_left >= 0).sum()) == 1


def test_runner_write_restart_reads_back_bitwise(tmp_path):
    """write_restart of a moved State with three live extruders: the
    reference runner's bytes from the same State, and a fresh port runner
    that reads it back holds its positions, velocities, images, types,
    extruder table and step bit for bit."""
    rr, pr = resumed()
    rng = np.random.default_rng(5)
    x = pr.state.x.numpy() + rng.normal(scale=0.02, size=(120, 3))
    v = pr.state.v.numpy() + rng.normal(scale=0.1, size=(120, 3))
    left = np.full(pr.state.ex_left.shape, -1, np.int64)
    right = left.copy()
    left[:3], right[:3] = (5, 40, 90), (9, 47, 96)
    rr.state = rr.state.replace(
        x=jnp.asarray(x), v=jnp.asarray(v),
        ex_left=jnp.asarray(left, jnp.int32),
        ex_right=jnp.asarray(right, jnp.int32))
    pr.state = pr.state.replace(
        x=torch.as_tensor(x), v=torch.as_tensor(v),
        ex_left=torch.as_tensor(left), ex_right=torch.as_tensor(right))
    for r, name in ((rr, "ref"), (pr, "port")):
        r.root = str(tmp_path)
        r.command("write_restart", [f"{name}.restart"])
    assert (tmp_path / "ref.restart").read_bytes() == \
        (tmp_path / "port.restart").read_bytes()
    with open(tmp_path / "in.back", "w") as fh:
        fh.write(HEAD.format(source="read_restart port.restart"))
    back = DeckRunner(dtype="float64", quiet=True, device="cpu",
                      root=str(tmp_path))
    back.run_file(str(tmp_path / "in.back"))
    back._build()
    for k in STATE:
        want = getattr(pr.state, k)
        got = getattr(back.state, k)
        if k in ("ex_left", "ex_right"):
            # the table is rebuilt from the file's bonds, in bond order
            want = torch.sort(want[want >= 0]).values
            got = torch.sort(got[got >= 0]).values
        assert torch.equal(got, want), k
