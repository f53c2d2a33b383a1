"""The port's host I/O, pressure observer and minimizers against the
reference on the CPU: data files byte for byte (a 20,000-row section
through the native parser and through numpy), checkpoints in both
directions bit for bit, and ``make_pressure_fn`` at 1e-10 in f64 (the
minimizers: ``test_torch_minimize.py``)."""

import os

import numpy as np
import pytest
import torch

import torch_parity as tp
from lammps_le_torch.io import checkpoint as tck
from lammps_le_torch.io import data as tdata
from lammps_le_torch.state import state_from_arrays
from lammps_le_tpu.io import checkpoint as jck
from lammps_le_tpu.io import data as jdata
from lammps_le_tpu.scene import serpentine

TITLE = "parity data file"
DATA_FIELDS = ("masses", "x", "v", "types", "molecule", "image", "bonds",
               "angles")


def _with_angles(data):
    """``data`` with a harmonic angle on every interior chain bead."""
    nxt = np.full(data.n_atoms, -1)
    for _, i, j in data.bonds:
        nxt[min(i, j)] = max(i, j)
    ctr = np.nonzero((nxt >= 0) & (np.roll(nxt, 1) >= 0))[0]
    ctr = ctr[(ctr > 0) & (nxt[ctr - 1] == ctr)]
    data.angles = np.stack([np.zeros_like(ctr), ctr - 1, ctr, ctr + 1],
                           axis=1).astype(np.int64)
    data.n_angles, data.n_angle_types = len(ctr), 1
    return data


def _same_data(a, b):
    for k in ("n_atoms", "n_bonds", "n_atom_types", "n_bond_types",
              "box_lo", "box_hi", "n_angles", "n_angle_types"):
        assert getattr(a, k) == getattr(b, k), k
    for k in DATA_FIELDS:
        va, vb = getattr(a, k), getattr(b, k)
        assert (va is None) == (vb is None), k
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=k)
            assert np.asarray(va).dtype == np.asarray(vb).dtype, k


@pytest.mark.parametrize("n,angles,fastio", [
    (300, False, True), (300, True, True), (20000, False, True),
    (20000, False, False)])
def test_data_roundtrip_byte_equal(tmp_path, monkeypatch, n, angles, fastio):
    """The reference writes a data file (velocities, extruder-type bonds,
    optionally Angles); the port reads it into the same arrays and writes
    it back byte for byte, and the reference reads the port's file back
    to the same arrays.  The 20,000-atom file's Atoms, Velocities and
    Bonds sections go through the port's native parser or its numpy
    parser (the reference's own parser on its numpy path throughout,
    so its package builds nothing)."""
    import lammps_le_torch.native as tnative
    import lammps_le_tpu.native as jnative

    monkeypatch.setattr(jnative, "load_fastio", lambda: None)
    if fastio:
        assert tnative.load_fastio() is not None or n < 20000
    else:
        monkeypatch.setattr(tnative, "load_fastio", lambda: None)
    data = serpentine(n, seed=3, n_atom_types=4, n_bond_types=2,
                      barrier_fraction=0.02)
    data.v = np.random.default_rng(4).normal(size=(n, 3))
    data.bonds = np.concatenate([data.bonds, [[1, 10, 40], [1, 60, 95]]])
    data.n_bonds = len(data.bonds)
    if angles:
        data = _with_angles(data)
    ref_path = os.path.join(tmp_path, "ref.data")
    port_path = os.path.join(tmp_path, "port.data")
    jdata.write_data(ref_path, data, title=TITLE)
    got = tdata.read_data(ref_path)
    want = jdata.read_data(ref_path)
    _same_data(got, want)
    tdata.write_data(port_path, got, title=TITLE)
    with open(ref_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()
    _same_data(jdata.read_data(port_path), want)


def test_native_parser_builds_into_package_build_dir():
    """``native/`` builds ``libfastio`` into the port's gitignored
    ``build/`` directory, never beside its source, and parses a section
    like numpy."""
    from lammps_le_torch.native import build

    lib = build.load_fastio()
    if lib is None:
        pytest.skip("no C++ compiler: the numpy parser is the path")
    assert os.path.dirname(build._lib_path()) == build.BUILD_DIR
    assert os.path.exists(build._lib_path())
    assert build.BUILD_DIR.endswith(os.path.join("lammps_le_torch", "build"))
    rows = ["3 1 2 0.5 1.5 2.5 0 1 -1", "1 1 1 3 4 5 0 0 0",
            "2 2 1 -1e-3 7.25 8 1 0 0"]
    np.testing.assert_array_equal(
        build.parse_rows(lib, "\n".join(rows), 3, 9),
        np.asarray(sorted((r.split() for r in rows),
                          key=lambda s: int(s[0])), np.float64))


def _state_arrays():
    d = dict(tp.general_start("float64"))
    d["step"] = np.asarray(41)
    d["n_moves"] = np.asarray(7)
    d["flags"] = np.asarray(0x48)
    d["last_event"] = np.asarray([3, 2, 1])
    d["key"] = np.asarray([0x9E3779B9, 0xDEADBEEF], np.uint32)
    return d


def test_checkpoint_reference_to_port(tmp_path):
    """A checkpoint the reference writes loads into the port with every
    field bit for bit (the key's two uint32 words, step, flags)."""
    d = _state_arrays()
    path = os.path.join(tmp_path, "ref.ckpt.npz")
    jck.save_checkpoint(path, tp.jax_state(d, np.float64))
    fresh = state_from_arrays({**d, "x": np.zeros_like(d["x"]),
                               "key": np.zeros(2, np.uint32),
                               "step": np.asarray(0)}, "cpu")
    back = tck.load_checkpoint(path, like=fresh)
    assert back.nbr is None
    for name in tck._FIELDS:
        got = getattr(back, name)
        assert got.dtype == getattr(fresh, name).dtype, name
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(d.get(name, np.zeros(()))).astype(
                got.numpy().dtype), err_msg=name)


def test_checkpoint_port_to_reference(tmp_path):
    """A checkpoint the port writes is the reference's file (same keys,
    dtypes and values as the reference's own save of the same State) and
    the reference loads it bit for bit."""
    d = _state_arrays()
    js = tp.jax_state(d, np.float64)
    port_path = os.path.join(tmp_path, "port.ckpt.npz")
    ref_path = os.path.join(tmp_path, "ref.ckpt.npz")
    tck.save_checkpoint(port_path, state_from_arrays(tp.arrays_of(js),
                                                     "cpu"))
    jck.save_checkpoint(ref_path, js)
    with np.load(port_path) as a, np.load(ref_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = jck.load_checkpoint(port_path, like=js)
    for name in jck._FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)


@pytest.mark.parametrize("special", ["fene", "lj"])
def test_pressure_matches_reference(special):
    """``make_pressure_fn`` against the reference's on the thermalized
    melt32 state with six extruders, in f64: the 1-2 special-pair
    correction on (special_bonds fene) and off (lj 1 1 1)."""
    import dataclasses

    from lammps_le_torch.observe.pressure import make_pressure_fn
    from lammps_le_tpu.observe.pressure import make_pressure_fn as ref_fn

    system = tp.general_system("float64")
    if special == "lj":
        system = dataclasses.replace(system, special_lj=(1.0, 1.0, 1.0))
    d = tp.general_start("float64")
    want = float(ref_fn(system, 2)(tp.jax_state(d, np.float64)))
    got = make_pressure_fn(system, 2)(state_from_arrays(d, "cpu"))
    assert got.dtype == torch.float64 and got.shape == ()
    assert abs(float(got) - want) <= 1e-10 * max(1.0, abs(want))
