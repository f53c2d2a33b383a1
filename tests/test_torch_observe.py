"""The port's observers through the deck (``compute pe/atom``,
``stress/atom``, ``coord/atom``, ``reduce``, ``group/group``,
``pair/local``, ``rdf``, ``slice``, ``dump custom``, ``dump local``,
``fix ave/time`` in vector mode), against the JAX package's runner on the
CPU, and ``profile()``.

One deck (a 200-bead serpentine, f64, an extrusion fix so the extruder
bond type is live) is built by both runners with no step run; two shared
States (the built start moved along a seeded displacement and velocity
field, three extruders active) are handed to both.  On them: the runner's
per-atom computes (``pe/atom`` with a term selection, ``stress/atom``,
``coord/atom``), ``compute reduce`` of them, ``group/group``,
``pair/local``, ``rdf`` past the cell size (the dedicated wide grid) and
a ``slice`` of it, ``make_rdf_fn`` on the runners' rdf, and the files
they feed.  Tolerances: coordination numbers and the rdf's counts bit
for bit, floats within 1e-10 x max(1, |value|) in f64, files equal.  The
reference's jitted observers compile with LLVM's optimisations off (the
same results, less compile time).  The library entry points on their own
are in ``test_torch_observe_lib.py``."""

import functools
import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parity as tp
from lammps_le_torch.deck import DeckRunner
from lammps_le_tpu.io.data import write_data
from lammps_le_tpu.scene import serpentine

N = 200
REL = 1e-10

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
group half1 id 1:100
group half2 id 101:200
compute pea all pe/atom
compute peb all pe/atom bond
compute str all stress/atom NULL
compute co all coord/atom cutoff 1.2
compute petot all reduce sum c_pea
compute comax all reduce max c_co
compute gg half1 group/group half2
compute gr all rdf 20 cutoff 2.5
compute sl all slice 2 10 4 c_gr
compute pl all pair/local dist eng force
fix avr all ave/time 5 1 5 c_gr[*] mode vector file rdf.ave
dump dc all custom 5 atoms.dump id c_pea c_co c_str[1] c_str[6] c_peb
dump dl all local 5 pairs.dump c_pl[1] c_pl[2] c_pl[3]
thermo 10
timestep 0.005
"""
PERATOM = ("pea", "peb", "str", "co")
SCALARS = ("c_petot", "c_comax", "c_gg", "c_sl[2]")
FILES = ("atoms.dump", "pairs.dump", "rdf.ave")
EXTRUDERS = ((10, 14), (57, 62), (120, 126))


def _unoptimised():
    """The reference's observer modules the deck reaches, to set their jit
    to LLVM opt 0: [(module, its jax)]."""
    import lammps_le_tpu.observe.peratom as jp
    import lammps_le_tpu.observe.rdf as jr

    return [(m, m.jax) for m in (jp, jr)]


@functools.lru_cache(maxsize=None)
def built():
    """Both runners after DECK (f64, CPU, no step run) and two shared
    States with three extruders active."""
    from lammps_le_tpu.deck import DeckRunner as RefRunner

    root = tempfile.mkdtemp(prefix="obs_")
    out = []
    for name, make in (("ref", lambda: RefRunner(dtype="float64",
                                                 quiet=True)),
                       ("port", lambda: DeckRunner(dtype="float64",
                                                   quiet=True,
                                                   device="cpu"))):
        td = os.path.join(root, name)
        os.makedirs(td)
        write_data(os.path.join(td, "data.tiny"),
                   serpentine(N, seed=7, n_atom_types=4, n_bond_types=2,
                              barrier_fraction=0.02))
        with open(os.path.join(td, "in.deck"), "w") as fh:
            fh.write(DECK)
        r = make()
        r.run_file(os.path.join(td, "in.deck"))
        r._build()
        out.append(r)
    rr, tr = out
    rng = np.random.default_rng(3)
    dx = rng.normal(scale=0.04, size=(N, 3))
    dv = rng.normal(scale=0.3, size=(N, 3))
    x0 = np.asarray(rr.state.x)
    v0 = np.asarray(rr.state.v)
    np.testing.assert_array_equal(x0, tr.state.x.numpy())
    left = np.full(tr.state.ex_left.shape, -1, np.int64)
    right = left.copy()
    for k, (a, b) in enumerate(EXTRUDERS):
        left[k], right[k] = a, b
    snaps = []
    for k in range(2):
        x, v = x0 + (k + 1) * dx, v0 + k * dv
        snaps.append((
            rr.state.replace(x=jnp.asarray(x), v=jnp.asarray(v),
                             ex_left=jnp.asarray(left, jnp.int32),
                             ex_right=jnp.asarray(right, jnp.int32),
                             step=jnp.asarray(5 * k, jnp.int32)),
            tr.state.replace(x=torch.as_tensor(x), v=torch.as_tensor(v),
                             ex_left=torch.as_tensor(left),
                             ex_right=torch.as_tensor(right),
                             step=torch.tensor(5 * k))))
    return rr, tr, snaps


@functools.lru_cache(maxsize=None)
def sampled():
    """Every per-atom compute, scalar, rdf table and pair table of both
    runners on the shared States, and the files their dumps and ave/time
    fix wrote: {name: (reference, port)}."""
    from lammps_le_torch.io.dump import write_frame
    from lammps_le_tpu.io.dump import write_frame as ref_frame

    rr, tr, snaps = built()
    saved = _unoptimised()
    for m, _ in saved:
        m.jax = tp.UnoptimisedJax()
    try:
        vals = {}
        for k, (rs, ts) in enumerate(snaps):
            for cid in PERATOM:
                vals[cid, k] = (rr._peratom_value(cid, rs),
                                tr._peratom_value(cid, ts))
            rr.state, tr.state = rs, ts
            for key in SCALARS:
                vals[key, k] = (rr.live_value(key), tr.live_value(key))
            vals["gr", k] = (np.asarray(rr._compute_vector("gr", rs)),
                             tr._compute_vector("gr", ts))
            cols = ["dist", "eng", "force"]
            vals["pl", k] = (rr._pair_local_table(cols, "half2", rs),
                             tr._pair_local_table(cols, "half2", ts))
            for write, r, s in ((ref_frame, rr, rs), (write_frame, tr, ts)):
                for d in r.dumps:
                    write(d, s, r.system)
    finally:
        for m, jax in saved:
            m.jax = jax
    for r in (rr, tr):
        for d in r.dumps:
            d.close()
    for name in FILES:
        with open(os.path.join(rr.root, name)) as a, \
                open(os.path.join(tr.root, name)) as b:
            vals[name] = (a.read(), b.read())
    return vals


def _close(want, got, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert want.shape == got.shape, what
    tol = REL * max(1.0, float(np.abs(want).max(initial=0.0)))
    assert float(np.abs(want - got).max(initial=0.0)) <= tol, what


@pytest.mark.parametrize("cid", PERATOM)
def test_peratom_computes_match_reference(cid):
    """pe/atom (both terms, bond only) and stress/atom within 1e-10;
    coord/atom bit for bit, with neighbours."""
    vals = sampled()
    for k in range(2):
        want, got = vals[cid, k]
        assert got.shape == (N,) if cid.startswith(("pe", "co")) else \
            got.shape == (N, 6)
        if cid == "co":
            np.testing.assert_array_equal(got, want)
            assert got.max() >= 1
        else:
            _close(want, got, (cid, k))
            assert np.abs(got).max() > 0


@pytest.mark.parametrize("key", SCALARS)
def test_scalar_computes_match_reference(key):
    """compute reduce of pe/atom and coord/atom, group/group between the
    two halves and a slice of an rdf, within 1e-10."""
    vals = sampled()
    for k in range(2):
        want, got = vals[key, k]
        assert abs(got - want) <= REL * max(1.0, abs(want)), (key, k)


def test_rdf_compute_matches_reference():
    """compute rdf's (nbins, 4) table past the cell size (a dedicated wide
    grid): bins and r equal, g(r) and the coordination within 1e-10."""
    vals = sampled()
    for k in range(2):
        want, got = vals["gr", k]
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        _close(want[:, 2:], got[:, 2:], k)
        assert got[:, 2].max() > 0


def test_pair_local_table_matches_reference():
    """compute pair/local dist eng force over group half2: the same rows
    in the same order, within 1e-10."""
    vals = sampled()
    for k in range(2):
        want, got = vals["pl", k]
        assert got.shape == want.shape and got.shape[0] >= 5
        _close(want, got, k)


@pytest.mark.parametrize("name", FILES)
def test_observer_files_match_reference(name):
    """dump custom of the per-atom computes, dump local of pair/local and
    fix ave/time of the rdf in vector mode: the reference's files."""
    want, got = sampled()[name]
    assert want.count("\n") >= 10 and got == want


def _systems():
    rr, tr, snaps = built()
    return rr.system, tr.system, snaps[1]


def test_make_rdf_fn_counts_bitwise():
    """make_rdf_fn's histogram and flags on the runners' rdf (20 bins to
    2.5, the wide grid), summed onto a nonzero histogram: the reference's
    counts bit for bit and its flags."""
    sampled()
    rr, tr, snaps = built()
    rs, ts = snaps[1]
    h0 = np.arange(20, dtype=np.float32)
    want, wfl = rr.computes["gr"]["fn"](rs, jnp.asarray(h0))
    got, gfl = tr.computes["gr"]["fn"](ts, torch.as_tensor(h0))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gfl) == int(wfl)
    assert float(got.sum()) > h0.sum()


def test_coord_atom_refuses_a_cutoff_past_the_cell():
    from lammps_le_torch.observe.peratom import make_coord_atom_fn

    _, tsys, _ = _systems()
    with pytest.raises(ValueError, match="cell stencil reach"):
        make_coord_atom_fn(tsys, tsys.neighbor.cell_size + 0.1)


def test_profile_reports_the_reference_sections(capsys):
    """profile() on the port's general path (CPU clock): the reference's
    section keys, each a positive time, and its report."""
    from lammps_le_torch.integrate import Simulation
    from lammps_le_torch.observe import profile
    from lammps_le_torch.fixes import NVE

    rr, tr, snaps = built()
    ts = snaps[0][1]
    sim = Simulation(system=tr.system, dt=0.005, ex_btype=2, fixes=(NVE(),))
    sections = profile(sim, ts, iters=2)
    assert list(sections) == ["pair", "neigh", "bond", "special",
                              "total_step"]
    assert all(v > 0 for v in sections.values())
    out = capsys.readouterr().out
    assert "timesteps/s" in out and "whole step" in out
