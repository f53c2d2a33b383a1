"""The general path's force modules (``lammps_le_torch.ops``: cells, grid,
pair, bond, angle, forces) against the JAX package's, on the 500-bead
melt32 system of ``torch_parity.make_system`` in f64, its positions the
serpentine's jittered by a numpy seed.

Tolerances: the cell bins, the slot grid (slots, scatter slots, flags)
and the verlet list's flags bit for bit, the list's rows as sets
(``torch.topk`` orders ties unlike ``lax.top_k``); forces within 1e-10 x
max(1, max|f|) and energies within 1e-8 in f64; one f32 case of
``compute_forces`` within 1e-5 x max|f| and 1e-3 in energy (f32 sums
taken in another order).  The reference functions are compiled
with LLVM's optimisations off (the same results, less compile time)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import lammps_le_tpu.state as jstate
from lammps_le_torch.ops import (angle as t_angle, bond as t_bond,
                                 cells as t_cells, forces as t_forces,
                                 grid as t_grid, pair as t_pair)
from lammps_le_torch.state import _partner_table, nbr_from_arrays
from lammps_le_tpu.ops import (angle as j_angle, bond as j_bond,
                               cells as j_cells, forces as j_forces,
                               grid as j_grid, pair as j_pair)
from lammps_le_tpu.system import (ANGLE_COSINE, ANGLE_HARMONIC, BOND_FENE,
                                  AngleParams)
from torch_parity import make_system

F_REL, E_ABS = 1e-10, 1e-8


def _ref(fn, *args):
    """``fn(*args)`` compiled with LLVM's optimisations off, as numpy."""
    out = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    return jax.tree.map(np.asarray, out)


def _close_f(ref, got, rel=F_REL):
    ref = np.asarray(ref)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(ref - got.numpy()).max()) <= tol


def _close_e(ref, got, tol=E_ABS):
    assert abs(float(ref) - float(got)) <= tol


def _partner_ref(left, right, n):
    holder = jstate.State.__new__(jstate.State)
    object.__setattr__(holder, "ex_left", jnp.asarray(left, jnp.int32))
    object.__setattr__(holder, "ex_right", jnp.asarray(right, jnp.int32))
    return jstate.extruder_partner(holder, n)


@dataclasses.dataclass
class Case:
    system: object
    x: np.ndarray
    types: np.ndarray
    left: np.ndarray
    right: np.ndarray

    @property
    def xt(self):
        return torch.tensor(self.x)

    @property
    def tt(self):
        return torch.tensor(self.types, dtype=torch.int64)

    def table(self):
        return (torch.tensor(self.left, dtype=torch.int64),
                torch.tensor(self.right, dtype=torch.int64))

    def jtable(self):
        return (jnp.asarray(self.left, jnp.int32),
                jnp.asarray(self.right, jnp.int32))


def _case(cap=8, dtype="float64", scale=0.08, seed=0, **kw):
    system, data = make_system(dtype=dtype, cap=cap, **kw)
    rs = np.random.default_rng(seed)
    x = data.x + rs.normal(scale=scale, size=data.x.shape)
    x, _ = j_cells.wrap_positions(jnp.asarray(x, jnp.float64), system,
                                  jnp.zeros((system.n, 3), jnp.int32))
    e = system.max_extruders
    left = np.full(e, -1, np.int64)
    right = np.full(e, -1, np.int64)
    left[:6] = np.arange(6) * 80 + 3
    right[:6] = left[:6] + np.array([2, 2, 3, 5, 2, 4])
    return Case(system, np.asarray(x, np.dtype(dtype)), data.types,
                left, right)


@pytest.fixture(scope="module")
def case():
    return _case()


@pytest.mark.parametrize("cap", [8, 3])
def test_builders_bitwise(cap):
    """Bins, slot grid and verlet list; at cap 3 cells overflow (a bead
    past cap lands, as in the reference's flat scatter, on the next
    cell's slot unless a later bead writes it) and list rows truncate."""
    c = _case(cap=cap, scale=0.3 if cap == 3 else 0.08)
    system = c.system
    vsys = system.with_neighbor(mode="verlet",
                                max_neighbors=6 if cap == 3 else 32)
    small = system.with_neighbor(use_cells=False)
    (bins, fb), (grid, fg), (nbr, fn), (allp, _) = _ref(lambda x: (
        j_cells.build_cell_bins(x, system), j_grid.build_grid(x, system),
        j_cells.build_neighbor_list(x, vsys),
        j_cells.build_neighbor_list(x[:40], small)), c.x)
    tb, tfb = t_cells.build_cell_bins(c.xt, system)
    np.testing.assert_array_equal(bins, tb.numpy())
    tg, tfg = t_grid.build_grid(c.xt, system)
    np.testing.assert_array_equal(grid.slot_bead, tg.slot_bead.numpy())
    np.testing.assert_array_equal(grid.scatter_bead, tg.scatter_bead.numpy())
    tn, tfn = t_cells.build_neighbor_list(c.xt, vsys)
    assert [sorted(r) for r in nbr.idx.tolist()] == \
        [sorted(r) for r in tn.idx.tolist()]
    assert [int(fb), int(fg), int(fn)] == [int(tfb), int(tfg), int(tfn)]
    if cap == 3:
        assert int(fg) & jstate.FLAG_CELL_OVERFLOW
        assert int(fn) & jstate.FLAG_NEIGHBOR_OVERFLOW
    tall, _ = t_cells.build_neighbor_list(c.xt[:40], small)
    np.testing.assert_array_equal(allp.idx, tall.idx.numpy())


def test_lj_force_nbr(case):
    system = case.system.with_neighbor(mode="verlet")
    nbr, _ = _ref(lambda x: j_cells.build_neighbor_list(x, system), case.x)
    left, right = case.jtable()
    part = _partner_ref(left, right, system.n)
    f, e = _ref(lambda x, t, p: j_pair.lj_force_nbr(
        x, t, jstate.NeighborList(idx=jnp.asarray(nbr.idx), x_ref=x),
        system, p), case.x, case.types, part)
    tl, tr = case.table()
    tn = nbr_from_arrays({"idx": nbr.idx, "x_ref": case.x}, "cpu")
    tf, te = t_pair.lj_force_nbr(case.xt, case.tt, tn, system,
                                 _partner_table(tl, tr, system.n))
    _close_f(f, tf)
    _close_e(e, te)


def test_lj_force_bruteforce(case):
    system = case.system
    f, e = _ref(lambda x, t: j_pair.lj_force_bruteforce(x, t, system),
                case.x, case.types)
    tf, te = t_pair.lj_force_bruteforce(case.xt, case.tt, system)
    _close_f(f, tf)
    _close_e(e, te)


@pytest.fixture(scope="module")
def grid_ref(case):
    """The reference's grid, its pair force with and without energies
    (virial on) and compute_forces on it with and without energies, from
    one compiled function (the graphs share the grid and its stencil)."""
    system = case.system

    def ref(x, t, l, r):
        grid, _ = j_grid.build_grid(x, system)
        part = _partner_ref(l, r, system.n)
        return grid, {e: (j_grid.grid_pair_force(x, t, grid, system,
                                                 virial=True, energy=e),
                          j_forces.compute_forces(x, t, grid, system, l, r, 1,
                                                  part, e))
                      for e in (True, False)}

    grid, outs = _ref(ref, case.x, case.types, *case.jtable())
    tg = nbr_from_arrays({"slot_bead": grid.slot_bead,
                          "scatter_bead": grid.scatter_bead,
                          "x_ref": case.x}, "cpu")
    return tg, outs


@pytest.mark.parametrize("energy", [True, False])
def test_grid_pair_force(case, grid_ref, energy):
    tg, outs = grid_ref
    f, e, w = outs[energy][0]
    tf, te, tw = t_grid.grid_pair_force(case.xt, case.tt, tg, case.system,
                                        virial=True, energy=energy)
    _close_f(f, tf)
    _close_e(e, te)
    _close_e(w, tw)
    assert float(np.abs(f).max()) > 10.0 and (float(e) != 0.0) == energy


@pytest.mark.parametrize("special", [(0.0, 1.0, 1.0), (0.0, 0.5, 0.5)])
def test_special_pair_correction(case, special):
    system = case.system.replace(special_lj=special)
    left, right = case.jtable()
    f, e = _ref(lambda x, t, l, r: j_forces.special_pair_correction(
        x, t, system, l, r), case.x, case.types, left, right)
    tf, te = t_forces.special_pair_correction(case.xt, case.tt, system,
                                              *case.table())
    _close_f(f, tf)
    _close_e(e, te)


def test_fene_clamp(case):
    """A stretched backbone bond past r0 sqrt(0.9): the clamped FENE force
    and the flag."""
    system = case.system
    x = case.x.copy()
    x[101:] += np.array([0.9, 0.0, 0.0])
    f, e, fl = _ref(lambda x: j_bond.backbone_bond_force(x, system), x)
    tf, te, tfl = t_bond.backbone_bond_force(torch.tensor(x), system)
    _close_f(f, tf)
    _close_e(e, te)
    assert int(fl) == int(tfl) == jstate.FLAG_FENE_CLAMP


@pytest.mark.parametrize("style", ["harmonic", "fene"])
def test_extruder_bond_force(style):
    c = _case(ex_style=BOND_FENE if style == "fene" else None)
    system = c.system
    left, right = c.jtable()
    f, e, fl = _ref(lambda x, l, r: j_bond.extruder_bond_force(
        x, l, r, 1, system), c.x, left, right)
    tf, te, tfl = t_bond.extruder_bond_force(c.xt, *c.table(), 1, system)
    _close_f(f, tf)
    _close_e(e, te)
    assert int(fl) == int(tfl)
    assert float(np.abs(f).max()) > 0.0


def test_chain_angle_force(case):
    """Harmonic and cosine angles on alternate centres, some none."""
    ct = np.arange(case.system.n) % 3 - 1
    system = case.system.replace(
        angles=AngleParams(style=np.array([ANGLE_HARMONIC, ANGLE_COSINE]),
                           coeffs=np.array([[5.0, 2.1], [3.0, 0.0]])),
        angle_center_type=ct.astype(np.int32))
    for energy in (True, False):
        f, e = _ref(lambda x: j_angle.chain_angle_force(x, system, energy),
                    case.x)
        tf, te = t_angle.chain_angle_force(case.xt, system, energy)
        _close_f(f, tf)
        _close_e(e, te)
    assert float(e) == 0.0 and float(np.abs(f).max()) > 1.0


@pytest.mark.parametrize("mode", ["grid", "grid_no_energy", "verlet",
                                  "verlet_special", "brute"])
def test_compute_forces(case, grid_ref, mode):
    system = case.system
    if mode.startswith("verlet"):
        system = system.with_neighbor(mode="verlet")
    if mode == "verlet_special":
        system = system.replace(special_lj=(0.0, 0.5, 0.5))
    if mode == "brute":
        system = system.with_neighbor(use_cells=False)
    energy = mode != "grid_no_energy"
    tl, tr = case.table()
    if mode.startswith("grid"):
        out = grid_ref[1][energy][1]
        nbr = grid_ref[0]
    else:
        def ref(x, t, l, r):
            nbr = None
            if system.neighbor.use_cells:
                nbr = j_cells.build_neighbor_list(x, system)[0]
            return j_forces.compute_forces(
                x, t, nbr, system, l, r, 1, _partner_ref(l, r, system.n))

        out = _ref(ref, case.x, case.types, *case.jtable())
        nbr = None
        if system.neighbor.use_cells:
            nbr = t_cells.build_neighbor_list(case.xt, system)[0]
    got = t_forces.compute_forces(case.xt, case.tt, nbr, system, tl, tr, 1,
                                  _partner_table(tl, tr, system.n), energy)
    _close_f(out.f, got.f)
    _close_e(out.epair, got.epair)
    _close_e(out.ebond, got.ebond)
    assert int(out.flags) == int(got.flags)


def test_compute_forces_f32():
    """f32 (the production type) on the brute-force pair path with
    extruder bonds; the f32 grid runs in test_torch_verlet.py's f32
    trajectory."""
    c = _case(dtype="float32")
    system = c.system.with_neighbor(use_cells=False)

    def ref(x, t, l, r):
        return j_forces.compute_forces(x, t, None, system, l, r, 1,
                                       _partner_ref(l, r, system.n))

    out = _ref(ref, c.x, c.types, *c.jtable())
    tl, tr = c.table()
    got = t_forces.compute_forces(c.xt, c.tt, None, system, tl, tr, 1,
                                  _partner_table(tl, tr, system.n))
    assert got.f.dtype == torch.float32
    _close_f(out.f, got.f, rel=1e-5)
    _close_e(out.epair, got.epair, 1e-3)
    _close_e(out.ebond, got.ebond, 1e-3)
