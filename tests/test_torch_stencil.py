"""The plain versions of the four step kernels (fast/kernels_ref.py) match
the reference's XLA chain: stencil_forces vs engine.make_kernel,
extruder_springs vs engine.make_extruder_pass (<= 1e-10 in f64,
3e-5 * max|f| in f32, energies, flags and clamp counts), and
kick_drift_halo / langevin_kick_monitor vs the reactive step's pieces
(engine.py:1361-1366, 1387-1455) bit for bit.  The CUDA kernels are held
to the plain versions by tests/test_torch_cuda.py (on a card) and by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lammps_le_torch.fast import kernels as K
from lammps_le_torch.fast import kernels_ref as R
from lammps_le_torch.fast.consts import SpringConsts, StencilConsts
from lammps_le_torch.fast.maps import fast_maps
from lammps_le_torch.fast.place import GridConsts, place
from lammps_le_tpu.fast import engine as ref
from lammps_le_tpu.system import BOND_FENE, BOND_HARMONIC
from torch_parity import make_system, melt_arrays

NP = {"float32": np.float32, "float64": np.float64}


def _grid(dtype="float32", fene_sigma=1.0, ex_style=None, stretch=False):
    """melt32 positions (optionally with one clamped and one out-of-reach
    bond) placed on the grid of a system of the given kind."""
    base, d = melt_arrays()
    # a FENE extruder bond (r0 2) floors the cell edge higher: more
    # beads per cell, so a taller cap keeps every bead in the grid
    system, _ = make_system(dtype=dtype, fene_sigma=fene_sigma,
                            ex_style=ex_style,
                            cap=16 if ex_style == BOND_FENE else 8)
    x = d["x"].astype(NP[dtype])
    if stretch:
        x = x.copy()
        x[100, 0] += 1.45   # FENE past the clamp, inside the stencil
        x[300, 1] += 4.5    # past the bond reach: FLAG_BOND_REACH
    maps = fast_maps(system)
    g = GridConsts.build(system, maps, "cpu")
    t = {k: torch.tensor(d[k]) for k in ("img", "ex_left", "ex_right")}
    xv = torch.tensor(x)
    planes = place(system, maps, g, xv, torch.tensor(d["v"]).to(xv.dtype),
                   torch.tensor(d["f"]).to(xv.dtype), t["ex_left"],
                   t["ex_right"], t["img"])
    return system, maps, g, planes, t


def _j(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("dtype,fene_sigma,energy,stretch", [
    ("float32", 1.0, True, False),
    ("float32", 1.0, False, True),
    ("float32", 0.9, True, True),
    ("float64", 1.0, True, True),
    ("float64", 0.9, True, False),
])
def test_stencil_forces_vs_make_kernel(dtype, fene_sigma, energy, stretch):
    system, maps, g, planes, _ = _grid(dtype, fene_sigma, stretch=stretch)
    gx, _, _, bid, hn, pid = planes[:6]
    C = StencilConsts(system, NP[dtype])
    assert C.wca_is_lj == (fene_sigma == 1.0)
    kern = ref.make_kernel(system, ref.fast_maps(system), 2)
    # op by op: the unrolled 27-offset graph takes seconds to compile per
    # case, while its primitives compile once for all cases of a dtype
    gf_w, el_w, eb_w, fl_w, cl_w = kern(_j(gx), _j(bid), _j(hn), _j(pid),
                                        energy)
    gf, en, ints = R.stencil_forces(gx, bid, hn, pid, g.interior, C,
                                    system.n, maps.strides, energy)
    gf_w = np.asarray(gf_w)
    scale = float(np.abs(gf_w).max())
    err = float(np.abs(gf.numpy() - gf_w).max())
    tol = 1e-10 if dtype == "float64" else 3e-5 * max(scale, 1.0)
    assert err <= tol, (err, tol)
    e_tol = 1e-8 if dtype == "float64" else 2e-2
    assert abs(float(en[0]) - float(el_w)) <= e_tol
    assert abs(float(en[1]) - float(eb_w)) <= e_tol
    assert [int(ints[0]), int(ints[1])] == [int(fl_w), int(cl_w)]
    if stretch:
        assert int(ints[0]) == 64 | 8 and int(ints[1]) >= 1


@pytest.mark.parametrize("dtype,ex_style", [
    ("float32", BOND_HARMONIC), ("float32", BOND_FENE),
    ("float64", BOND_HARMONIC), ("float64", BOND_FENE)])
def test_extruder_springs_vs_make_extruder_pass(dtype, ex_style):
    system, maps, g, planes, t = _grid(dtype, ex_style=ex_style)
    gx, exl, exr = planes[0], planes[7], planes[8]
    assert int(planes[-1]) == 0  # no overflow: every anchor in the grid
    active = t["ex_left"] >= 0
    # one spring far across the box exercises the minimum image
    gf0 = torch.tensor(np.random.default_rng(0).normal(
        size=gx.shape)).to(gx.dtype)
    ex_pass = ref.make_extruder_pass(system, ref.fast_maps(system), 2)
    gf_w, eb_w = ex_pass(_j(gx), _j(gf0), _j(exl), _j(exr), _j(active), True)
    gf = gf0.clone()
    eb = R.extruder_springs(gx, gf, exl, exr, active,
                            SpringConsts(system, 2))
    gf_w = np.asarray(gf_w)
    err = float(np.abs(gf.numpy() - gf_w).max())
    tol = (1e-10 if dtype == "float64"
           else 3e-5 * max(float(np.abs(gf_w).max()), 1.0))
    assert err <= tol
    assert abs(float(eb.sum()) - float(eb_w)) <= (
        1e-10 if dtype == "float64" else 2e-2)
    assert float((gf - gf0).abs().max()) > 0.0


def test_kick_drift_halo_vs_step_pieces():
    """Half kick + drift (engine.py:1361-1366) then the halo refresh
    (engine.py:1388): bitwise."""
    system, maps, g, planes, _ = _grid()
    gx, gv, gf, bid = planes[0], planes[1], planes[2], planes[3]
    n = system.n
    dt, kick = 0.006, 0.5 * 0.006
    valid = ((_j(bid) < n) & jnp.asarray(maps.interior)[None, :]).astype(
        jnp.float32)[None]
    gv_w = _j(gv) + kick * _j(gf) * valid
    gx_w = ref._halo_refresh(_j(gx) + dt * gv_w * valid,
                             ref.fast_maps(system))
    gx_t, gv_t = R.kick_drift_halo(gx, gv, gf, bid, g.interior, g.halo_cols,
                                   g.halo_src, g.halo_shift, n, kick, dt)
    np.testing.assert_array_equal(np.asarray(gv_w), gv_t.numpy())
    np.testing.assert_array_equal(np.asarray(gx_w), gx_t.numpy())


@pytest.mark.parametrize("sstep,cuts", [(17, (0.02, 0.01)), (40, (9.0, 9.0))])
def test_langevin_kick_monitor_vs_step_pieces(sstep, cuts):
    """Langevin + final kick + skin monitor (engine.py:1398-1455,
    skin_check 1308-1316): bitwise planes, same skin bit and trigger."""
    system, maps, g, planes, _ = _grid()
    gx, gv, gf, bid = planes[0], planes[1], planes[2], planes[3]
    gx_ref = gx + 0.01 * torch.sin(torch.arange(gx.numel()).reshape(
        gx.shape).to(gx.dtype))
    n = system.n
    dt, kick, gamma1 = 0.006, 0.003, -0.1
    gamma2 = float(np.float32(2.5) * np.sqrt(np.float32(1.0)))
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(11),
                                                4 << 20), 904297)
    words = tuple(int(w) for w in np.asarray(key))
    vb = (_j(bid) < n) & jnp.asarray(maps.interior)[None, :]
    valid = vb.astype(jnp.float32)[None]
    noise = ref._uniform3(key, _j(bid), jnp.asarray(sstep, jnp.int32),
                          jnp.float32) - 0.5
    gf_w = _j(gf) + (gamma1 * _j(gv) + jnp.float32(gamma2) * noise) * valid
    gv_w = _j(gv) + kick * gf_w * valid
    dd = _j(gx) - _j(gx_ref)
    dsq = jnp.where(vb, jnp.sum(dd * dd, axis=0), 0.0)
    m1 = jnp.max(dsq)
    m2 = jnp.max(jnp.where(dsq == m1, 0.0, dsq))
    bad = bool(jnp.sqrt(m1) + jnp.sqrt(m2) > np.float32(cuts[0]))
    vn = gv_w + kick * gf_w
    vsq = jnp.where(vb, jnp.sum(vn * vn, axis=0), 0.0)
    trig = bool(jnp.max(jnp.sqrt(dsq) + dt * jnp.sqrt(vsq))
                > np.float32(cuts[1]))
    gf_t, gv_t, ints = R.langevin_kick_monitor(
        gx, gx_ref, gv, gf, bid, g.interior, words, sstep, gamma1, gamma2,
        kick, dt, cuts[0], cuts[1], n, True)
    np.testing.assert_array_equal(np.asarray(gf_w), gf_t.numpy())
    np.testing.assert_array_equal(np.asarray(gv_w), gv_t.numpy())
    assert [int(ints[0]), int(ints[1])] == [4 * bad, int(trig)]
    assert (bad, trig) == ((True, True) if cuts[0] < 1 else (False, False))


def test_wrappers_take_plain_path_on_cpu():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    system, maps, g, planes, t = _grid()
    gx, gv, gf, bid, hn, pid = planes[:6]
    K.reset_launches()
    n = system.n
    a = K.kick_drift_halo(gx, gv, gf, bid, g.interior, g.halo_cols,
                          g.halo_src, g.halo_shift, n, 0.003, 0.006)
    b = R.kick_drift_halo(gx, gv, gf, bid, g.interior, g.halo_cols,
                          g.halo_src, g.halo_shift, n, 0.003, 0.006)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    C = StencilConsts(system)
    fk = K.stencil_forces(gx, bid, hn, pid, g.interior, C, n, maps.strides,
                          True)[0]
    K.extruder_springs(gx, fk, planes[7], planes[8], t["ex_left"] >= 0,
                       SpringConsts(system, 2))
    K.langevin_kick_monitor(gx, gx, gv, fk, bid, g.interior, (1, 2), 3,
                            -0.1, 0.7, 0.003, 0.006, 0.3, 0.2, n, True)
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)
    with pytest.raises(ValueError):
        K.stencil_forces(gx.to("meta"), bid, hn, pid, g.interior, C, n,
                         maps.strides, True)
