"""Rebuild placement of lammps_le_torch (fast/place.py) is bitwise the
reference's engine._place: the same planes (gx, gv, gf, bid, hn, pid),
slot map, anchor slots, wrapped positions, image counters and overflow
flag, on the melt32 geometry and the cap 8/9/10 geometries of
tests/test_halo_rolls.py.  The port's copies of the host modules build the
reference's System."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lammps_le_torch.fast.maps import fast_maps
from lammps_le_torch.fast.place import GridConsts, halo_refresh, place
from lammps_le_torch.ops.cells import cell_coords, wrap_positions
from lammps_le_tpu.fast import engine as ref
from lammps_le_tpu.ops import cells as ref_cells
from torch_parity import make_system, melt_arrays


def _inputs(system, seed, n_ex=8, spread=0.0):
    """Bead arrays: serpentine-like positions (some pushed out of the
    box), random v/f, image counters and extruders at (i, i+2)."""
    from lammps_le_tpu.scene import serpentine

    n = system.n
    r = np.random.default_rng(seed)
    x = serpentine(n, spacing=0.97, row_gap=1.1, seed=3).x
    box = np.asarray(system.box_size)
    x = x + r.normal(scale=0.3, size=x.shape) + spread * r.integers(
        -1, 2, size=x.shape) * box
    e = max(system.max_extruders, 1)
    left = np.full(e, -1, np.int64)
    right = np.full(e, -1, np.int64)
    sites = r.choice(n // 4 - 1, n_ex, replace=False) * 4 + 1
    left[:n_ex] = sites
    right[:n_ex] = sites + 2
    return dict(x=x.astype(np.float32),
                v=r.normal(size=x.shape).astype(np.float32),
                f=r.normal(size=x.shape).astype(np.float32),
                img=r.integers(-2, 3, size=x.shape),
                ex_left=left, ex_right=right)


# the reference's placement compiled with LLVM's optimisations off: its
# results are the same bit for bit (this file asserts them bitwise), and
# the compile, most of each case's time, takes about a third less
_FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _compare(system, a):
    maps = fast_maps(system)
    rmaps = ref.fast_maps(system)
    args = (jnp.asarray(a["x"]), jnp.asarray(a["v"]), jnp.asarray(a["f"]),
            jnp.zeros(system.n, jnp.int32),
            jnp.asarray(a["ex_left"], jnp.int32),
            jnp.asarray(a["ex_right"], jnp.int32),
            jnp.asarray(a["img"], jnp.int32))
    want = jax.jit(lambda *arrays: ref._place(system, rmaps, *arrays)).lower(
        *args).compile(compiler_options=_FAST_COMPILE)(*args)
    got = place(system, maps, GridConsts.build(system, maps, "cpu"),
                *(torch.tensor(a[k]) for k in ("x", "v", "f", "ex_left",
                                                "ex_right", "img")))
    names = ("gx", "gv", "gf", "bid", "hn", "pid", "slot_of", "exl_slot",
             "exr_slot", "x", "img", "overflow")
    for name, w, g in zip(names, want, got):
        np.testing.assert_array_equal(
            np.asarray(w).astype(g.numpy().dtype), g.numpy(), err_msg=name)
    return got


def test_place_melt32():
    system, d = melt_arrays()
    a = {k: d[k] for k in ("x", "v", "f", "img", "ex_left", "ex_right")}
    got = _compare(system, a)
    assert int(got[-1]) == 0
    assert int((got[3] < system.n).sum()) > system.n  # halo copies present


@pytest.mark.parametrize("n,skin,cap", [(1500, 0.3, 8), (4000, 0.5, 9),
                                        (900, 0.4, 10)])
def test_place_geometries(n, skin, cap):
    system, _ = make_system(n, skin=skin, cap=cap, rebuild_every=4,
                            max_extruders=32)
    _compare(system, _inputs(system, seed=n, spread=1.0))


def test_place_overflow_slots():
    """A cap far below the occupancy overflows: the flag is set and the
    overflowed beads get the reference's distinct out-of-grid slots."""
    system, _ = make_system(900, skin=0.4, cap=2)
    got = _compare(system, _inputs(system, seed=1))
    maps = fast_maps(system)
    capP = maps.cap * maps.P
    assert int(got[-1]) == 1
    slot_of = got[6]
    assert bool((slot_of >= capP).any())
    assert len(torch.unique(slot_of)) == system.n


def test_wrap_and_cells_match_reference():
    """Positions a hair below the box edges wrap into [lo, hi) exactly as
    the reference does (cells.py:47), and cells clip, not re-wrap."""
    system, _ = make_system(900, skin=0.4, cap=10)
    lo = np.asarray(system.box_lo, np.float32)
    hi = lo + np.asarray(system.box_size, np.float32)
    r = np.random.default_rng(4)
    x = r.uniform(lo - 30.0, hi + 30.0, size=(system.n, 3)).astype(
        np.float32)
    x[:3] = np.nextafter(hi, np.float32(-np.inf))
    x[3:6] = lo - np.float32(1e-7)
    x[6:9] = hi + np.asarray(system.box_size, np.float32)
    img = np.zeros((system.n, 3), np.int64)
    xw, iw = ref_cells.wrap_positions(jnp.asarray(x), system,
                                      jnp.asarray(img, jnp.int32))
    xg, ig = wrap_positions(torch.tensor(x), system, torch.tensor(img))
    np.testing.assert_array_equal(np.asarray(xw), xg.numpy())
    np.testing.assert_array_equal(np.asarray(iw), ig.numpy())
    assert bool((xg >= torch.tensor(lo)).all() & (xg < torch.tensor(hi)).all())
    np.testing.assert_array_equal(
        np.asarray(ref_cells.cell_coords(xw, system)),
        cell_coords(xg, system).numpy())


def _assert_same(a, b, path="system"):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("n,kw", [
    (100_000, dict(dtype="float32", skin=0.5, rebuild_every=40,
                   cell_cap=9, max_extruders=1024)),
    (900, dict(dtype="float64", skin=0.4, rebuild_every=1, cell_cap=None,
               max_extruders=0)),
])
def test_host_copies_build_the_reference_system(n, kw):
    """The port's copies of serpentine and system_from_data (which keep
    the port free of the JAX package) give the reference's data file and
    System field for field: bench.py's production config, and a small
    f64 one with the default cell cap."""
    from lammps_le_torch import io as tio
    from lammps_le_torch import scene as tscene
    from lammps_le_torch import system as tsys
    from lammps_le_tpu import io as jio
    from lammps_le_tpu import scene as jscene
    from lammps_le_tpu import system as jsys

    built = []
    for scene, io, sysmod in ((jscene, jio, jsys), (tscene, tio, tsys)):
        data = scene.serpentine(n, spacing=0.97, row_gap=1.1, seed=2024,
                                barrier_fraction=0.003)
        ones = np.ones((4, 4))
        system, pairs = io.system_from_data(
            data, pair=sysmod.PairLJCut(ones, ones, 1.12 * ones, shift=True),
            bonds=sysmod.BondParams(
                np.array([sysmod.BOND_FENE, sysmod.BOND_HARMONIC]),
                np.array([[30.0, 1.5, 1.0, 1.0], [3.0, 1.1, 0.0, 0.0]])),
            ex_btype=2, **kw)
        built.append((data, system, pairs))
    for a, b in zip(*built):
        _assert_same(a, b)


@pytest.mark.parametrize("n,skin,cap", [(1500, 0.3, 8), (4000, 0.5, 9),
                                        (900, 0.4, 10)])
def test_halo_gather_equals_reference_rolls(n, skin, cap):
    """The port's halo gather == the reference's six masked rolls
    (engine._halo_refresh), bit for bit, on every column."""
    system, _ = make_system(n, skin=skin, cap=cap)
    maps = fast_maps(system)
    gx = np.random.default_rng(n).uniform(
        0.0, float(min(system.box_size)), (3, maps.cap, maps.P)).astype(
            np.float32)
    want = ref._halo_refresh(jnp.asarray(gx), ref.fast_maps(system))
    got = halo_refresh(torch.tensor(gx),
                       GridConsts.build(system, maps, "cpu"))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
