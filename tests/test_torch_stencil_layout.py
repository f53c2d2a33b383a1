"""Host-side facts that the pair stencils' CUDA design rests on
(lammps_le_torch/csrc/stencil.cuh and blocked.cu), checked on the CPU:

* placement packs each column's beads into its first rows, one row a
  bead in the reference's slot order, so a j loop that ends at a column's
  last occupied row meets no empty row;
* the ghost fold (kernels_ref.ghost_fold) inverted as the fold kernel
  does it, from a per-column code of axis images: every halo column is
  the ghost image of exactly one interior column, its halo source, once,
  which is what the fold kernel's single reader of a ghost slot relies
  on;
* the kernels' argument block carries the 27 offsets' column deltas in
  _OFFSETS order and the reciprocal's form from kernels.APPROX_RCP, which
  the reference's switch LLE_APPROX_RCP=0 turns off;
* chip_smoke.pair_counts, which prices the stencils' bounds, counts the
  pairs the planes hold."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from lammps_le_torch.fast import kernels as K
from lammps_le_torch.fast import kernels_ref as R
from lammps_le_torch.fast.consts import StencilConsts
from lammps_le_torch.fast.maps import fast_maps
from lammps_le_torch.fast.place import GridConsts, place
from lammps_le_torch.ops.cells import cell_coords, wrap_positions
from lammps_le_torch.ops.grid import _OFFSETS
from torch_parity import make_system

GRIDS = [(500, 8), (2000, 9)]


def _placed(n, cap):
    system, data = make_system(n=n, cap=cap)
    maps = fast_maps(system)
    g = GridConsts.build(system, maps, "cpu")
    x = torch.tensor(data.x, dtype=torch.float32)
    e = system.max_extruders
    planes = place(system, maps, g, x, torch.zeros_like(x),
                   torch.zeros_like(x), torch.full((e,), -1),
                   torch.full((e,), -1), torch.zeros(x.shape,
                                                     dtype=torch.int64))
    return system, maps, x, planes


@pytest.mark.parametrize("n,cap", GRIDS)
def test_placement_packs_each_column(n, cap):
    """Rows 0 .. count - 1 of each column hold its beads in bead order
    (the stable sort's), the rest are empty; the counts are the cells'
    bead counts (none past cap here), halo copies included."""
    system, maps, x, planes = _placed(n, cap)
    bid = planes[3]
    occ = bid < n
    count = occ.sum(0)
    assert torch.equal(occ, torch.arange(cap)[:, None] < count[None, :])
    ids = torch.where(occ, bid, -1)
    assert bool((ids[1:] > ids[:-1])[occ[1:]].all())
    nx, ny, nz = maps.nxyz
    c3 = cell_coords(wrap_positions(x, system, torch.zeros(
        x.shape, dtype=torch.int64))[0], system)
    col = (((c3[:, 0] + 1) * (ny + 2) + c3[:, 1] + 1) * (nz + 2)
           + c3[:, 2] + 1)
    cells = torch.bincount(col, minlength=maps.P)
    assert int(cells.max()) <= cap
    interior = torch.tensor(maps.interior)
    assert torch.equal(count[interior], cells[interior])
    src = torch.tensor(maps.halo_src, dtype=torch.int64)
    assert torch.equal(count[maps.halo_cols], cells[src])


def _fold_code(maps, c):
    """fold_code_kernel's code of column c (csrc/blocked.cu): for each axis
    a, bit 2a when c + shift[a][0] lies on a's low face, bit 2a + 1 when
    c + shift[a][1] lies on its high face; 0 off the interior."""
    v = 0
    for a in range(3):
        for s in range(2) if maps.interior[c] else ():
            g = (c + maps.fold_shifts[a][s]) % maps.P
            if maps.faces[2 * a + s, g]:
                v |= 1 << (2 * a + s)
    return v


def _fold_images(maps, c):
    """The ghost images of column c in fold_kernel's order: the nonempty
    combinations of its axis images, x outermost, low before high."""
    P, s, v = maps.P, maps.fold_shifts, _fold_code(maps, c)
    out = []
    for ix in range(3):
        if ix and not (v >> (ix - 1)) & 1:
            continue
        cx = (c + s[0][ix - 1]) % P if ix else c
        for iy in range(3):
            if iy and not (v >> (1 + iy)) & 1:
                continue
            cy = (cx + s[1][iy - 1]) % P if iy else cx
            for iz in range(3):
                if (iz and not (v >> (3 + iz)) & 1) or not (ix | iy | iz):
                    continue
                out.append((cy + s[2][iz - 1]) % P if iz else cy)
    return out


@pytest.mark.parametrize("n,cap", GRIDS)
def test_fold_images_are_the_ghost_fold(n, cap):
    """The fold kernel's inverse fold: each interior column plus its
    images' values is ghost_fold's result there (f64, 1e-12), and every
    halo column is an image once, of its halo source; no other column has
    a code."""
    system, _ = make_system(n=n, cap=cap, dtype="float64")
    maps = fast_maps(system)
    f = torch.tensor(np.random.default_rng(0).normal(size=(3, cap, maps.P)))
    want = R.ghost_fold(f, torch.tensor(maps.faces), maps.fold_shifts)
    seen = {}
    for c in range(maps.P):
        images = _fold_images(maps, c)
        if not maps.interior[c]:
            assert _fold_code(maps, c) == 0 and not images
            continue
        got = f[:, :, c].clone()
        for g in images:
            assert maps.src_cols[g] == c
            seen[g] = seen.get(g, 0) + 1
            got += f[:, :, g]
        assert float((got - want[:, :, c]).abs().max()) <= 1e-12
    assert sorted(seen) == sorted(maps.halo_cols.tolist())
    assert set(seen.values()) == {1}


def test_stencil_args_offsets_and_reciprocal(monkeypatch):
    system, _ = make_system()
    maps = fast_maps(system)
    C = StencilConsts(system)
    sx, sy, sz = maps.strides
    a = K._stencil_args(C, system.n, maps.strides, True, maps.cap, maps.P)
    assert list(a.delta) == [i * sx + j * sy + k * sz
                             for (i, j, k) in _OFFSETS]
    assert a.approx == int(K.APPROX_RCP) and (a.cap, a.P) == (maps.cap,
                                                              maps.P)
    monkeypatch.setattr(K, "APPROX_RCP", False)
    assert K._stencil_args(C, system.n, maps.strides, True, maps.cap,
                           maps.P).approx == 0


def test_approx_rcp_follows_the_reference_switch():
    """On by default, as the reference's APPROX_RCP; LLE_APPROX_RCP=0,
    read at import, turns it off."""
    assert K.APPROX_RCP == (os.environ.get("LLE_APPROX_RCP", "1") == "1")
    env = dict(os.environ, LLE_APPROX_RCP="0")
    out = subprocess.run(
        [sys.executable, "-c", "import lammps_le_torch.fast.kernels as K; "
         "print(K.APPROX_RCP)"], env=env, capture_output=True, text=True,
        check=True, timeout=120)
    assert out.stdout.split()[-1] == "False"


@pytest.mark.parametrize("n,cap", GRIDS)
def test_bound_pair_counts(n, cap):
    """With no cut, every valid i against the occupied j rows of each of
    its 27 columns (the column occupancies' products); within the cut, a
    brute force over every valid and occupied slot; bonds alone, both
    sides of every link."""
    system, maps, _, planes = _placed(n, cap)
    gx, bid, hn = planes[0], planes[3], planes[4]
    interior = torch.tensor(maps.interior)
    sx, sy, sz = maps.strides
    deltas = {(a, b, c): (lambda t, d=a * sx + b * sy + c * sz:
                          torch.roll(t, -d, -1)) for (a, b, c) in _OFFSETS}

    def count(cutsq, bonds=True):
        h = hn if bonds else torch.zeros_like(hn)
        return chip_smoke.pair_counts(gx, bid, h, interior, n, cutsq,
                                      _OFFSETS, deltas)

    valid = R.valid_mask(bid, interior, n)
    occ, n_i = (bid < n).sum(0), valid.sum(0)
    for (a, b, c), (k, act) in count(float("inf")).items():
        d = a * sx + b * sy + c * sz
        want = int((n_i * (occ - 1)).sum() if d == 0
                   else (n_i * torch.roll(occ, -d)).sum())
        assert k == act == want
    cutsq = StencilConsts(system).cutsq
    xi, xj = gx[:, valid].T, gx[:, bid < n].T
    rsq = ((xi[:, None] - xj[None]) ** 2).sum(-1)
    same = (torch.nonzero(valid.flatten())[:, 0][:, None]
            == torch.nonzero((bid < n).flatten())[:, 0][None])
    brute = int(((rsq < cutsq) & ~same).sum())
    assert 0 < brute == sum(a for _, a in count(cutsq, False).values())
    links = int((valid & hn).sum())
    assert 0 < 2 * links == sum(a for _, a in count(0.0).values())


def test_langevin_bound(monkeypatch):
    """chip_smoke.langevin_bound's arithmetic on small planes: the bytes
    the kernel streams (76 B a slot, 80 with the group plane, the
    interior mask), ~46 f32 operations a slot (52 with zero), and
    threefry's integer work at the int32 rate: three words of
    THREEFRY_OPS (77) for each valid slot, or each group member with a
    group, counted once."""
    system, maps, _, planes = _placed(*GRIDS[0])
    bid, n = planes[3], system.n
    interior = torch.tensor(maps.interior)
    cap, P = bid.shape
    valid = R.valid_mask(bid, interior, n)
    lgm = (bid < n // 2).to(torch.float32)
    members = int((valid & (lgm > 0)).sum())
    assert 0 < members < int(valid.sum())
    assert chip_smoke.THREEFRY_OPS == 77 and chip_smoke.INT_LANES_SM == 64
    rates = dict(f32=1e15, int32=1e9, mufu=1e15, div=10)
    monkeypatch.setattr(chip_smoke, "RATES", rates)
    ms, by = chip_smoke.langevin_bound(bid, interior, n)
    assert by == "operations"
    assert ms == pytest.approx(3 * 77 * int(valid.sum()) / 1e6, rel=1e-12)
    ms, by = chip_smoke.langevin_bound(bid, interior, n, lgm, True)
    assert ms == pytest.approx(3 * 77 * members / 1e6, rel=1e-12)
    rates.update(f32=1e9, int32=1e15)
    ms, by = chip_smoke.langevin_bound(bid, interior, n, lgm, True)
    assert by == "operations"
    assert ms == pytest.approx(cap * P * 52 / 1e6, rel=1e-12)
    rates.update(f32=1e15)
    for group, width in ((None, 76), (lgm, 80)):
        ms, by = chip_smoke.langevin_bound(bid, interior, n, group)
        assert by == "bytes"
        assert ms == pytest.approx((cap * P * width + P) / chip_smoke.HBM_BPS
                                   * 1e3, rel=1e-12)
