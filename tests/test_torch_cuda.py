"""The CUDA kernels of lammps_le_torch against their plain versions, and
the engine on the card against the engine on the CPU.  They need a CUDA
device and skip without one.  The file imports no jax (the machine with
the card has none); run it there with

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from lammps_le_torch.fast import kernels as K
from lammps_le_torch.fast import kernels_ref as R
from lammps_le_torch.fast.consts import SpringConsts, StencilConsts
from lammps_le_torch.fast.maps import fast_maps
from lammps_le_torch.fast.place import GridConsts, place
from lammps_le_torch.io.data import system_from_data
from lammps_le_torch.scene import serpentine
from lammps_le_torch.system import (BOND_FENE, BOND_HARMONIC, BondParams,
                                    PairLJCut)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _system(n=2000, cap=9):
    data = serpentine(n, spacing=0.97, row_gap=1.1, seed=5,
                      barrier_fraction=0.01)
    ones = np.ones((4, 4))
    system, _ = system_from_data(
        data, pair=PairLJCut(ones, ones, 1.12 * ones, shift=True),
        bonds=BondParams(np.array([BOND_FENE, BOND_HARMONIC]),
                         np.array([[30.0, 1.5, 1.0, 1.0],
                                   [3.0, 1.1, 0.0, 0.0]])),
        ex_btype=2, max_extruders=64, skin=0.5, rebuild_every=40,
        cell_cap=cap)
    return system, data


def _planes_x():
    """Thermal-ish positions of _system's beads: one FENE bond past the
    clamp (bead 100), one out of the stencil's reach (bead 300)."""
    _, data = _system()
    r = np.random.default_rng(0)
    x = data.x + r.normal(scale=0.05, size=data.x.shape)
    x[100, 0] += 1.45
    x[300, 1] += 4.5
    return x


def _planes(dev, cap=9):
    """_planes_x on the grid, on the card."""
    system, _ = _system(cap=cap)
    maps = fast_maps(system)
    g = GridConsts.build(system, maps, dev)
    p = _place(system, maps, g, _planes_x(), dev)
    return system, maps, g, p, torch.arange(system.max_extruders,
                                            device=dev) < 20


def _place(system, maps, g, x, dev):
    """The planes of positions x, with 20 extruders (random v and f)."""
    r = np.random.default_rng(0)
    r.normal(scale=0.05, size=x.shape)
    e = system.max_extruders
    left = np.full(e, -1, np.int64)
    right = np.full(e, -1, np.int64)
    left[:20] = np.arange(20) * 97 + 3
    right[:20] = left[:20] + 2
    f32 = dict(dtype=torch.float32, device=dev)
    return place(system, maps, g, torch.tensor(x, **f32),
                 torch.tensor(r.normal(size=x.shape), **f32),
                 torch.tensor(r.normal(size=x.shape), **f32),
                 torch.tensor(left, device=dev),
                 torch.tensor(right, device=dev),
                 torch.zeros(x.shape, dtype=torch.int64, device=dev))


def _close(a, b):
    return float((a - b).abs().max()) <= 3e-5 * max(float(b.abs().max()),
                                                     1.0)


def _misaligned(t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["out_of_place", "in_place", "unaligned"])
def test_kick_drift_halo_bitwise(dev, form):
    """K2a, one launch writing every halo copy from its source's thread by
    the image map, bitwise its plain version (the halo lists' gather):
    out of place, in place on the planes (the step loop's form), and on
    planes not 16-byte aligned."""
    system, maps, g, p, _ = _planes(dev)
    # a NaN force on a halo slot and an inf one on a padding slot: the
    # plain version's (kick * f) * 0 gives NaN v there
    gf = p[2].clone()
    gf[0, 0, int(maps.halo_cols[5])] = float("nan")
    gf[1, 2, maps.P - 1] = float("inf")
    args = (p[0], p[1], gf, p[3], g.interior, g.halo_cols, g.halo_src,
            g.halo_shift, system.n, 0.003, 0.006)
    want = R.kick_drift_halo(*args)
    K.reset_launches()
    if form == "in_place":
        gx, gv = p[0].clone(), p[1].clone()
        im = g.images
        _, cap, P = gx.shape
        assert K._lib().lle_kick_drift_halo(
            K._ptr(gx), K._ptr(gv), K._ptr(gf), K._ptr(p[3]),
            K._ptr(g.interior), K._ptr(im.own), K._ptr(im.ptr),
            K._ptr(im.idx), K._ptr(im.src), K._ptr(im.shift), K._ptr(gx),
            K._ptr(gv), None,
            cap, P, im.idx.shape[0], system.n, 0.003, 0.006, 1,
            K._stream()) == 0
        got = (gx, gv)
    elif form == "unaligned":
        got = K.kick_drift_halo(*map(_misaligned, args[:4]), *args[4:],
                                images=g.images)
        assert K.LAUNCHES["kick_drift_halo"] == 1
    else:
        got = K.kick_drift_halo(*args, images=g.images)
        assert K.LAUNCHES["kick_drift_halo"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert bool(want[1].isnan().any())
    with pytest.raises(ValueError, match="image map"):
        K.kick_drift_halo(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("sp", [2, 4])
def test_kick_drift_halo_slab_sends(dev, sp):
    """K2a on each slab with its image map (local images in place, the
    others into its send buffer, one launch a slab), then
    ``SlabPlan.halo`` from the send buffers: the slabs bitwise the whole
    plane's plain kick + drift + halo refresh, and each slab's launch
    bitwise its plain version, send buffer included."""
    from lammps_le_torch.parallel.shard_step import SlabPlan

    system, maps, g, p, _ = _planes(dev)
    plan = SlabPlan(system, maps, [dev] * sp)
    C = maps.P // sp
    want = R.kick_drift_halo(p[0], p[1], p[2], p[3], g.interior,
                             g.halo_cols, g.halo_src, g.halo_shift,
                             system.n, 0.003, 0.006)
    K.reset_launches()
    xs, vs, sends = [], [], []
    for s in range(sp):
        a = tuple(t[..., s * C:(s + 1) * C].contiguous() for t in p[:4])
        im = plan.images[s]
        a += (plan.interior[s], *im.halo_lists, system.n, 0.003, 0.006, im)
        got, ref = K.kick_drift_halo(*a), R.kick_drift_halo(*a)
        assert len(got) == len(ref) == 3
        assert all(torch.equal(x, y) for x, y in zip(got, ref))
        xs.append(got[0])
        vs.append(got[1])
        sends.append(got[2])
    assert K.LAUNCHES["kick_drift_halo"] == sp
    plan.halo(xs, sends)
    assert torch.equal(torch.cat(xs, -1), want[0])
    assert torch.equal(torch.cat(vs, -1), want[1])


# the pair stencils' cases: cap x energies x reciprocal form on thermal
# planes, and planes with one interior column holding cap beads
STENCIL_CASES = ([(cap, energy, approx, False) for cap in (8, 9, 16)
                  for energy in (True, False) for approx in (True, False)]
                 + [(9, True, True, True), (9, True, False, True),
                    (16, True, True, True), (16, False, False, True)])


@pytest.fixture
def rcp_form(monkeypatch):
    """Set the stencils' reciprocal form (kernels.APPROX_RCP) for a test."""
    def set_form(approx):
        monkeypatch.setattr(K, "APPROX_RCP", approx)
    return set_form


def _stencil_planes(dev, cap, crowd):
    """_planes, and with ``crowd`` cap beads moved into an empty interior
    cell (a column with every row full, its beads 0.7 apart on a lattice)
    beside another interior column left empty.  Returns (system, maps, g,
    planes, the full column or None, the empty column)."""
    from lammps_le_torch.ops.cells import cell_coords

    system, maps, g, p, _ = _planes(dev, cap)
    n = system.n
    occ = (p[3] < n).sum(0)
    empty = torch.nonzero((occ == 0) & g.interior)[:, 0].tolist()
    if not crowd:
        return system, maps, g, p, None, empty[0]
    full, keep = empty[0], empty[-1]
    _, ny, nz = maps.nxyz
    py, pz = ny + 2, nz + 2
    c3 = np.array([full // (py * pz), (full // pz) % py, full % pz]) - 1
    nb = system.neighbor
    h = np.array(system.box_size) / np.array([nb.nx, nb.ny, nb.nz])
    center = np.array(system.box_lo) + (c3 + 0.5) * h
    lattice = np.array([(i, j, k) for k in range(2) for j in range(3)
                        for i in range(3)], float)[:cap] - [1.0, 1.0, 0.5]
    assert len(lattice) == cap
    x = torch.tensor(_planes_x(), dtype=torch.float64)
    moved = np.arange(cap) * 37 + 900
    x[moved] = torch.tensor(center + 0.7 * lattice)
    assert torch.equal(cell_coords(x[moved], system),
                       torch.tensor(c3).expand(cap, 3))
    p = _place(system, maps, g, x.numpy(), dev)
    occ = (p[3] < n).sum(0)
    assert int(occ[full]) == cap and int(occ[keep]) == 0
    return system, maps, g, p, full, keep


def _check_stencil(a, b, r, g, empty, full=None):
    """Two launches bitwise equal, the plain version's forces within 3e-5
    max|f|, its energies within 2e-2, its flags and clamps equal (the
    planes set FLAG_BOND_REACH and FLAG_FENE_CLAMP); ghost columns and the
    empty column exactly 0."""
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _close(a[0], r[0])
    assert float((a[1] - r[1]).abs().max()) <= 2e-2
    assert torch.equal(a[2], r[2]) and int(a[2][0]) == 64 | 8
    assert float(a[0][:, :, ~g.interior].abs().max()) == 0.0
    assert float(a[0][:, :, empty].abs().max()) == 0.0
    if full is not None:
        assert bool((a[0][:, :, full].abs().sum(0) > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("cap,energy,approx,crowd", STENCIL_CASES)
def test_stencil_forces(dev, rcp_form, cap, energy, approx, crowd):
    rcp_form(approx)
    system, maps, g, p, full, empty = _stencil_planes(dev, cap, crowd)
    args = (p[0], p[3], p[4], p[5], g.interior, StencilConsts(system),
            system.n, maps.strides, energy)
    K.reset_launches()
    a = K.stencil_forces(*args)
    b = K.stencil_forces(*args)
    assert K.LAUNCHES["stencil_forces"] == 2
    _check_stencil(a, b, R.stencil_forces(*args), g, empty, full)


@pytest.mark.cuda
@pytest.mark.parametrize("cap,energy,approx,crowd", STENCIL_CASES)
def test_newton_half_forces(dev, rcp_form, cap, energy, approx, crowd):
    """Against the plain version, ghost columns exactly zero, and two
    launches on the same inputs bitwise equal (no atomics)."""
    rcp_form(approx)
    system, maps, g, p, full, empty = _stencil_planes(dev, cap, crowd)
    args = (p[0], p[3], p[4], p[5], g.interior, g.faces,
            StencilConsts(system), system.n, maps.strides, maps.fold_shifts,
            energy)
    K.reset_launches()
    a = K.newton_half_forces(*args)
    b = K.newton_half_forces(*args)
    assert K.LAUNCHES["newton_half_forces"] == 2
    _check_stencil(a, b, R.newton_half_forces(*args), g, empty, full)


@pytest.mark.cuda
def test_stencil_reciprocal_forms(dev, rcp_form):
    """The approximate and the IEEE reciprocal on the same planes: forces
    within 3e-5 max|f| of each other, flags and clamps equal; the IEEE
    form is every pair's plain value, so its one-launch-per-offset sums
    stay within the plain version's tolerance too."""
    system, maps, g, p, _, _ = _stencil_planes(dev, 9, False)
    args = (p[0], p[3], p[4], p[5], g.interior, g.faces,
            StencilConsts(system), system.n, maps.strides, maps.fold_shifts,
            True)
    out = {}
    for approx in (True, False):
        rcp_form(approx)
        out[approx] = K.newton_half_forces(*args)
    assert _close(out[True][0], out[False][0])
    assert torch.equal(out[True][2], out[False][2])
    assert not torch.equal(out[True][0], out[False][0])


@pytest.mark.cuda
def test_extruder_springs(dev):
    system, _, _, p, active = _planes(dev)
    f1 = torch.randn_like(p[0])
    f2 = f1.clone()
    S = SpringConsts(system, 2)
    e1 = K.extruder_springs(p[0], f1, p[7], p[8], active, S)
    e2 = R.extruder_springs(p[0], f2, p[7], p[8], active, S)
    assert _close(f1, f2)
    assert abs(float(e1.sum()) - float(e2.sum())) <= 2e-2


@pytest.mark.cuda
def test_langevin_kick_monitor(dev):
    system, _, g, p, _ = _planes(dev)
    n = system.n
    zeros = torch.zeros_like(p[0])
    noise = K.langevin_kick_monitor(
        p[0], p[0], zeros, zeros, p[3], g.interior, (7, 9), 33, 0.0, 1.0,
        0.0, 0.006, 1.0, 1.0, n, True)[0]
    valid = R.valid_mask(p[3], g.interior, n).to(torch.float32)
    assert torch.equal(noise,
                       R.langevin_noise((7, 9), p[3], 33, torch.float32)
                       * valid)
    for cuts in ((0.02, 0.01), (9.0, 9.0)):
        args = (p[0], p[0] + 0.01, p[1], p[2], p[3], g.interior, (7, 9), 33,
                -0.1, 0.7, 0.003, 0.006, *cuts, n, True)
        a = K.langevin_kick_monitor(*args)
        b = R.langevin_kick_monitor(*args)
        assert torch.equal(a[2], b[2])
        assert _close(a[0], b[0]) and _close(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("sp,energy", [(2, True), (4, False), (1, True)])
def test_window_forces(dev, rcp_form, sp, energy, approx):
    """The sharded stencil's window kernel against its plain version on
    sp windows (one launch for all), two launches bitwise equal, its
    bond sightings, clamps and links equal; the assembled, folded forces
    against stencil_forces, ghost columns 0."""
    from lammps_le_torch.parallel.shard_step import make_sharded_kernel

    rcp_form(approx)
    system, maps, g, p, _ = _planes(dev)
    kern = make_sharded_kernel(system, maps, 2, [dev] * sp)
    (slabs, args), = kern.window_args(p[0], p[3], p[4], p[5], energy)
    assert slabs == list(range(sp))
    K.reset_launches()
    a = K.window_forces(*args)
    b = K.window_forces(*args)
    r = R.window_forces(*args)
    assert K.LAUNCHES["window_forces"] == 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _close(a[0], r[0])
    assert float((a[1][:2] - r[1][:2]).abs().max()) <= 2e-2
    assert torch.equal(a[1][2:], r[1][2:])
    gf, en, ints = kern(g, p[0], p[3], p[4], p[5], energy)
    full = K.stencil_forces(p[0], p[3], p[4], p[5], g.interior,
                            StencilConsts(system), system.n, maps.strides,
                            energy)
    valid = R.valid_mask(p[3], g.interior, system.n)
    assert float((full[0] * valid - gf).abs().max()) <= 2e-4 * max(
        float(full[0].abs().max()), 1.0)
    assert torch.equal(ints, full[2]) and int(ints[0]) == 64 | 8
    assert float(gf[:, :, ~g.interior].abs().max()) == 0.0


# K5's cases: cap x energies on thermal planes (a cap past 16, the old
# kernel's limit, among them), crowded planes as STENCIL_CASES', and
# planes whose rows are shuffled within each column
TILED_CASES = ([(cap, energy, False, False) for cap in (8, 9, 12, 16, 24)
                for energy in (True, False)]
               + [(9, True, True, False), (16, False, True, False),
                  (9, True, False, True), (16, True, True, True),
                  (24, False, False, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("cap,energy,crowd,shuffle", TILED_CASES)
def test_tiled_stencil_forces(dev, cap, energy, crowd, shuffle):
    """K5 on the shared block body against its plain version (K5's own
    formulas), two launches bitwise equal, on packed planes and on planes
    whose rows are shuffled within each column (the body must be exact
    for any plane)."""
    system, maps, g, p, full, empty = _stencil_planes(dev, cap, crowd)
    planes = (p[0], p[3], p[4], p[5])
    if shuffle:
        planes = chip_smoke.shuffle_rows(planes, seed=cap)
        assert not torch.equal(planes[1], p[3])
    args = planes + (g.interior, StencilConsts(system), system.n,
                     maps.strides, energy)
    K.reset_launches()
    a = K.tiled_stencil_forces(*args)
    b = K.tiled_stencil_forces(*args)
    assert K.LAUNCHES["tiled_stencil_forces"] == 2
    _check_stencil(a, b, R.tiled_stencil_forces(*args), g, empty, full)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(dev):
    """40 steps with every LE fix: the same events on the card (kernels)
    as on the CPU (plain versions), positions within 1e-3, each kernel
    launched once a step on the card and never on the CPU."""
    chip_smoke.small_end_to_end(dev)


@pytest.mark.cuda
def test_newton_half_engine_on_card_matches_cpu(dev):
    """The same on the Newton-half stencil (the engine's kernel past the
    whole-plane gate), passed in as kernel_fn."""
    chip_smoke.small_end_to_end(dev, stencil="newton_half_forces")


@pytest.mark.cuda
@pytest.mark.parametrize("stencil", ["window_forces", "tiled_stencil_forces"])
def test_kernel_path_engine_on_card_matches_cpu(dev, stencil):
    """The same on the sharded slab stencil (two slabs on the card) and on
    the tiled full stencil, each passed in as kernel_fn."""
    chip_smoke.small_end_to_end(dev, stencil=stencil)


@pytest.mark.cuda
@pytest.mark.parametrize("sp", [2, 4])
def test_slab_resident_engine_on_card(dev, sp):
    """40 steps with every LE fix on the slab-resident state (sp slabs on
    the card): bit for bit the whole-state chain on the same slab stencil
    on the card, the same events as the slab-resident run on the CPU
    (plain versions) with positions within 1e-3, and each kernel of the
    slab step launched as chip_smoke.slab_launches says."""
    from lammps_le_torch.fast import (from_fast, make_fast_segment,
                                      run_fast, to_fast)
    from lammps_le_torch.fixes import NVE, Langevin
    from lammps_le_torch.integrate import Simulation
    from lammps_le_torch.parallel.spatial import (
        gather_fast_state, make_sharded_segment, shard_fast_state)
    from lammps_le_torch.state import init_state

    data, system = chip_smoke.production_config(2000, seed=5)
    warm = Simulation(system=system, dt=0.006, ex_btype=2, fixes=(
        NVE(), Langevin(t_start=1.0, t_stop=1.0, damp=1.0, seed=7)))
    sim = Simulation(system=system, dt=0.005, energy_every=4, ex_btype=2,
                     fixes=chip_smoke.le_fixes(5, 7, 0.3))
    runs = {}
    for d in ("cpu", dev):
        st = init_state(system, data.x, types=data.types, seed=11, device=d)
        st, _ = run_fast(warm, st, 30)
        st = chip_smoke.seed_extruders(st, 20, 100, system.max_extruders)
        mesh = [d] * sp
        seg = make_sharded_segment(sim, mesh)
        fs = to_fast(st, sim, kernel_fn=seg.kernel_fn)
        b = fs.step
        K.reset_launches()
        sfs = seg(shard_fast_state(fs, mesh), b, 40, b, b + 40)
        runs[str(d)] = gather_fast_state(sfs), dict(K.LAUNCHES), mesh
        if d != "cpu":
            whole, _ = make_fast_segment(sim, pallas=False,
                                         kernel_fn=seg.kernel_fn, device=d)
            want = whole(fs, b, 40, b, b + 40)
    (a, la, _), (c, lc, mesh) = runs["cpu"], runs[str(dev)]
    assert chip_smoke.same_state(c, want) == []
    assert not any(la.values())
    assert lc == chip_smoke.slab_launches(lc, 40, mesh)
    x_a, x_c = (from_fast(f, system).x.cpu() for f in (a, c))
    assert float((x_a - x_c).abs().max()) < 1e-3
    for k in ("ex_left", "ex_right", "n_moves", "n_loads", "n_unloads",
              "flags"):
        assert torch.equal(getattr(a, k), getattr(c, k).cpu()), k
    assert int(c.n_moves) > 0


def _group_plane(system, maps, p, frac):
    """The 0/1 Langevin-group plane of beads 1 to frac * n."""
    from lammps_le_torch.fast.engine import _lgm_plane

    member = np.zeros(system.n, bool)
    member[:int(frac * system.n)] = True
    return _lgm_plane(member, p[6], maps, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("zero,group", [(True, False), (True, True),
                                        (False, True)])
def test_langevin_kick_monitor_zero_group(dev, zero, group):
    """fix langevin zero and group against the plain version; two
    launches bitwise equal (the zero pass reduces without atomics)."""
    system, maps, g, p, _ = _planes(dev)
    lgm = _group_plane(system, maps, p, 0.9) if group else None
    args = (p[0], p[0] + 0.01, p[1], p[2], p[3], g.interior, (7, 9), 33,
            -0.1, 0.7, 0.003, 0.006, 9.0, 9.0, system.n, True, lgm, zero)
    K.reset_launches()
    a = K.langevin_kick_monitor(*args)
    b = K.langevin_kick_monitor(*args)
    r = R.langevin_kick_monitor(*args)
    assert K.LAUNCHES["langevin_kick_monitor"] == 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(a[2], r[2])
    assert _close(a[0], r[0]) and _close(a[1], r[1])


def _slabs(t, sp=2):
    C = t.shape[-1] // sp
    return [t[..., i * C:(i + 1) * C].contiguous() for i in range(sp)]


@pytest.mark.cuda
@pytest.mark.parametrize("zero,group", [(False, False), (False, True),
                                        (True, True)])
def test_split_langevin_passes(dev, zero, group):
    """The slab step's split Langevin entries on two slabs of the planes:
    langevin_sums within f32 round-off of the plain sums (another order);
    langevin_kick_parts given the same means (or none) bit for bit its
    plain version, forces, velocities and monitor values; the slabs'
    monitor merged is the whole-plane kernel's flag bits and trigger.
    One launch each, counted under its own name."""
    system, maps, g, p, _ = _planes(dev)
    n = system.n
    lgm = _group_plane(system, maps, p, 0.9) if group else None
    gx_ref = p[0] + 0.01 * torch.sin(p[0])
    whole = K.langevin_kick_monitor(
        p[0], gx_ref, p[1], p[2], p[3], g.interior, (7, 9), 33, -0.1, 0.7,
        0.003, 0.006, 0.01, 0.02, n, True, lgm, zero)
    sl = [_slabs(t) for t in (p[0], gx_ref, p[1], p[2], p[3], g.interior)]
    lg = _slabs(lgm) if group else [None, None]
    means = None
    K.reset_launches()
    if zero:
        sums = [K.langevin_sums(sl[0][i], sl[4][i], sl[5][i], lg[i], (7, 9),
                                33, n) for i in range(2)]
        for i, got in enumerate(sums):
            want = R.langevin_sums(sl[0][i], sl[4][i], sl[5][i], lg[i],
                                   (7, 9), 33, n)
            assert float((got - want).abs().max()) <= 1e-4 * max(
                float(want.abs().max()), 1.0)
        tot = sums[0] + sums[1]
        means = tot[:3] * (1.0 / torch.clamp(tot[3], min=1.0))
    parts = []
    for i in range(2):
        args = ([t[i] for t in sl[:6]] + [(7, 9), 33, -0.1, 0.7, 0.003,
                                          0.006, n, True, lg[i], means])
        a = K.langevin_kick_parts(*args)
        b = R.langevin_kick_parts(*args)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        parts.append(a[2])
    assert K.LAUNCHES["langevin_kick_parts"] == 2
    assert K.LAUNCHES["langevin_sums"] == (2 if zero else 0)
    assert K.LAUNCHES["langevin_kick_monitor"] == 0
    from lammps_le_torch.parallel.slab_step import merge_monitor

    ints = merge_monitor(torch.stack(parts), 0.01, 0.02)
    assert torch.equal(ints, whole[2]) and ints.tolist() == [4, 1]


# the plain version's forces and velocities without zero (x, y, z; float
# hex of f32 values, computed on the CPU) at the slots of beads 0, 777 and
# 1999, with and without the group of beads 1-1,800 (bead 1999 lies
# outside it): the kernel gives them bit for bit, as it did before its
# finishing pass moved into its last block
NOZERO_PINS = {
    False: {0: (("0x1.85e938p-1", "-0x1.e6bb3ap-2", "0x1.403720p-1"),
                ("-0x1.597e12p+0", "-0x1.53f78ep-1", "-0x1.475e78p-4")),
            777: (("-0x1.732d16p+0", "0x1.1ad288p+0", "-0x1.03d472p-2"),
                  ("0x1.6c8162p+0", "0x1.68356ap-1", "-0x1.3493cep-3")),
            1999: (("0x1.16d8f2p-1", "-0x1.475f4ep-3", "-0x1.d437c0p-9"),
                   ("0x1.2c6c3ap-2", "0x1.a5ffa6p+0", "0x1.a009d8p-2"))},
    True: {0: (("0x1.85e938p-1", "-0x1.e6bb3ap-2", "0x1.403720p-1"),
               ("-0x1.597e12p+0", "-0x1.53f78ep-1", "-0x1.475e78p-4")),
           777: (("-0x1.732d16p+0", "0x1.1ad288p+0", "-0x1.03d472p-2"),
                 ("0x1.6c8162p+0", "0x1.68356ap-1", "-0x1.3493cep-3")),
           1999: (("0x1.d7c016p-1", "-0x1.663a36p-5", "-0x1.69804ep-4"),
                  ("0x1.2d9486p-2", "0x1.a6167cp+0", "0x1.9fc740p-2"))}}


@pytest.mark.cuda
@pytest.mark.parametrize("group", [False, True])
def test_langevin_no_zero_is_pinned(dev, group):
    """Without zero the kernel (one launch) is its plain version bit for
    bit: every output equal, and the pinned values at three beads."""
    system, maps, g, p, _ = _planes(dev)
    lgm = _group_plane(system, maps, p, 0.9) if group else None
    args = (p[0], p[0] + 0.01, p[1], p[2], p[3], g.interior, (7, 9), 33,
            -0.1, 0.7, 0.003, 0.006, 9.0, 9.0, system.n, True, lgm, False)
    gf, gv, ints = K.langevin_kick_monitor(*args)
    r = R.langevin_kick_monitor(*args)
    assert torch.equal(gf, r[0]) and torch.equal(gv, r[1])
    assert ints.tolist() == r[2].tolist() == [0, 0]
    P = p[3].shape[1]
    for bead, (f_pin, v_pin) in NOZERO_PINS[group].items():
        row, col = divmod(int(p[6][bead]), P)
        assert [float(gf[k, row, col]) for k in range(3)] == [
            float.fromhex(h) for h in f_pin]
        assert [float(gv[k, row, col]) for k in range(3)] == [
            float.fromhex(h) for h in v_pin]


@pytest.mark.cuda
def test_zero_group_phase(dev):
    """chip_smoke's path-5 kernel checks on small planes: the group's
    random force sums to zero, slots outside it as with zero off; the
    step loop's graph nodes a step with zero on and off."""
    from lammps_le_torch.fixes import Langevin
    from lammps_le_torch.integrate import Simulation

    system, maps, g, p, _ = _planes(dev)
    fs = SimpleNamespace(gx=p[0], gx_ref=p[0] + 0.01, gv=p[1], gf=p[2],
                         bid=p[3], lgm=_group_plane(system, maps, p, 0.9),
                         exl_slot=p[7], step=33)
    sim = Simulation(system=system, dt=0.006, ex_btype=2, fixes=(
        Langevin(1.0, 1.0, 10.0, zero=True, group="chain"),))
    chip_smoke.set_rates(chip_smoke.card_line())
    chip_smoke.zero_group_phase(fs, sim, g)


@pytest.mark.cuda
@pytest.mark.parametrize("approx", [False, True])
def test_rcp_chain(dev, approx):
    """P1's chain against the plain exact chain: bitwise when exact;
    within a step's ulp of acc and 1 ulp of r * 1e-7 when approximate."""
    from lammps_le_torch import probes
    from lammps_le_torch.probes import probe_rcp as C

    x = torch.rand(8, 4096, device=dev) * 2.1 + 0.5
    probes.reset_launches()
    got = C.rcp_chain(x, approx, 200)
    assert probes.LAUNCHES["rcp_chain"] == 1
    want = C.rcp_chain_ref(x, 200)
    if approx:
        tol = 200 * 2.0 ** -23 * (2e-7 + float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_rcp_precision_and_price(dev):
    """rcp.approx within 2^-22 relative over both domains, the IEEE
    reciprocal within 2^-24; its SASS fast path priced."""
    from lammps_le_torch.probes import probe_rcp as C

    for lo, hi, _ in C.DOMAINS:
        assert C.precision(lo, hi)[2] <= 2.0 ** -22
        assert C.precision(lo, hi, approx=False)[2] <= 2.0 ** -24
    price, exact, approx = C.rcp_price()
    assert price > 1 and "MUFU.RCP" in exact


@pytest.mark.cuda
def test_chain_step_instructions(dev):
    """The compiled chains' main loops: at least the 15 operations a step
    that do not hoist, in f32; bf16 folds x * 1 - a."""
    from lammps_le_torch.probes import probe_bf16 as B

    steps = B.step_instructions()
    assert steps[torch.float32][0] >= 15
    assert 10 <= steps[torch.bfloat16][0] <= B.CHAIN_OPS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_elementwise_chain(dev, dtype):
    """P2's chain against its plain version on the card: f32 bitwise,
    packed bf16 within one bf16 ulp of max|out|."""
    from lammps_le_torch.probes import probe_bf16 as B

    x = B.inputs(8, dev)[:, :4096].contiguous().to(dtype)
    got = B.chain(x, dtype, 100)
    want = B.chain_ref(x, 100)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        ulp = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
        assert float((got - want).abs().max()) <= ulp


def _warm_run(dev, fixes, energy_every):
    """chip_smoke's small system warmed 30 steps on the card, 20 seeded
    extruders: (Simulation with ``fixes``, State)."""
    from lammps_le_torch.fast import run_fast
    from lammps_le_torch.fixes import NVE, Langevin
    from lammps_le_torch.integrate import Simulation
    from lammps_le_torch.state import init_state

    data, system = chip_smoke.production_config(2000, seed=5)
    warm = Simulation(system=system, dt=0.006, ex_btype=2, fixes=(
        NVE(), Langevin(t_start=1.0, t_stop=1.0, damp=1.0, seed=7)))
    st = init_state(system, data.x, types=data.types, seed=11, device=dev)
    st, _ = run_fast(warm, st, 30)
    st = chip_smoke.seed_extruders(st, 20, 100, system.max_extruders)
    sim = Simulation(system=system, dt=0.005, energy_every=energy_every,
                     ex_btype=2, fixes=fixes)
    return sim, st


def _same_run(a, b):
    for name in ("gx", "gv", "gf", "ex_left", "ex_right", "types", "flags",
                 "epair", "ebond", "n_moves", "n_loads", "n_unloads",
                 "n_clamps", "last_event"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in ("step", "n_rebuilds", "skin_pend"):
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["le", "quiet", "zero"])
def test_step_loop_is_the_chain_bitwise(dev, run):
    """60 steps in K2's step loop on the card (graph replays) and on the
    eager chain from the same state: the same run bit for bit, in fewer
    launches than steps; with every LE fix and energies every 4 steps, a
    quiet NVE + Langevin window with energies every 25, and every LE fix
    with fix langevin zero on the group of beads 1-1,800."""
    from lammps_le_torch.fast import make_fast_segment, to_fast
    from lammps_le_torch.fixes import NVE, Langevin

    groups = None
    if run == "le":
        fixes, energy_every = chip_smoke.le_fixes(5, 7, 0.3), 4
    elif run == "quiet":
        fixes, energy_every = (NVE(), Langevin(1.0, 1.0, 10.0, seed=3)), 25
    else:
        fixes = chip_smoke.le_fixes(5, 7, 0.3, zero=True, group="chain")
        energy_every = 4
        member = np.zeros(2000, bool)
        member[:1800] = True
        groups = {"chain": member}
    sim, st = _warm_run(dev, fixes, energy_every)
    runs = {}
    for pallas in (False, "real"):
        segment, _ = make_fast_segment(sim, pallas=pallas, device=dev)
        fs = to_fast(st, sim, groups=groups)
        b = fs.step
        segment(fs, b, 60, b, b + 60)
        runs[pallas] = fs
    _same_run(runs[False], runs["real"])
    assert runs[False].n_launches == 0 < runs["real"].n_launches < 60
    if groups is not None:
        assert torch.equal(runs[False].lgm, runs["real"].lgm)


def _loop(dev, lan_seed=3):
    """A warmed quiet state and both forms of its step loop: (FastState,
    the kernels' call, the plain loop's call, the call's plane
    arguments)."""
    from lammps_le_torch.fast import to_fast
    from lammps_le_torch.fast.pallas_step import make_step_kernel
    from lammps_le_torch.fixes import NVE, Langevin

    lf = Langevin(1.0, 1.0, 10.0, seed=lan_seed)
    sim, st = _warm_run(dev, (NVE(), lf), 25)
    system = sim.system
    maps = fast_maps(system)
    g = GridConsts.build(system, maps, dev)
    fs = to_fast(st, sim)
    real, plain = (make_step_kernel(system, maps, 2, dt=sim.dt, langevin=lf,
                                    g=g, interpret=i) for i in (False, True))
    tail = (fs.gx_ref, fs.bid, fs.hn, fs.pid, fs.exl_slot, fs.exr_slot,
            fs.ex_left >= 0, None)
    return fs, real, plain, tail


def _one_step_chain(call, fs, tail, n):
    """``n`` one-step launches: [(x, v, f, stats)] after each."""
    out, x, v, f = [], fs.gx, fs.gv, fs.gf
    for s in range(n):
        x, v, f, st = call(x, v, f, *tail, fs.step + 1 + s, True, (5, 6),
                           1.0, 0.0, 1)
        out.append((x, v, f, st))
    return out


@pytest.mark.cuda
def test_step_loop_every_limit(dev):
    """Each limit 1-16: a launch runs min(limit, trigger) steps, bit for
    bit the one-step launches' run (one conditional graph for every
    limit), and reports the plain loop's stats rows; at 16 its planes are
    the plain loop's within the stencil's summation order (x 1e-4)."""
    fs, real, plain, tail = _loop(dev)
    ones = _one_step_chain(real, fs, tail, 16)
    fired = next((s + 1 for s, o in enumerate(ones) if o[3][6]), 17)
    K.reset_launches()
    for limit in range(1, 17):
        x, v, f, st = real(fs.gx, fs.gv, fs.gf, *tail, fs.step + 1, True,
                           (5, 6), 1.0, 0.0, limit)
        d = min(limit, fired)
        assert int(st[7]) == d
        assert torch.equal(x, ones[d - 1][0]) and torch.equal(v, ones[d - 1][1])
        assert torch.equal(f, ones[d - 1][2])
    assert K.LAUNCHES["step_loop"] == 16
    assert K.LAUNCHES["stencil_forces"] == sum(min(k, fired)
                                               for k in range(1, 17))
    xp, vp, fp, sp = plain(fs.gx, fs.gv, fs.gf, *tail, fs.step + 1, True,
                           (5, 6), 1.0, 0.0, 16)
    assert torch.equal(sp[2:], st[2:])
    assert float((xp - x).abs().max()) < 1e-4
    assert _close(fp, f)


@pytest.mark.cuda
def test_step_loop_stops_at_the_trigger(dev):
    """A bead fast enough to fire the look-ahead trigger within a few
    steps: a 16-step launch stops after that step, as the plain loop
    does, bit for bit the one-step launches' run."""
    fs, real, plain, tail = _loop(dev)
    slot = int(fs.slot_of[1000])
    P = fs.bid.shape[1]
    fs.gv[:, slot // P, slot % P] = torch.tensor([6.0, 0.0, 0.0])
    x, v, f, st = real(fs.gx, fs.gv, fs.gf, *tail, fs.step + 1, True, (5, 6),
                       1.0, 0.0, 16)
    d = int(st[7])
    assert 1 < d < 16 and st[6] == 1.0
    ones = _one_step_chain(real, fs, tail, d)
    assert [int(o[3][6]) for o in ones] == [0] * (d - 1) + [1]
    assert torch.equal(x, ones[-1][0]) and torch.equal(v, ones[-1][1])
    _, _, _, sp = plain(fs.gx, fs.gv, fs.gf, *tail, fs.step + 1, True,
                        (5, 6), 1.0, 0.0, 16)
    assert torch.equal(sp[5:], st[5:])


@pytest.mark.cuda
def test_step_loop_ends_at_the_trigger(dev):
    """A 16-step launch that the trigger stops after d steps is a d-step
    launch from the same state, planes bit for bit and stats rows equal,
    and each ran d iterations of the graph's conditional node (no dead
    steps); the graph's body is one step of 4 kernel nodes (zero off):
    K2a one, the stencil, its fold with the springs, the Langevin pass."""
    fs, real, plain, tail = _loop(dev)
    slot = int(fs.slot_of[1000])
    P = fs.bid.shape[1]
    fs.gv[:, slot // P, slot % P] = torch.tensor([6.0, 0.0, 0.0])
    head = (fs.gx, fs.gv, fs.gf) + tail + (fs.step + 1, True, (5, 6), 1.0,
                                            0.0)
    *p16, s16 = real(*head, 16)
    d = int(s16[7])
    assert 1 < d < 16 and s16[6] == 1.0
    assert real.loop.iterations == d
    *p_d, s_d = real(*head, d)
    assert real.loop.iterations == d
    assert all(torch.equal(a, b) for a, b in zip(p16, p_d))
    assert torch.equal(s16, s_d)
    assert real.loop.body_nodes()[0] == 4


def _replica_planes(dev, R=3):
    """R distinct replicas' planes of _system, stacked (each placed as
    _planes places one, its positions moved by its own noise)."""
    system, _ = _system()
    maps = fast_maps(system)
    g = GridConsts.build(system, maps, dev)
    runs = []
    for r in range(R):
        x = _planes_x() + np.random.default_rng(10 + r).normal(
            scale=0.01, size=(system.n, 3))
        runs.append(_place(system, maps, g, x, dev))
    p = tuple(torch.stack(t) for t in zip(*runs))
    active = torch.arange(system.max_extruders, device=dev) < 20
    return system, maps, g, p, active.expand(R, -1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [
    "stencil_forces", "newton_half_forces", "kick_drift_halo",
    "extruder_springs", "langevin_kick_monitor", "langevin_zero_group"])
def test_batched_kernels_are_one_run_launches(dev, kernel):
    """Each chain kernel on R = 3 replicas' planes, in one launch, against
    three one-run launches on each replica's planes: bit for bit."""
    system, maps, g, p, active = _replica_planes(dev)
    n, C = system.n, StencilConsts(system)
    R3 = p[0].shape[0]
    if kernel == "stencil_forces":
        def call(gx, bid, hn, pid):
            return K.stencil_forces(gx, bid, hn, pid, g.interior, C, n,
                                    maps.strides, True)
        batched, per = (p[0], p[3], p[4], p[5]), None
    elif kernel == "newton_half_forces":
        def call(gx, bid, hn, pid):
            return K.newton_half_forces(gx, bid, hn, pid, g.interior,
                                        g.faces, C, n, maps.strides,
                                        maps.fold_shifts, True)
        batched, per = (p[0], p[3], p[4], p[5]), None
    elif kernel == "kick_drift_halo":
        def call(gx, gv, gf, bid):
            return K.kick_drift_halo(gx, gv, gf, bid, g.interior,
                                     g.halo_cols, g.halo_src, g.halo_shift,
                                     n, 0.003, 0.006, g.images)
        batched, per = (p[0], p[1], p[2], p[3]), None
    elif kernel == "extruder_springs":
        S = SpringConsts(system, 2)

        def call(gx, gf, exl, exr, act):
            gf = gf.clone()
            return gf, K.extruder_springs(gx, gf, exl, exr, act, S)
        batched, per = (p[0], p[2], p[7], p[8], active), None
    else:
        zg = kernel == "langevin_zero_group"
        lgm = (p[3] < 0.9 * n).to(torch.float32) if zg else None
        keys = [(7 + r, 9 * r + 1) for r in range(R3)]

        def call(gx, gxr, gv, gf, bid, lgm, key):
            return K.langevin_kick_monitor(
                gx, gxr, gv, gf, bid, g.interior, key, 33, -0.1, 0.7, 0.003,
                0.006, 0.02, 0.01, n, True, lgm, zg)
        batched = (p[0], p[0] + 0.01, p[1], p[2], p[3], lgm)
        words = np.array(keys, np.uint32).view(np.int32)
        per = (torch.as_tensor(words, device=dev), keys)
    name = "langevin_kick_monitor" if "langevin" in kernel else kernel
    K.reset_launches()
    out = call(*batched, *(per[:1] if per else ()))
    assert K.LAUNCHES[name] == 1
    for r in range(R3):
        one = call(*(None if t is None else t[r] for t in batched),
                   *((per[1][r],) if per else ()))
        for a, b in zip(out, one):
            assert torch.equal(a[r], b)
    assert not torch.equal(out[0][0], out[0][1])
    if kernel == "kick_drift_halo":
        # and the plain version of R replicas, bit for bit
        plain = R.kick_drift_halo(*batched, g.interior, g.halo_cols,
                                  g.halo_src, g.halo_shift, n, 0.003, 0.006)
        assert all(torch.equal(a, b) for a, b in zip(out, plain))


@pytest.mark.cuda
def test_replica_zero_is_the_same_at_every_r(dev):
    """run_fast_replicas for 20 steps with every LE fix at R = 1 and R = 3
    from the same state: replica 0 bit for bit the same (its key does not
    depend on R); the kernels launched once a step for all replicas."""
    from lammps_le_torch.fast import replica, run_fast_replicas

    sim, st = _warm_run(dev, chip_smoke.le_fixes(5, 7, 0.3), 4)
    runs = {}
    for R3 in (1, 3):
        K.reset_launches()
        runs[R3] = run_fast_replicas(sim, st, R3, 20, seed=100)
        assert K.LAUNCHES["stencil_forces"] == 20 + 1
        assert K.LAUNCHES["langevin_kick_monitor"] == 20
    _same_run(replica(runs[1], 0), replica(runs[3], 0))
    assert int(runs[3].n_moves[0]) > 0
    assert not torch.equal(runs[3].gx[0], runs[3].gx[1])
