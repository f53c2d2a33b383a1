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


def _planes(dev, cap=9):
    """Thermal-ish positions (one FENE clamp, one bond out of reach) on
    the grid, on the card."""
    system, data = _system(cap=cap)
    r = np.random.default_rng(0)
    x = data.x + r.normal(scale=0.05, size=data.x.shape)
    x[100, 0] += 1.45
    x[300, 1] += 4.5
    e = system.max_extruders
    left = np.full(e, -1, np.int64)
    right = np.full(e, -1, np.int64)
    left[:20] = np.arange(20) * 97 + 3
    right[:20] = left[:20] + 2
    maps = fast_maps(system)
    g = GridConsts.build(system, maps, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    planes = place(system, maps, g, torch.tensor(x, **f32),
                   torch.tensor(r.normal(size=x.shape), **f32),
                   torch.tensor(r.normal(size=x.shape), **f32),
                   torch.tensor(left, device=dev),
                   torch.tensor(right, device=dev),
                   torch.zeros(x.shape, dtype=torch.int64, device=dev))
    active = torch.tensor(left >= 0, device=dev)
    return system, maps, g, planes, active


def _close(a, b):
    return float((a - b).abs().max()) <= 3e-5 * max(float(b.abs().max()),
                                                     1.0)


@pytest.mark.cuda
def test_kick_drift_halo_bitwise(dev):
    system, _, g, p, _ = _planes(dev)
    args = (p[0], p[1], p[2], p[3], g.interior, g.halo_cols, g.halo_src,
            g.halo_shift, system.n, 0.003, 0.006)
    K.reset_launches()
    for a, b in zip(K.kick_drift_halo(*args), R.kick_drift_halo(*args)):
        assert torch.equal(a, b)
    assert K.LAUNCHES["kick_drift_halo"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("energy", [True, False])
def test_stencil_forces(dev, energy):
    system, maps, g, p, _ = _planes(dev)
    args = (p[0], p[3], p[4], p[5], g.interior, StencilConsts(system),
            system.n, maps.strides, energy)
    fk, ek, ik = K.stencil_forces(*args)
    fr, er, ir = R.stencil_forces(*args)
    assert _close(fk, fr)
    assert float((ek - er).abs().max()) <= 2e-2
    assert torch.equal(ik, ir) and int(ik[0]) == 64 | 8


@pytest.mark.cuda
@pytest.mark.parametrize("cap,energy", [(9, True), (9, False), (8, True),
                                        (16, True)])
def test_newton_half_forces(dev, cap, energy):
    """Against the plain version, ghost columns exactly zero, and two
    launches on the same inputs bitwise equal (no atomics)."""
    system, maps, g, p, _ = _planes(dev, cap)
    args = (p[0], p[3], p[4], p[5], g.interior, g.faces,
            StencilConsts(system), system.n, maps.strides, maps.fold_shifts,
            energy)
    K.reset_launches()
    a = K.newton_half_forces(*args)
    b = K.newton_half_forces(*args)
    r = R.newton_half_forces(*args)
    assert K.LAUNCHES["newton_half_forces"] == 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _close(a[0], r[0])
    assert float((a[1] - r[1]).abs().max()) <= 2e-2
    assert torch.equal(a[2], r[2]) and int(a[2][0]) == 64 | 8
    assert float(a[0][:, :, ~g.interior].abs().max()) == 0.0


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
@pytest.mark.parametrize("sp,energy", [(2, True), (4, False), (1, True)])
def test_window_forces(dev, sp, energy):
    """The sharded stencil's window kernel against its plain version on
    sp windows (one launch for all), two launches bitwise equal; the
    assembled, folded forces against stencil_forces, ghost columns 0."""
    from lammps_le_torch.parallel.shard_step import make_sharded_kernel

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


@pytest.mark.cuda
@pytest.mark.parametrize("cap,energy", [(9, True), (9, False), (16, True)])
def test_tiled_stencil_forces(dev, cap, energy):
    system, maps, g, p, _ = _planes(dev, cap)
    args = (p[0], p[3], p[4], p[5], g.interior, StencilConsts(system),
            system.n, maps.strides, energy)
    K.reset_launches()
    fk, ek, ik = K.tiled_stencil_forces(*args)
    fr, er, ir = R.tiled_stencil_forces(*args)
    assert K.LAUNCHES["tiled_stencil_forces"] == 1
    assert _close(fk, fr)
    assert float((ek - er).abs().max()) <= 2e-2
    assert torch.equal(ik, ir) and int(ik[0]) == 64 | 8


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


@pytest.mark.cuda
def test_zero_group_phase(dev):
    """chip_smoke's path-5 kernel checks on small planes: the group's
    random force sums to zero, slots outside it as with zero off."""
    from lammps_le_torch.fixes import Langevin
    from lammps_le_torch.integrate import Simulation

    system, maps, g, p, _ = _planes(dev)
    fs = SimpleNamespace(gx=p[0], gx_ref=p[0] + 0.01, gv=p[1], gf=p[2],
                         bid=p[3], lgm=_group_plane(system, maps, p, 0.9),
                         step=33)
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
