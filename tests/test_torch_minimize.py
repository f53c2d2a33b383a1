"""The port's minimizers against the reference on the CPU: FIRE, CG and
SD in f64 on a jittered 16-bead system (four FENE chains in a box too
small for a cell grid, so both force passes are the brute-force pair
sum), run to their own stop tests: the same iteration count, fmax and
positions within 1e-9."""

import functools

import numpy as np
import pytest

from helpers import fene_bonds, lj_pair_params
from lammps_le_tpu.system import build_system, chain_topology


@functools.lru_cache(maxsize=None)
def _system():
    nxt, prv, mol, bt = chain_topology([4] * 4)
    x = np.zeros((16, 3))
    for c in range(4):
        x[4 * c:4 * c + 4, 0] = 0.5 + 0.97 * np.arange(4)
        x[4 * c:4 * c + 4, 1] = 0.6 + 1.1 * c
        x[4 * c:4 * c + 4, 2] = 2.2
    x += np.random.default_rng(0).normal(scale=0.15, size=x.shape)
    system = build_system(
        n=16, n_types=1, box_lo=(0, 0, 0), box_hi=(4.4, 4.4, 4.4),
        next_bead=nxt, prev_bead=prv, molecule=mol, backbone_type=bt,
        masses=np.ones(1), pair=lj_pair_params(1), bonds=fene_bonds(1),
        dtype="float64")
    assert not system.neighbor.use_cells
    return system, x


def _min_pair(style):
    """The reference's and the port's minimizer from the same start."""
    import lammps_le_torch.fixes as tf
    import lammps_le_tpu.fixes as jf
    from lammps_le_torch.integrate import Simulation
    from lammps_le_torch.integrate.fire import minimize
    from lammps_le_torch.integrate.min_cg import minimize_cg
    from lammps_le_torch.state import init_state
    from lammps_le_tpu.integrate import Simulation as RefSimulation
    from lammps_le_tpu.integrate.fire import minimize as ref_minimize
    from lammps_le_tpu.integrate.min_cg import minimize_cg as ref_cg
    from lammps_le_tpu.state import init_state as ref_init

    system, x = _system()
    rsim = RefSimulation(system=system, dt=0.002, fixes=(jf.NVE(),))
    tsim = Simulation(system=system, dt=0.002, fixes=(tf.NVE(),))
    rst = ref_init(system, x, v=np.full_like(x, 0.1))
    tst = init_state(system, x, v=np.full_like(x, 0.1), device="cpu")
    if style == "fire":
        kw = dict(ftol=1e-3, maxiter=2000)
        return ref_minimize(rsim, rst, **kw), minimize(tsim, tst, **kw)
    kw = dict(etol=1e-5, ftol=1e-3, maxiter=2000, sd=style == "sd")
    return ref_cg(rsim, rst, **kw), minimize_cg(tsim, tst, **kw)


@pytest.mark.parametrize("style,iters", [("fire", 192), ("cg", 17),
                                         ("sd", 23)])
def test_minimizers_match_reference(style, iters):
    """FIRE to max|F| < ftol, CG and SD to the energy tolerance: the
    iteration count equal, fmax and positions within 1e-9, images, flags
    and the step counter equal.  Velocities are zeroed on exit as the
    reference does; for ``min_cg`` that is a known fault of the reference
    (ROADMAP Queue 3 item 3: LAMMPS's CG leaves the velocities as they
    were), ported as it is."""
    (rs, rit, rfmax), (ts, tit, tfmax) = _min_pair(style)
    assert tit == rit == iters
    assert abs(tfmax - rfmax) <= 1e-9 * max(1.0, rfmax)
    assert float(np.abs(np.asarray(rs.x) - ts.x.numpy()).max()) <= 1e-9
    for k in ("img", "flags", "step"):
        np.testing.assert_array_equal(np.asarray(getattr(rs, k)),
                                      getattr(ts, k).numpy(), err_msg=k)
    assert int(ts.step) == tit
    assert float(ts.epair + ts.ebond) < float(rs.epair + rs.ebond) + 1e-9
    # the known reference fault: the start's velocities are gone
    assert not ts.v.any() and not np.asarray(rs.v).any()
