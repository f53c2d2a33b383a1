"""Host-side physics constants of the stencil and spring kernels
(``pallas_step.StencilConsts`` + ``ops.pair._lj_tables``/_RSQ_FLOOR_FRAC).

LJ tables are computed in the run's float type with the reference's op
order (``x**6`` as jax's ``integer_pow``: ``x2 * (x2 * x2)``).  Bond
constants stay python floats, and products of them are formed in float64
first, exactly where the reference forms them from python floats before
they meet an array — each is then rounded once to the array's type, by
PyTorch for the plain versions and by the wrapper for the CUDA kernels.
"""

from __future__ import annotations

import numpy as np

from ..system import BOND_FENE, BOND_HARMONIC, System

_RSQ_FLOOR_FRAC = 0.5625  # (0.75 sigma)^2 LJ evaluation floor (ops/pair.py:35)


def _pow6(x):
    x2 = x * x
    return x2 * (x2 * x2)


def lj_tables(system: System, np_dtype):
    """(lj1, lj2, lj3, lj4, cutsq, offset, floorsq) of the uniform LJ pair
    as numpy scalars of ``np_dtype`` (ops/pair.py:38)."""
    p = system.pair
    eps = np_dtype(np.asarray(p.epsilon).flat[0])
    sig = np_dtype(np.asarray(p.sigma).flat[0])
    cut = np_dtype(np.asarray(p.cutoff).flat[0])
    sig6 = _pow6(sig)
    lj1 = 48.0 * eps * sig6 * sig6
    lj2 = 24.0 * eps * sig6
    lj3 = 4.0 * eps * sig6 * sig6
    lj4 = 4.0 * eps * sig6
    if p.shift:
        rc6 = _pow6(cut)
        offset = lj3 / (rc6 * rc6) - lj4 / rc6
    else:
        offset = np_dtype(0.0)
    floorsq = _RSQ_FLOOR_FRAC * sig * sig
    return lj1, lj2, lj3, lj4, cut * cut, offset, floorsq


class StencilConsts:
    """Pair + backbone-bond constants of the 27-offset stencil
    (engine.make_kernel, engine.py:631-669)."""

    def __init__(self, system: System, np_dtype=np.float32):
        (self.lj1, self.lj2, self.lj3, self.lj4, self.cutsq, self.offe,
         self.floorsq) = (float(t) for t in lj_tables(system, np_dtype))
        bts = np.asarray(system.backbone_type)
        used = bts[bts >= 0]
        if used.size:
            kf, r0f, epsf, sigf = (
                float(c) for c in np.asarray(system.bonds.coeffs)[used[0]])
        else:
            kf = r0f = epsf = sigf = 0.0
        self.kf = kf
        r0sq = r0f * r0f
        self.inv_r0sq = 1.0 / r0sq if r0sq else 0.0
        # the tiled stencil divides by r0^2 (pallas_kernel.py:78)
        self.r0sq = r0sq if r0sq else 1.0
        self.neg_kf = -kf
        self.sigf_sq = sigf * sigf
        self.wca_cutsq = 2.0 ** (1.0 / 3.0) * sigf * sigf
        self.wca_floorsq = 0.5625 * sigf * sigf
        self.f_wca = 48.0 * epsf          # 48 eps (WCA force)
        self.e_wca = 4.0 * epsf           # 4 eps (WCA energy)
        self.epsf = epsf
        self.e_fene = -0.5 * kf * r0sq    # FENE energy prefactor
        self.bond_reach_sq = (2.0 * system.neighbor.cell_size) ** 2
        pp = system.pair
        # Kremer-Grest work-share (engine.py:657): bonded WCA == the LJ
        # polynomial when the FENE (sigma, eps) equal the pair's
        self.wca_is_lj = bool(
            kf != 0.0 and pp is not None
            and sigf == float(np.asarray(pp.sigma).flat[0])
            and epsf == float(np.asarray(pp.epsilon).flat[0]))


class SpringConsts:
    """Extruder-bond constants (engine.make_extruder_pass, engine.py:851)."""

    def __init__(self, system: System, ex_btype: int):
        style = int(np.asarray(system.bonds.style)[ex_btype - 1])
        if style not in (BOND_FENE, BOND_HARMONIC):
            raise ValueError("extruder bond style is neither FENE nor "
                             "harmonic")
        k, r0, eps, sig = (
            float(c) for c in np.asarray(system.bonds.coeffs)[ex_btype - 1])
        self.harmonic = style == BOND_HARMONIC
        self.k = k
        self.r0 = r0
        self.neg_2k = -2.0 * k
        self.r0sq = r0 * r0
        self.neg_k = -k
        self.sig_sq = sig * sig
        self.wca_floorsq = 0.5625 * sig * sig
        self.wca_cutsq = 2.0 ** (1.0 / 3.0) * sig * sig
        self.f_wca = 48.0 * eps
        self.e_wca = 4.0 * eps
        self.eps = eps
        self.e_fene = -0.5 * k * r0 * r0
        self.box = tuple(float(b) for b in system.box_size)
