"""Bond forces: FENE and harmonic, over the backbone chain and the
extruder table (``lammps_le_tpu.ops.bond``).

FENE (bond_fene.cpp:52-128) with its WCA term below 2^(1/6) sigma and the
rlogarg clamp (bond_fene.cpp:87-92: the reference aborts, here a sticky
flag); harmonic (bond_harmonic.cpp:48-80).  The backbone is implicit in
chain order, so its reactions are one shifted add; the extruder table's
are two collision-free writes (one extruder anchor a bead, the invariant
``state.extruder_partner`` rests on).
"""

from __future__ import annotations

import torch

from ..state import FLAG_FENE_CLAMP
from ..system import BOND_FENE, BOND_HARMONIC, System
from .cells import minimum_image, system_const
from .pair import chain_tables

_TWO_1_3 = 2.0 ** (1.0 / 3.0)


def _bond_terms(rsq, btype, system: System, dtype):
    """(fbond, energy, clamp) for bonds of squared length ``rsq`` (bond.py
    :30); fbond is force/r along x_i - x_j, ``clamp`` a bool tensor."""
    dev = rsq.device
    coeffs = system_const(system, "bond_coeffs", lambda: system.bonds.coeffs,
                          dtype, dev)
    styles = system_const(system, "bond_style", lambda: system.bonds.style,
                          torch.int64, dev)
    bt = torch.clamp(btype, 0, coeffs.shape[0] - 1)
    k = coeffs[bt, 0]
    r0 = coeffs[bt, 1]
    eps = coeffs[bt, 2]
    sig = coeffs[bt, 3]
    style = styles[bt]

    rsq = torch.clamp(rsq, min=1e-12)

    # FENE
    r0sq = r0 * r0
    rlogarg = 1.0 - rsq / r0sq
    clamped = rlogarg < 0.1
    rlogarg = torch.where(clamped, 0.1, rlogarg)
    f_fene = -k / rlogarg
    e_fene = -0.5 * k * r0sq * torch.log(rlogarg)
    # WCA term floored at (0.75 sigma)^2 like the pair kernels
    rsq_w = torch.maximum(rsq, 0.5625 * sig * sig)
    sr2 = sig * sig / rsq_w
    sr6 = sr2 * sr2 * sr2
    wca = rsq < _TWO_1_3 * sig * sig
    f_fene = f_fene + torch.where(
        wca, 48.0 * eps * sr6 * (sr6 - 0.5) / rsq_w, 0.0)
    e_fene = e_fene + torch.where(wca, 4.0 * eps * sr6 * (sr6 - 1.0) + eps,
                                  0.0)

    # harmonic
    r = torch.sqrt(rsq)
    dr = r - r0
    rk = k * dr
    f_harm = torch.where(r > 0, -2.0 * rk / r, 0.0)
    e_harm = rk * dr

    is_fene = style == BOND_FENE
    is_harm = style == BOND_HARMONIC
    fbond = torch.where(is_fene, f_fene, torch.where(is_harm, f_harm, 0.0))
    ebond = torch.where(is_fene, e_fene, torch.where(is_harm, e_harm, 0.0))
    return fbond, ebond, torch.any(clamped & is_fene)


def _flag(cond: torch.Tensor, bit: int) -> torch.Tensor:
    return cond.to(torch.int64) * bit


def backbone_bond_force(x: torch.Tensor, system: System):
    """Forces, energy and flags of the backbone bonds (i, next[i]) by one
    shifted add (bond.py:83; next[i] is -1 or i + 1)."""
    n = system.n
    dev = x.device
    nxt, _ = chain_tables(system, dev)
    btype = system_const(system, "backbone_type",
                         lambda: system.backbone_type, torch.int64, dev)
    valid = nxt >= 0
    j = torch.where(valid, nxt, torch.arange(n, dtype=torch.int64,
                                             device=dev))
    d = minimum_image(x[j] - x, system.box_size)  # x_j - x_i
    rsq = torch.sum(d * d, dim=-1)
    fbond, ebond, clamp = _bond_terms(rsq, btype, system, x.dtype)
    vf = torch.where(valid, fbond, 0.0)
    ve = torch.where(valid, ebond, 0.0)
    # f_i += (x_i - x_j) * fbond = -d * fbond; the reaction on j = i + 1
    rf = d * vf[:, None]
    f = -rf
    f[1:] += rf[:-1]
    return f, torch.sum(ve), _flag(clamp, FLAG_FENE_CLAMP)


def extruder_bond_force(x: torch.Tensor, ex_left: torch.Tensor,
                        ex_right: torch.Tensor, ex_btype: int,
                        system: System):
    """Forces, energy and flags of the extruder bonds (bond.py:106): the
    reaction of each active slot added at its two anchors, inactive slots
    into a dropped row N."""
    n = system.n
    active = ex_left >= 0
    li = torch.where(active, ex_left, 0)
    ri = torch.where(active, ex_right, 0)
    d = minimum_image(x[ri] - x[li], system.box_size)  # x_r - x_l
    rsq = torch.sum(d * d, dim=-1)
    bt = torch.full_like(ex_left, ex_btype)
    fbond, ebond, clamp = _bond_terms(rsq, bt, system, x.dtype)
    fbond = torch.where(active, fbond, 0.0)
    ebond = torch.where(active, ebond, 0.0)
    rf = d * fbond[:, None]
    safe_l = torch.where(active, ex_left, n)
    safe_r = torch.where(active, ex_right, n)
    f = x.new_zeros((n + 1, 3))
    f[safe_l] = f[safe_l] - rf
    f[safe_r] = f[safe_r] + rf
    return (f[:n], torch.sum(ebond),
            _flag(clamp & torch.any(active), FLAG_FENE_CLAMP))
