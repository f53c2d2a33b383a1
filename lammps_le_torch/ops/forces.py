"""Total force assembly: pair + backbone bonds + extruder bonds + angles
(``lammps_le_tpu.ops.forces``), the force stage of the Verlet loop
(verlet.cpp:300-320) as one function of positions and the dynamic
topology."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..system import System
from . import bond as bond_ops
from . import pair as pair_ops
from .cells import minimum_image


class ForceResult(NamedTuple):
    f: torch.Tensor
    epair: torch.Tensor
    ebond: torch.Tensor
    flags: torch.Tensor  # () int64 sticky bits


def _pair_terms_at(x, i, j, types, system: System, weight):
    """Weighted LJ force on i, on j, and energy of the explicit pairs
    (i, j) (forces.py:30)."""
    tables = pair_ops._lj_tables(system, x.dtype, x.device)
    d = minimum_image(x[j] - x[i], system.box_size)
    rsq = torch.sum(d * d, dim=-1)
    fpair, e = pair_ops._pair_terms(rsq, types[i], types[j], tables)
    fpair = fpair * weight
    e = e * weight
    # force on i is (x_i - x_j) * fpair = -d * fpair
    return -d * fpair[:, None], d * fpair[:, None], e


def special_pair_correction(x, types, system: System, ex_left, ex_right):
    """Force and energy removing (1 - w) of each special pair's LJ, which
    the exclusion-free grid counted in full (forces.py:52): 1-2 backbone
    and extruder partners, 1-3 / 1-4 backbone tiers whose weights differ
    from 1.  The chain tiers' reactions are shifted adds; the extruder
    pairs' are added at their anchors, inactive slots into a dropped row
    N (one anchor a bead: no two writes of one row)."""
    n = system.n
    dev = x.device
    f = x.new_zeros((n, 3))
    e = x.new_zeros(())
    s12, s13, s14 = system.special_lj
    nxt, _ = pair_ops.chain_tables(system, dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)

    def chain_tier(f, e, hops, w):
        j = idx
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        for _ in range(hops):
            valid = valid & (j < n)
            nj = nxt[torch.where(valid, j, 0)]
            valid = valid & (nj >= 0)
            j = torch.where(valid, nj, 0)
        fi, fj, ep = _pair_terms_at(x, idx, j, types, system, 1.0 - w)
        fi = torch.where(valid[:, None], fi, 0.0)
        fj = torch.where(valid[:, None], fj, 0.0)
        f = f - fi  # subtract: the grid counted the pair fully
        f[hops:] += -fj[:-hops]
        return f, e - torch.sum(torch.where(valid, ep, 0.0))

    if s12 != 1.0:
        f, e = chain_tier(f, e, 1, s12)
    if s13 != 1.0:
        f, e = chain_tier(f, e, 2, s13)
    if s14 != 1.0:
        f, e = chain_tier(f, e, 3, s14)

    if ex_left is not None and s12 != 1.0:
        active = ex_left >= 0
        li = torch.where(active, ex_left, 0)
        ri = torch.where(active, ex_right, 0)
        fi, fj, ep = _pair_terms_at(x, li, ri, types, system, 1.0 - s12)
        fi = torch.where(active[:, None], fi, 0.0)
        fj = torch.where(active[:, None], fj, 0.0)
        safe_l = torch.where(active, ex_left, n)
        safe_r = torch.where(active, ex_right, n)
        f = torch.cat([f, f.new_zeros((1, 3))])
        f[safe_l] = f[safe_l] + -fi
        f[safe_r] = f[safe_r] + -fj
        f = f[:n]
        e = e - torch.sum(torch.where(active, ep, 0.0))
    return f, e


def compute_forces(x: torch.Tensor, types: torch.Tensor, nbr,
                   system: System, ex_left: Optional[torch.Tensor] = None,
                   ex_right: Optional[torch.Tensor] = None,
                   ex_btype: int = -1,
                   ex_partner: Optional[torch.Tensor] = None,
                   energy: bool = True) -> ForceResult:
    """Forces, pair and bond energies and flags (forces.py:107): pair
    forces on the grid (``nbr`` a CellGrid, with the special-pair
    correction), the verlet list (a NeighborList) or by brute force
    (no cells), then backbone and extruder bonds and chain angles (whose
    energy reports with the bonds')."""
    n = system.n
    f = x.new_zeros((n, 3))
    epair = x.new_zeros(())
    ebond = x.new_zeros(())
    flags = torch.zeros((), dtype=torch.int64, device=x.device)

    if system.pair is not None:
        if nbr is not None and system.neighbor.use_cells:
            from .grid import CellGrid, grid_pair_force

            if isinstance(nbr, CellGrid):
                fp, epair = grid_pair_force(x, types, nbr, system,
                                            energy=energy)
                fc, ec = special_pair_correction(x, types, system, ex_left,
                                                 ex_right)
                fp = fp + fc
                epair = epair + ec
            else:
                fp, epair = pair_ops.lj_force_nbr(x, types, nbr, system,
                                                  ex_partner)
        else:
            fp, epair = pair_ops.lj_force_bruteforce(x, types, system,
                                                     ex_partner)
        f = f + fp

    if system.bonds is not None:
        fb, eb, fl = bond_ops.backbone_bond_force(x, system)
        f = f + fb
        ebond = ebond + eb
        flags = flags | fl
        if ex_left is not None and ex_btype >= 0:
            fe, ee, fl2 = bond_ops.extruder_bond_force(
                x, ex_left, ex_right, ex_btype, system)
            f = f + fe
            ebond = ebond + ee
            flags = flags | fl2

    if system.angles is not None and system.angle_center_type is not None:
        from .angle import chain_angle_force

        fa, ea = chain_angle_force(x, system, energy=energy)
        f = f + fa
        ebond = ebond + ea

    return ForceResult(f=f, epair=epair, ebond=ebond, flags=flags)
