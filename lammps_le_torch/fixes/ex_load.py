"""Extruder loading (``lammps_le_tpu/fixes/ex_load.py``, the port of
``FixExLoad::post_integrate``, fix_ex_load.cpp:329-655).

Candidates are bead pairs (i, i+2) around a mid bead, all three with
exactly two bonds, of matching types, closer than ``cutoff``; overlapping
candidates are resolved by closest-pair election, winners kept with
probability ``fraction`` and packed into free table slots in mid-bead
order.  A full table sets FLAG_EXTRUDER_OVERFLOW.
"""

from __future__ import annotations

import torch

from .. import rng
from ..state import FLAG_EXTRUDER_OVERFLOW
from ..system import System
from .config import ExLoad
from .extrusion import _rsq, scatter_election


def make_ex_load_update(system: System, fix: ExLoad, device):
    """update(x, types, ex_left, ex_right, occ, key)
    -> (left, right, types, n_created, flag_bits)."""
    n = system.n
    nxt = torch.as_tensor(system.next_bead, dtype=torch.int64, device=device)
    prv = torch.as_tensor(system.prev_bead, dtype=torch.int64, device=device)
    itype = fix.iatomtype - 1
    jtype = fix.jatomtype - 1
    cutsq = fix.cutoff * fix.cutoff
    box = system.box_size

    def update(x, types, ex_left, ex_right, occ, key):
        e = ex_left.shape[0]
        mids = torch.arange(n, dtype=torch.int64, device=device)
        i = prv
        j = nxt
        valid = (i >= 0) & (j >= 0)
        i_s = torch.where(valid, i, 0)
        j_s = torch.where(valid, j, 0)

        def degree(b):
            return ((prv[b] >= 0).long() + (nxt[b] >= 0).long()
                    + occ[b].long())

        ok = valid & (degree(i_s) == 2) & (degree(mids) == 2) \
            & (degree(j_s) == 2)
        ti = types[i_s]
        tj = types[j_s]
        occ_i = occ[i_s].long()
        occ_j = occ[j_s].long()
        lim_ij = ((fix.imaxbond == 0) | (occ_i < fix.imaxbond)) & (
            (fix.jmaxbond == 0) | (occ_j < fix.jmaxbond))
        lim_ji = ((fix.jmaxbond == 0) | (occ_i < fix.jmaxbond)) & (
            (fix.imaxbond == 0) | (occ_j < fix.imaxbond))
        ok = ok & ((((ti == itype) & (tj == jtype)) & lim_ij)
                   | (((ti == jtype) & (tj == itype)) & lim_ji))

        rsq = _rsq(x, i_s, j_s, box).to(torch.float32)
        ok = ok & (rsq < cutsq)

        best_slot = scatter_election([(i_s, ok), (mids, ok), (j_s, ok)],
                                     rsq, n)
        win = (ok
               & (best_slot[torch.where(ok, i_s, n)] == mids)
               & (best_slot[torch.where(ok, mids, n)] == mids)
               & (best_slot[torch.where(ok, j_s, n)] == mids))
        if fix.fraction < 1.0:
            win = win & (rng.uniform(key, n, device) < fix.fraction)

        # winners into free slots, in mid-bead order; index e is the
        # dropped entry of every scatter below
        inactive = ex_left < 0
        nfree = inactive.sum()
        frank = torch.cumsum(inactive.long(), 0) - 1
        free_list = torch.full((e + 1,), e, dtype=torch.int64, device=device)
        free_list[torch.where(inactive, frank, e)] = torch.arange(
            e, dtype=torch.int64, device=device)
        wrank = torch.cumsum(win.long(), 0) - 1
        fits = win & (wrank < nfree)
        slot = free_list[torch.clamp(torch.where(fits, wrank, 0), 0, e - 1)]
        slot = torch.where(fits, slot, e)

        def put(table, vals):
            out = torch.cat([table, table.new_full((1,), -1)])
            out[slot] = torch.where(fits, vals, -1)
            return out[:e]

        new_left = put(ex_left, i_s)
        new_right = put(ex_right, j_s)

        new_types = types

        def convert(new_types, which, newtype):
            out = torch.cat([new_types, new_types.new_zeros(1)])
            for b in (i_s, j_s):
                conv = fits & (types[b] == which)
                out[torch.where(conv, b, n)] = newtype - 1
            return out[:n]

        if fix.imaxbond == 1 and fix.inewtype > 0:
            new_types = convert(new_types, itype, fix.inewtype)
        if fix.jmaxbond == 1 and fix.jnewtype > 0 and jtype != itype:
            new_types = convert(new_types, jtype, fix.jnewtype)

        flags = (win.sum() > nfree).long() * FLAG_EXTRUDER_OVERFLOW
        return new_left, new_right, new_types, fits.sum(), flags

    return update
