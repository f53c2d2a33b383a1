"""Scalar pressure via the pair + bond virial
(``lammps_le_tpu/observe/pressure.py``).

Matches the reference convention (src/compute_pressure.cpp):
P = (sum m v^2 + W) / (3 V) in lj units, with W = sum_pairs r.F over
unique pairs plus bond terms.  Computed on demand at thermo boundaries,
as plain PyTorch on the state's device (a fresh grid, the general path's
half stencil with its virial): the step loop carries no virial cost.
"""

from __future__ import annotations

import torch

from ..ops import grid as grid_ops
from ..ops.bond import _bond_terms
from ..ops.cells import minimum_image, system_const, wrap_positions
from ..ops.pair import _lj_tables, _pair_terms
from ..state import State
from ..system import System


def _pair_virial_explicit(x, i, j, types, system, weight):
    tables = _lj_tables(system, x.dtype, x.device)
    d = minimum_image(x[j] - x[i], system.box_size)
    rsq = torch.sum(d * d, dim=-1)
    fpair, _ = _pair_terms(rsq, types[i], types[j], tables)
    return fpair * rsq * weight


def _bond_virial(x, system, ex_left, ex_right, ex_btype):
    dtype = x.dtype
    dev = x.device
    n = system.n
    nxt = system_const(system, "next_bead", lambda: system.next_bead,
                       torch.int64, dev)
    btype = system_const(system, "backbone_type",
                         lambda: system.backbone_type, torch.int64, dev)
    valid = nxt >= 0
    j = torch.where(valid, nxt, torch.arange(n, device=dev))
    d = minimum_image(x[j] - x, system.box_size)
    rsq = torch.sum(d * d, dim=-1)
    fbond, _, _ = _bond_terms(rsq, btype, system, dtype)
    w = torch.sum(torch.where(valid, fbond * rsq, 0.0))
    if ex_left is not None and ex_btype > 0:
        active = ex_left >= 0
        li = torch.where(active, ex_left, 0)
        ri = torch.where(active, ex_right, 0)
        de = minimum_image(x[ri] - x[li], system.box_size)
        rsqe = torch.sum(de * de, dim=-1)
        bt = torch.full(ex_left.shape, ex_btype - 1, dtype=torch.int64,
                        device=dev)
        fbe, _, _ = _bond_terms(rsqe, bt, system, dtype)
        w = w + torch.sum(torch.where(active, fbe * rsqe, 0.0))
    return w


def make_pressure_fn(system: System, ex_btype: int = -1):
    """state -> pressure, a 0-d tensor on the state's device (lj
    units)."""
    vol = system.box_size[0] * system.box_size[1] * system.box_size[2]

    def pressure(state: State):
        x = state.x
        types = state.type
        dtype = x.dtype
        dev = x.device
        # fresh grid so pressure is exact at the current positions
        xw, _ = wrap_positions(x, system, state.img)
        grid, _ = grid_ops.build_grid(xw, system)
        if system.pair is not None and system.neighbor.use_cells:
            _, _, w_pair = grid_ops.grid_pair_force(
                xw, types, grid, system, virial=True)
            # special-pair correction virial
            s12 = system.special_lj[0]
            if s12 != 1.0:
                nxt = system_const(system, "next_bead",
                                   lambda: system.next_bead, torch.int64,
                                   dev)
                idx = torch.arange(system.n, device=dev)
                valid = nxt >= 0
                jb = torch.where(valid, nxt, 0)
                wv = _pair_virial_explicit(xw, idx, jb, types, system,
                                           (1.0 - s12))
                w_pair = w_pair - torch.sum(torch.where(valid, wv, 0.0))
                if ex_btype > 0:
                    active = state.ex_left >= 0
                    li = torch.where(active, state.ex_left, 0)
                    ri = torch.where(active, state.ex_right, 0)
                    wv = _pair_virial_explicit(xw, li, ri, types, system,
                                               (1.0 - s12))
                    w_pair = w_pair - torch.sum(
                        torch.where(active, wv, 0.0))
        else:
            w_pair = torch.zeros((), dtype=dtype, device=dev)
        w_bond = (
            _bond_virial(xw, system, state.ex_left, state.ex_right,
                         ex_btype)
            if system.bonds is not None
            else torch.zeros((), dtype=dtype, device=dev))
        masses = system_const(system, "masses", lambda: system.masses,
                              dtype, dev)
        m = masses[state.type][:, None]
        ke2 = torch.sum(m * state.v * state.v)
        return (ke2 + w_pair + w_bond) / (3.0 * vol)

    return pressure
