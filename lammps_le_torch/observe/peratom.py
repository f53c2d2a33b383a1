"""Per-atom diagnostics: pe/atom, stress/atom, coord/atom
(``lammps_le_tpu/observe/peratom.py``).

The reference computes these as per-atom tallies inside the force loop
(src/compute_pe_atom.cpp, compute_stress_atom.cpp, compute_coord_atom.cpp
— each pair's energy/virial split half to each partner,
pair_lj_cut.cpp:110-117 ev_tally).  Here they are on-demand passes over
the halo cell grid (ops/grid.py layout), plain PyTorch on the state's
device: the step loop carries no per-atom tally cost.  The pass re-walks
the 13+self Newton offsets accumulating HALF of each pair quantity on the
i side and folding the other half back onto the j cell with the static
shift the force pass uses for its reaction.  Halo slots alias interior
beads; ``grid.fold_to_beads`` folds them onto their owners in a fixed
order.  No float atomics: the chain partners' halves are shifted adds and
each extruder anchor is one write of its row (one anchor a bead, as in
``ops.forces.special_pair_correction``), so every sum has one order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import grid as grid_ops
from ..ops.bond import _bond_terms
from ..ops.cells import minimum_image, system_const, wrap_positions
from ..ops.grid import (_HALF_OFFSETS, _grid_const, _shift,
                        cached_halo_maps, slot_coords)
from ..ops.pair import NP_DTYPE, _lj_tables, _pair_terms, lj_tables_host
from ..state import State
from ..system import System

_FAR = -1.0e4  # empty slots' coordinate: out of every cutoff


def _one_type(system: System) -> bool:
    pp = system.pair
    return pp.epsilon.shape[0] == 1 or all(
        bool(np.all(np.asarray(a) == np.asarray(a).flat[0]))
        for a in (pp.epsilon, pp.sigma, pp.cutoff))


def _sym_pair_pass(x, types, grid, system: System, want_virial: bool):
    """Symmetric per-slot accumulation of pair energy (+ virial tensor)
    (peratom.py:36).

    Returns (e_half (cap,P), v6 (6,cap,P)|None): each in-cutoff pair
    contributes e/2 and (d_a d_b fpair)/2 to BOTH partners — the per-atom
    convention of the reference's ev_tally (pair.cpp:1000-1060).
    """
    dtype = x.dtype
    dev = x.device
    one_type = _one_type(system)
    if one_type:
        tables = [float(t[0, 0])
                  for t in lj_tables_host(system, NP_DTYPE[dtype])]
    else:
        tables = _lj_tables(system, dtype, dev)
        nt = tables[0].shape[0]
    strides = cached_halo_maps(system)[3]
    int_m = _grid_const(system, "interior", dtype, dev)[None, None, :]

    gx, gy, gz = slot_coords(x, grid, system, _FAR)
    if not one_type:
        gt = torch.cat([types, types.new_zeros(1)])[grid.slot_bead]
        gti = gt[:, None, :]
    gxi, gyi, gzi = gx[:, None, :], gy[:, None, :], gz[:, None, :]

    def block(gxj, gyj, gzj, gtj):
        dx = gxi - gxj
        dy = gyi - gyj
        dz = gzi - gzj
        rsq = dx * dx + dy * dy + dz * dz
        if one_type:
            l1, l2, l3, l4, csq, eoff, fsq = tables
        else:
            pidx = gti * nt + gtj
            l1, l2, l3, l4, csq, eoff, fsq = (t.reshape(-1)[pidx]
                                              for t in tables)
        mask = (rsq < csq) & (rsq > 0.0)
        w = torch.where(mask, int_m, 0.0)
        rsq_s = torch.where(mask, rsq, 1.0)
        rsq_s = (torch.clamp(rsq_s, min=fsq) if one_type
                 else torch.maximum(rsq_s, fsq))
        r2inv = 1.0 / rsq_s
        r6inv = r2inv * r2inv * r2inv
        e = (r6inv * (l3 * r6inv - l4) - eoff) * w
        v6 = None
        if want_virial:
            fpair = r6inv * (l1 * r6inv - l2) * r2inv * w
            v6 = torch.stack([dx * dx, dy * dy, dz * dz,
                              dx * dy, dx * dz, dy * dz]) * fpair
        return e, v6

    e, v6 = block(gx[None], gy[None], gz[None],
                  None if one_type else gt[None])
    # self cell: each unordered pair is visited from both rows — the 0.5
    # sum over j IS the symmetric half-share for both partners
    e_acc = 0.5 * torch.sum(e, dim=1)
    v_acc = 0.5 * torch.sum(v6, dim=2) if want_virial else None

    for (ox, oy, oz) in _HALF_OFFSETS:
        delta = ox * strides[0] + oy * strides[1] + oz * strides[2]
        gtj = None if one_type else _shift(gt, delta, 0)[None]
        e, v6 = block(_shift(gx, delta, _FAR)[None],
                      _shift(gy, delta, _FAR)[None],
                      _shift(gz, delta, _FAR)[None], gtj)
        # i side gets its half; j's half shifts back to the j cell (the
        # same -delta fold the force pass's Newton reaction uses)
        e_acc = e_acc + 0.5 * torch.sum(e, dim=1)
        e_acc = e_acc + 0.5 * _shift(torch.sum(e, dim=0), -delta, 0.0)
        if want_virial:
            vi = 0.5 * torch.sum(v6, dim=2)
            vj = _shift(0.5 * torch.sum(v6, dim=1), -delta, 0.0)
            v_acc = v_acc + vi + vj
    return e_acc, v_acc


def _chain(system: System, dev):
    return system_const(system, "next_bead", lambda: system.next_bead,
                        torch.int64, dev)


def _add_at(acc, idx, vals):
    """``acc`` (N+1, ...) with ``vals`` added at rows ``idx`` (dropped
    entries at row N): one write a row, so each live index appears once
    (extruder anchors: one a bead)."""
    acc[idx] = acc[idx] + vals
    return acc


def _special_epair_halves(x, types, system: System, ex_left, ex_right):
    """Per-atom energy correction removing (1-w)/2 of each special pair's
    LJ from both endpoints (peratom.py:126; the per-atom twin of
    ops.forces.special_pair_correction).  Chain partners are ``hops``
    beads apart (the chain's contiguous ids), so j's half is a shifted
    add."""
    dtype = x.dtype
    dev = x.device
    n = system.n
    de = x.new_zeros((n,))
    s12, s13, s14 = system.special_lj
    nxt = _chain(system, dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    tables = _lj_tables(system, dtype, dev)

    def pair_e(i, j, w):
        d = minimum_image(x[j] - x[i], system.box_size)
        rsq = torch.sum(d * d, dim=-1)
        _, e = _pair_terms(rsq, types[i], types[j], tables)
        return e * (1.0 - w)

    def chain_tier(de, hops, w):
        j = idx
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        for _ in range(hops):
            valid = valid & (j < n)
            nj = nxt[torch.where(valid, j, 0)]
            valid = valid & (nj >= 0)
            j = torch.where(valid, nj, 0)
        ep = torch.where(valid, pair_e(idx, j, w), 0.0)
        de = de - 0.5 * ep
        de[hops:] = de[hops:] - 0.5 * ep[:-hops]
        return de

    if s12 != 1.0:
        de = chain_tier(de, 1, s12)
    if s13 != 1.0:
        de = chain_tier(de, 2, s13)
    if s14 != 1.0:
        de = chain_tier(de, 3, s14)

    if ex_left is not None and s12 != 1.0:
        active = ex_left >= 0
        li = torch.where(active, ex_left, 0)
        ri = torch.where(active, ex_right, 0)
        ep = torch.where(active, pair_e(li, ri, s12), 0.0)
        acc = x.new_zeros((n + 1,))
        acc = _add_at(acc, torch.where(active, ex_left, n), 0.5 * ep)
        acc = _add_at(acc, torch.where(active, ex_right, n), 0.5 * ep)
        de = de - acc[:n]
    return de


def _bond_epair_halves(x, system: System, ex_left, ex_right, ex_btype):
    """Per-atom bond energy: half of each bond term to each endpoint
    (peratom.py:180; ev_tally convention, bond_fene.cpp:120-134)."""
    dtype = x.dtype
    dev = x.device
    n = system.n
    nxt = _chain(system, dev)
    btype = system_const(system, "backbone_type",
                         lambda: system.backbone_type, torch.int64, dev)
    valid = nxt >= 0
    j = torch.where(valid, nxt, torch.arange(n, device=dev))
    d = minimum_image(x[j] - x, system.box_size)
    rsq = torch.sum(d * d, dim=-1)
    _, eb, _ = _bond_terms(rsq, btype, system, dtype)
    eb = torch.where(valid, eb, 0.0)
    acc = x.new_zeros((n + 1,))
    acc[:n] = 0.5 * eb
    acc[1:n] = acc[1:n] + 0.5 * eb[:-1]
    if ex_left is not None and ex_btype > 0:
        active = ex_left >= 0
        li = torch.where(active, ex_left, 0)
        ri = torch.where(active, ex_right, 0)
        de = minimum_image(x[ri] - x[li], system.box_size)
        rsqe = torch.sum(de * de, dim=-1)
        bt = torch.full(ex_left.shape, ex_btype - 1, dtype=torch.int64,
                        device=dev)
        _, ebe, _ = _bond_terms(rsqe, bt, system, dtype)
        ebe = torch.where(active, ebe, 0.0)
        acc = _add_at(acc, torch.where(active, ex_left, n), 0.5 * ebe)
        acc = _add_at(acc, torch.where(active, ex_right, n), 0.5 * ebe)
    return acc[:n]


def make_peratom_pe_fn(system: System, ex_btype: int = -1,
                       pair: bool = True, bond: bool = True):
    """state -> (n,) per-atom potential energy on the state's device
    (peratom.py:212).  Sum over atoms equals the thermo epair+ebond totals;
    reference: src/compute_pe_atom.cpp."""

    def pe_atom(state: State):
        x = state.x
        xw, _ = wrap_positions(x, system, state.img)
        out = x.new_zeros((system.n,))
        if pair and system.pair is not None:
            grid, _ = grid_ops.build_grid(xw, system)
            e_half, _ = _sym_pair_pass(xw, state.type, grid, system, False)
            out = out + grid_ops.fold_to_beads(e_half, grid, system)
            out = out + _special_epair_halves(
                xw, state.type, system, state.ex_left, state.ex_right)
        if bond and system.bonds is not None:
            out = out + _bond_epair_halves(
                xw, system, state.ex_left, state.ex_right, ex_btype)
        return out

    return pe_atom


def _outer6(d):
    """(M, 6) xx yy zz xy xz yz products of displacements ``d``."""
    return torch.stack([d[:, 0] * d[:, 0], d[:, 1] * d[:, 1],
                        d[:, 2] * d[:, 2], d[:, 0] * d[:, 1],
                        d[:, 0] * d[:, 2], d[:, 1] * d[:, 2]], dim=-1)


def make_stress_atom_fn(system: System, ex_btype: int = -1,
                        ke: bool = True):
    """state -> (n, 6) per-atom stress*volume, LAMMPS ordering (xx yy zz
    xy xz yz) and sign (peratom.py:237; compute_stress_atom.cpp: NEGATIVE
    of the kinetic + virial tally, so sum(-(sxx+syy+szz))/(3V) =
    pressure)."""

    def _pair_v6(x, i, j, types, weight):
        tables = _lj_tables(system, x.dtype, x.device)
        d = minimum_image(x[j] - x[i], system.box_size)
        rsq = torch.sum(d * d, dim=-1)
        fpair, _ = _pair_terms(rsq, types[i], types[j], tables)
        return _outer6(d) * (fpair * weight)[:, None]

    def stress_atom(state: State):
        x = state.x
        dtype = x.dtype
        dev = x.device
        n = system.n
        xw, _ = wrap_positions(x, system, state.img)
        v6 = x.new_zeros((n + 1, 6))
        if system.pair is not None:
            grid, _ = grid_ops.build_grid(xw, system)
            _, v_slots = _sym_pair_pass(xw, state.type, grid, system, True)
            v6[:n] = v6[:n] + grid_ops.fold_to_beads(v_slots, grid,
                                                     system).T
            # special-pair removal, half to each endpoint
            s12 = system.special_lj[0]
            if s12 != 1.0:
                nxt = _chain(system, dev)
                idx = torch.arange(n, dtype=torch.int64, device=dev)
                valid = nxt >= 0
                jb = torch.where(valid, nxt, 0)
                dv = _pair_v6(xw, idx, jb, state.type, (1.0 - s12))
                dv = torch.where(valid[:, None], dv, 0.0)
                v6[:n] = v6[:n] - 0.5 * dv
                v6[1:n] = v6[1:n] + -0.5 * dv[:-1]
                if ex_btype > 0:
                    active = state.ex_left >= 0
                    li = torch.where(active, state.ex_left, 0)
                    ri = torch.where(active, state.ex_right, 0)
                    dv = _pair_v6(xw, li, ri, state.type, (1.0 - s12))
                    dv = torch.where(active[:, None], dv, 0.0)
                    v6 = _add_at(v6, torch.where(active, state.ex_left, n),
                                 -0.5 * dv)
                    v6 = _add_at(v6, torch.where(active, state.ex_right, n),
                                 -0.5 * dv)
        if system.bonds is not None:
            nxt = _chain(system, dev)
            btype = system_const(system, "backbone_type",
                                 lambda: system.backbone_type, torch.int64,
                                 dev)
            valid = nxt >= 0
            jb = torch.where(valid, nxt, torch.arange(n, device=dev))
            d = minimum_image(xw[jb] - xw, system.box_size)
            rsq = torch.sum(d * d, dim=-1)
            fb, _, _ = _bond_terms(rsq, btype, system, dtype)
            dv = _outer6(d) * torch.where(valid, fb, 0.0)[:, None]
            v6[:n] = v6[:n] + 0.5 * dv
            v6[1:n] = v6[1:n] + 0.5 * dv[:-1]
            if ex_btype > 0:
                active = state.ex_left >= 0
                li = torch.where(active, state.ex_left, 0)
                ri = torch.where(active, state.ex_right, 0)
                de = minimum_image(xw[ri] - xw[li], system.box_size)
                rsqe = torch.sum(de * de, dim=-1)
                bt = torch.full(state.ex_left.shape, ex_btype - 1,
                                dtype=torch.int64, device=dev)
                fbe, _, _ = _bond_terms(rsqe, bt, system, dtype)
                dv = _outer6(de) * torch.where(active, fbe, 0.0)[:, None]
                v6 = _add_at(v6, torch.where(active, state.ex_left, n),
                             0.5 * dv)
                v6 = _add_at(v6, torch.where(active, state.ex_right, n),
                             0.5 * dv)
        v6 = v6[:n]
        if ke:
            masses = system_const(system, "masses", lambda: system.masses,
                                  dtype, dev)
            m = masses[state.type]
            v6 = v6 + _outer6(state.v) * m[:, None]
        return -v6

    return stress_atom


def make_coord_atom_fn(system: System, cutoff: float):
    """state -> (n,) neighbour counts within ``cutoff``, in the state's
    float type as the reference's (peratom.py:336;
    src/compute_coord_atom.cpp, cstyle=cutoff).  The cutoff must fit
    inside the cell-stencil reach (cell_size), else neighbours would be
    silently missed.  Counts are sums of ones: exact in any order."""
    nb = system.neighbor
    if cutoff > nb.cell_size + 1e-9:
        raise ValueError(
            f"coord/atom cutoff {cutoff} exceeds the cell stencil reach "
            f"{nb.cell_size:.4f}; rebuild with a larger skin")
    csq = float(cutoff) ** 2

    def coord_atom(state: State):
        x = state.x
        dtype = x.dtype
        dev = x.device
        xw, _ = wrap_positions(x, system, state.img)
        grid, _ = grid_ops.build_grid(xw, system)
        strides = cached_halo_maps(system)[3]
        int_m = _grid_const(system, "interior", dtype, dev)[None, None, :]
        gx, gy, gz = slot_coords(xw, grid, system, _FAR)
        gxi, gyi, gzi = gx[:, None, :], gy[:, None, :], gz[:, None, :]

        def counts(gxj, gyj, gzj):
            dx = gxi - gxj
            dy = gyi - gyj
            dz = gzi - gzj
            rsq = dx * dx + dy * dy + dz * dz
            mask = (rsq < csq) & (rsq > 0.0)
            return torch.where(mask, int_m, 0.0)

        w = counts(gx[None], gy[None], gz[None])
        c_acc = torch.sum(w, dim=1)  # in-cell: every neighbour seen once
        for (ox, oy, oz) in _HALF_OFFSETS:
            delta = ox * strides[0] + oy * strides[1] + oz * strides[2]
            w = counts(_shift(gx, delta, _FAR)[None],
                       _shift(gy, delta, _FAR)[None],
                       _shift(gz, delta, _FAR)[None])
            c_acc = c_acc + torch.sum(w, dim=1)
            c_acc = c_acc + _shift(torch.sum(w, dim=0), -delta, 0.0)
        return grid_ops.fold_to_beads(c_acc, grid, system)

    return coord_atom
