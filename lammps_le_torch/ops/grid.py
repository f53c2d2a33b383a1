"""The halo-padded cell grid and its pair force (``lammps_le_tpu.ops
.grid``).

Beads live in a dense (cap, P) slot grid whose flat cell axis P is the 3-D
cell grid surrounded by one layer of ghost (halo) cells, padded to a
multiple of 128; halo cells hold shifted copies of the periodic source
cells, so the 27-cell stencil is 27 static column offsets.
"""

from __future__ import annotations

import collections
import dataclasses
import numpy as np
import torch

from ..state import FLAG_CELL_OVERFLOW
from ..system import System
from .cells import cell_coords, overflow_flag, sorted_ranks, system_const

_OFFSETS = [
    (i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
]


def halo_maps(system: System):
    """(src_cell, interior, P, strides, shifts) for the padded grid
    (ops/grid.py ``_halo_maps``): ``src_cell[p]`` is the unpadded interior
    cell that padded cell ``p`` duplicates, ``interior`` marks non-halo
    cells, ``shifts`` (P, 3) the +-box ghost-image coordinate shifts."""
    cfg = system.neighbor
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    px, py, pz = nx + 2, ny + 2, nz + 2
    p_raw = px * py * pz
    p = -(-p_raw // 128) * 128
    ix, iy, iz = np.meshgrid(
        np.arange(px), np.arange(py), np.arange(pz), indexing="ij")
    src = ((((ix - 1) % nx) * ny + (iy - 1) % ny) * nz
           + (iz - 1) % nz).reshape(-1)
    interior = ((ix >= 1) & (ix <= nx) & (iy >= 1) & (iy <= ny)
                & (iz >= 1) & (iz <= nz)).reshape(-1)
    src_p = np.zeros(p, np.int32)
    src_p[:p_raw] = src
    int_p = np.zeros(p, bool)
    int_p[:p_raw] = interior
    box = system.box_size
    shifts = np.zeros((p, 3), np.float64)
    shifts[:p_raw] = np.stack([
        np.where(ix == 0, -box[0], np.where(ix == px - 1, box[0], 0.0)),
        np.where(iy == 0, -box[1], np.where(iy == py - 1, box[1], 0.0)),
        np.where(iz == 0, -box[2], np.where(iz == pz - 1, box[2], 0.0)),
    ], axis=-1).reshape(-1, 3)
    strides = (py * pz, pz, 1)
    return src_p, int_p, p, strides, shifts


_HALO_CACHE: dict = {}


def cached_halo_maps(system: System):
    """``halo_maps`` made once per grid and box (the reference caches it
    too, grid.py:108), with the interior columns and the halo fold table:
    for each interior column, every column that duplicates its cell
    (itself first, then its ghost images in column order), padded with P,
    the index of an appended zero column."""
    cfg = system.neighbor
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    key = (nx, ny, nz, tuple(system.box_size))
    hit = _HALO_CACHE.get(key)
    if hit is not None:
        return hit
    src, interior, p, strides, shifts = halo_maps(system)
    p_raw = (nx + 2) * (ny + 2) * (nz + 2)
    s = src[:p_raw].astype(np.int64)
    own = ((((s // (ny * nz)) + 1) * (ny + 2) + (s // nz) % ny + 1)
           * (nz + 2) + s % nz + 1)
    int_cols = np.flatnonzero(interior)
    by_owner = collections.defaultdict(list)
    for col in range(p_raw):
        by_owner[int(own[col])].append(col)
    width = max(len(v) for v in by_owner.values())
    fold = np.full((width, int_cols.size), p, np.int64)
    for c, col in enumerate(int_cols.tolist()):
        cols = sorted(by_owner[col], key=lambda q: (q != col, q))
        fold[:len(cols), c] = cols
    hit = _HALO_CACHE[key] = (src, interior, p, strides, shifts, int_cols,
                              fold)
    return hit


@dataclasses.dataclass
class CellGrid:
    """Rebuild-time bead -> slot assignment (grid.py:49): (cap, P) with
    the flat halo-padded cell axis minor.  ``slot_bead`` holds bead ids
    (N = empty); ``scatter_bead`` the same with halo slots masked to N."""

    slot_bead: torch.Tensor     # (cap, P) int64
    scatter_bead: torch.Tensor  # (cap, P) int64, halo -> N
    x_ref: torch.Tensor         # (N, 3) positions at rebuild (skin check)

    def replace(self, **kw) -> "CellGrid":
        return dataclasses.replace(self, **kw)


def _grid_const(system, name, dtype, device):
    i = {"src": 0, "interior": 1, "shifts": 4, "int_cols": 5,
         "fold": 6}[name]
    return system_const(system, "grid_" + name,
                        lambda: cached_halo_maps(system)[i], dtype, device)


def build_grid(x: torch.Tensor, system: System):
    """Pack beads into the halo-padded slot grid (grid.py:127): a stable
    sort by cell, each bead's rank in its cell, one write of the flat
    (ncells * cap) table, the halo duplication.  A bead past its cell's
    cap lands, as in the reference's flat scatter, on a slot of the next
    cell unless a later bead of the sorted order writes that slot (the
    last writer of each slot is found by an integer max, order-free);
    FLAG_CELL_OVERFLOW is set."""
    cfg = system.neighbor
    n = system.n
    nx, ny, nz, cap = cfg.nx, cfg.ny, cfg.nz, cfg.cell_cap
    ncells = nx * ny * nz
    dev = x.device
    c3 = cell_coords(x, system)
    cid = (c3[:, 0] * ny + c3[:, 1]) * nz + c3[:, 2]
    order, scid, rank = sorted_ranks(cid)
    tgt = torch.clamp(scid * cap + rank, max=ncells * cap)
    last = torch.full((ncells * cap + 1,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, tgt, torch.arange(n, dtype=torch.int64,
                                              device=dev), "amax")
    flat = torch.where(last >= 0, order[torch.clamp(last, min=0)], n)
    base = flat[:-1].reshape(ncells, cap).T
    slot_bead = base[:, _grid_const(system, "src", torch.int64, dev)]
    interior = _grid_const(system, "interior", torch.bool, dev)
    scatter_bead = torch.where(interior[None, :], slot_bead, n)
    grid = CellGrid(slot_bead=slot_bead, scatter_bead=scatter_bead, x_ref=x)
    return grid, overflow_flag(rank, cap, FLAG_CELL_OVERFLOW)


def slot_coords(x: torch.Tensor, grid: CellGrid, system: System,
                far: float = -1.0e4):
    """(gx, gy, gz), each (cap, P): every slot's bead coordinate plus its
    ghost cell's box shift, empty slots at ``far`` (out of every
    cutoff)."""
    sh = _grid_const(system, "shifts", x.dtype, x.device)
    xp = torch.cat([x, x.new_full((1, 3), far)])
    slot = grid.slot_bead
    return tuple(xp[slot, k] + sh[None, :, k] for k in range(3))


def _shift(a: torch.Tensor, delta: int, fill):
    """Static shift along the minor axis: out[..., c] = a[..., c + delta]
    (grid.py:167)."""
    if delta == 0:
        return a
    pad = torch.full(a.shape[:-1] + (abs(delta),), fill, dtype=a.dtype,
                     device=a.device)
    if delta > 0:
        return torch.cat([a[..., delta:], pad], dim=-1)
    return torch.cat([pad, a[..., :delta]], dim=-1)


# the 13 lexicographically positive stencil offsets (grid.py:177): each
# unordered cell pair once, Newton's third law at the cell level
_HALF_OFFSETS = [
    (i, j, k)
    for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
    if (i, j, k) > (0, 0, 0)
]


def fold_to_beads(g: torch.Tensor, grid: CellGrid, system: System):
    """(..., cap, P) slot values summed onto their beads: (..., N).  Each
    halo column folds onto the interior column of its cell in a fixed
    order (the fold table), then one write of the interior slots, where
    each bead sits once (empty slots into a dropped entry N): no float
    atomics, the same sums on every run."""
    dev = g.device
    int_cols = _grid_const(system, "int_cols", torch.int64, dev)
    fold = _grid_const(system, "fold", torch.int64, dev)
    gz = torch.cat([g, g.new_zeros(g.shape[:-1] + (1,))], dim=-1)
    acc = gz[..., fold[0]]
    for k in range(1, fold.shape[0]):
        acc = acc + gz[..., fold[k]]
    tgt = grid.slot_bead[:, int_cols].reshape(-1)
    out = g.new_zeros(g.shape[:-2] + (system.n + 1,))
    out[..., tgt] = acc.reshape(g.shape[:-2] + (-1,))
    return out[..., :system.n]


def grid_pair_force(x: torch.Tensor, types: torch.Tensor, grid: CellGrid,
                    system: System, ex_partner=None, virial: bool = False,
                    energy: bool = True):
    """LJ forces and energy from the slot grid, exclusion-free, on the
    half stencil (grid.py:183): bonded pairs counted at full strength (the
    caller subtracts them, ``forces.special_pair_correction``), ghost
    cells carrying their +-L shifts, the self cell and 13 positive
    offsets with each reaction shifted back to its j cell, halo i-cells
    masked; ``ex_partner`` unused.  Returns (f, epair) or, with
    ``virial``, (f, epair, virial)."""
    from .pair import NP_DTYPE, _lj_tables, lj_tables_host

    dtype = x.dtype
    dev = x.device
    strides = cached_halo_maps(system)[3]
    int_m = _grid_const(system, "interior", dtype, dev)[None, None, :]
    pp = system.pair
    one_type = pp.epsilon.shape[0] == 1 or all(
        bool(np.all(np.asarray(a) == np.asarray(a).flat[0]))
        for a in (pp.epsilon, pp.sigma, pp.cutoff))
    if one_type:
        # every type pair shares one parameter set (all LE decks):
        # scalars, no per-pair table gathers
        tables = [float(t[0, 0])
                  for t in lj_tables_host(system, NP_DTYPE[dtype])]
    else:
        tables = _lj_tables(system, dtype, dev)
        nt = tables[0].shape[0]
    lj1, lj2, lj3, lj4, cutsq, offset_e, floorsq = tables

    slot = grid.slot_bead
    far = -1.0e4
    xp = torch.cat([x, x.new_full((1, 3), far)])
    sh = _grid_const(system, "shifts", dtype, dev)
    gx = xp[slot, 0] + sh[None, :, 0]
    gy = xp[slot, 1] + sh[None, :, 1]
    gz = xp[slot, 2] + sh[None, :, 2]
    if not one_type:
        gt = torch.cat([types, types.new_zeros(1)])[slot]
        gti = gt[:, None, :]

    fx = torch.zeros_like(gx)
    fy = torch.zeros_like(gy)
    fz = torch.zeros_like(gz)
    e_acc = torch.zeros_like(gx)
    w_acc = x.new_zeros(())
    gxi = gx[:, None, :]
    gyi = gy[:, None, :]
    gzi = gz[:, None, :]

    def pair_block(gxj, gyj, gzj, gtj):
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
        # rsq == 0 exactly only for the self pair
        mask = (rsq < csq) & (rsq > 0.0)
        w = torch.where(mask, int_m, 0.0)  # halo i-cells masked
        rsq_s = torch.where(mask, rsq, 1.0)
        rsq_s = (torch.clamp(rsq_s, min=fsq) if one_type
                 else torch.maximum(rsq_s, fsq))
        r2inv = 1.0 / rsq_s
        r6inv = r2inv * r2inv * r2inv
        fpair = r6inv * (l1 * r6inv - l2) * r2inv * w
        e = (r6inv * (l3 * r6inv - l4) - eoff) * w if energy else None
        return dx, dy, dz, fpair, e

    # the self cell: every i != j (each pair twice; energy halved)
    dx, dy, dz, fpair, e = pair_block(
        gx[None], gy[None], gz[None], None if one_type else gt[None])
    fx = fx + torch.sum(dx * fpair, dim=1)
    fy = fy + torch.sum(dy * fpair, dim=1)
    fz = fz + torch.sum(dz * fpair, dim=1)
    if energy:
        e_acc = e_acc + 0.5 * torch.sum(e, dim=1)
    if virial:
        w_acc = w_acc + 0.5 * torch.sum(fpair * (dx * dx + dy * dy
                                                 + dz * dz))

    for (ox, oy, oz) in _HALF_OFFSETS:
        delta = ox * strides[0] + oy * strides[1] + oz * strides[2]
        gtj = None if one_type else _shift(gt, delta, 0)[None]
        dx, dy, dz, fpair, e = pair_block(
            _shift(gx, delta, far)[None], _shift(gy, delta, far)[None],
            _shift(gz, delta, far)[None], gtj)
        wfx = dx * fpair
        wfy = dy * fpair
        wfz = dz * fpair
        fx = fx + torch.sum(wfx, dim=1)
        fy = fy + torch.sum(wfy, dim=1)
        fz = fz + torch.sum(wfz, dim=1)
        if energy:
            e_acc = e_acc + torch.sum(e, dim=1)
        if virial:
            w_acc = w_acc + torch.sum(wfx * dx + wfy * dy + wfz * dz)
        # Newton's reaction on the j cell: reduce over i, shift back
        fx = fx - _shift(torch.sum(wfx, dim=0), -delta, 0.0)
        fy = fy - _shift(torch.sum(wfy, dim=0), -delta, 0.0)
        fz = fz - _shift(torch.sum(wfz, dim=0), -delta, 0.0)

    f = fold_to_beads(torch.stack([fx, fy, fz]), grid, system).T
    epair = torch.sum(e_acc) if energy else x.new_zeros(())
    if virial:
        return f, epair, w_acc
    return f, epair
