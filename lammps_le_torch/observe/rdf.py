"""Radial distribution function g(r) — a histogram on the state's device
(``lammps_le_tpu/observe/rdf.py``).

The analog of ``compute rdf`` (reference: src/compute_rdf.cpp) for the
melt-structure checks LE studies use (solvent-free bead-spring melts have
a characteristic WCA first peak at ~1.05 sigma).  Reuses the halo cell
grid like the contact-map observable: every pair within ``rmax`` votes
into a radial bin; normalization to the ideal-gas shell count follows the
reference's convention (compute_rdf.cpp:187-219).  The votes are counted
as integers (``torch.bincount`` of the live pairs' bins, offset by
offset: exact in any order, and no atomic traffic on a bin for the
masked-out slots), then added to the float32 histogram: the reference's
f32 sums of ones, while a bin stays under 2^24.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import grid as grid_ops
from ..ops.cells import wrap_positions
from ..state import State
from ..system import System, make_neighbor_config

_FAR = -1.0e4


def wide_system(system: System, reach: float, cap_boost: int = 1):
    """``system`` with a binning grid whose cells cover ``reach`` (rdf.py:
    33-42, contact_map.py:36-52): past the pair grid's cell size a
    dedicated coarser grid, its cap from the Poisson tail of the mean
    density (lam + 6 sqrt(lam) + 4, at least 8) times ``cap_boost``;
    within it the pair grid, its cap times ``cap_boost``."""
    if reach > system.neighbor.cell_size:
        density = system.n / float(np.prod(np.asarray(system.box_size)))
        lam = 4.0 * density * reach ** 3
        cap = max(8, int(np.ceil(lam + 6.0 * np.sqrt(lam) + 4.0)))
        return system.replace(
            neighbor=make_neighbor_config(system.box_size, reach, skin=0.0,
                                          cell_cap=cap * cap_boost))
    if cap_boost > 1:
        return system.with_neighbor(
            cell_cap=system.neighbor.cell_cap * cap_boost)
    return system


def pair_votes(state: State, system: System, reach: float, vote):
    """Every ordered pair of beads within ``reach`` on ``system``'s grid,
    once from each side (the 27 offsets, interior i cells): ``vote(mask,
    rsq, i_slots, delta)`` for each offset, with the (cap, cap, P) mask of
    live pairs.  Returns the grid's overflow flag."""
    x, _ = wrap_positions(state.x, system, state.img)
    grid, overflow = grid_ops.build_grid(x, system)
    slot = grid.slot_bead
    n = system.n
    strides = grid_ops.cached_halo_maps(system)[3]
    interior = grid_ops._grid_const(system, "interior", torch.bool,
                                    x.device)
    gx, gy, gz = grid_ops.slot_coords(x, grid, system, _FAR)
    gvalid = (slot != n)[:, None, :] & interior[None, None, :]
    for (a, b, c) in grid_ops._OFFSETS:
        delta = a * strides[0] + b * strides[1] + c * strides[2]
        dx = gx[:, None, :] - grid_ops._shift(gx, delta, _FAR)[None]
        dy = gy[:, None, :] - grid_ops._shift(gy, delta, _FAR)[None]
        dz = gz[:, None, :] - grid_ops._shift(gz, delta, _FAR)[None]
        rsq = dx * dx + dy * dy + dz * dz
        mask = gvalid & (rsq < reach * reach) & (rsq > 0.0)
        vote(mask, rsq, slot, delta)
    return overflow


def make_rdf_fn(system: System, nbins: int = 50, rmax: float = None,
                cap_boost: int = 1):
    """(state, hist) -> (hist, flags) with this snapshot's pair counts
    added (rdf.py:24).

    ``hist`` is a (nbins,) float32 vector of raw pair counts (both
    directions); convert to g(r) with :func:`normalize_rdf`.  ``flags``
    carries FLAG_CELL_OVERFLOW when the binning grid dropped beads (the
    frame then undercounts pairs — resize with ``cap_boost``); overflow is
    never silent (LE globules pack far beyond mean density).
    """
    if rmax is None:
        rmax = system.neighbor.cell_size
    system = wide_system(system, rmax, cap_boost)
    assert rmax <= system.neighbor.cell_size
    inv_dr = nbins / rmax

    def accumulate(state: State, hist: torch.Tensor):
        counts = torch.zeros(nbins, dtype=torch.int64, device=state.x.device)

        def vote(mask, rsq, slot, delta):
            live = rsq[mask]
            binidx = torch.clamp(
                (torch.sqrt(torch.clamp(live, min=1e-12)) * inv_dr).to(
                    torch.int32), 0, nbins - 1)
            counts.add_(torch.bincount(binidx, minlength=nbins))

        overflow = pair_votes(state, system, rmax, vote)
        return hist.to(torch.float32) + counts.to(torch.float32), overflow

    return accumulate


def normalize_rdf(hist, system: System, nframes: int, nbins: int = None,
                  rmax: float = None):
    """(r_centers, g_of_r) using the ideal-gas shell normalization
    (rdf.py:92), host numpy."""
    if isinstance(hist, torch.Tensor):
        hist = hist.detach().cpu().numpy()
    hist = np.asarray(hist, np.float64)
    nbins = nbins or len(hist)
    rmax = rmax or system.neighbor.cell_size
    dr = rmax / nbins
    r_lo = np.arange(nbins) * dr
    shell = 4.0 / 3.0 * np.pi * ((r_lo + dr) ** 3 - r_lo ** 3)
    vol = float(np.prod(np.asarray(system.box_size)))
    density = system.n / vol
    ideal = shell * density * system.n * nframes
    return r_lo + 0.5 * dr, hist / np.maximum(ideal, 1e-300)
