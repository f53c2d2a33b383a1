"""Static geometry of the halo-padded cell grid (``lammps_le_tpu.ops.grid``).

Beads live in a dense (cap, P) slot grid whose flat cell axis P is the 3-D
cell grid surrounded by one layer of ghost (halo) cells, padded to a
multiple of 128; halo cells hold shifted copies of the periodic source
cells, so the 27-cell stencil is 27 static column offsets.
"""

from __future__ import annotations

import numpy as np

from ..system import System

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
