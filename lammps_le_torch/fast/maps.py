"""Static (numpy) maps of the grid-resident engine (engine.py:80-145
``fast_maps`` / ``_FastMaps``).

``src_cols``/``shifts``/``interior``/``strides``/``P`` are the reference's,
padded the same way.  The reference refreshes halo columns as six masked
rolls (engine._halo_refresh); the port refreshes them as one gather over
the halo columns (``halo_cols`` <- ``halo_src`` + ``halo_shift``), which is
bit-for-bit the same: each component of a halo copy gets at most one +-L,
added onto an interior value.  The lane-padding tail (columns >= p_raw) is
in no face mask there and in no halo list here: it keeps its far-away
fill from placement.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..ops.grid import halo_maps
from ..system import System


@dataclasses.dataclass(frozen=True)
class FastMaps:
    cap: int
    P: int
    p_raw: int
    nxyz: Tuple[int, int, int]
    strides: Tuple[int, int, int]
    src_cols: np.ndarray     # (P,) padded source column per padded column
    interior: np.ndarray     # (P,) bool
    shifts: np.ndarray       # (P, 3) ghost-image coordinate shifts
    halo_cols: np.ndarray    # (H,) halo columns (< p_raw, not interior)
    halo_src: np.ndarray     # (H,) their interior source columns
    halo_shift: np.ndarray   # (H, 3) their coordinate shifts


_MAPS_CACHE: dict = {}


def fast_maps(system: System) -> FastMaps:
    cfg = system.neighbor
    key = (cfg.nx, cfg.ny, cfg.nz, cfg.cell_cap, system.box_size)
    hit = _MAPS_CACHE.get(key)
    if hit is not None:
        return hit
    src_p, int_p, p, strides, shifts = halo_maps(system)
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    py, pz = ny + 2, nz + 2
    p_raw = (nx + 2) * py * pz
    cx, cy, cz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    int_cell = (((cx + 1) * py + cy + 1) * pz + cz + 1).reshape(-1)
    src_cols = np.zeros(p, np.int32)
    src_cols[:p_raw] = int_cell[src_p[:p_raw]]
    shifts = np.array(shifts, np.float64)
    if p > p_raw:
        # lane-padding tail: cell 0 pushed far out of range (engine.py:123)
        src_cols[p_raw:] = int_cell[0]
        shifts[p_raw:] = [5.0 * b for b in system.box_size]
    interior = np.array(int_p, bool)
    halo_cols = np.nonzero(~interior[:p_raw])[0].astype(np.int32)
    maps = FastMaps(
        cap=cfg.cell_cap, P=p, p_raw=p_raw, nxyz=(nx, ny, nz),
        strides=strides, src_cols=src_cols, interior=interior,
        shifts=shifts, halo_cols=halo_cols,
        halo_src=src_cols[halo_cols], halo_shift=shifts[halo_cols],
    )
    _MAPS_CACHE[key] = maps
    return maps
