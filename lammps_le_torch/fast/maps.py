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

``images`` inverts the halo map (``HaloImages``): each interior column's
halo images, in CSR form over the source columns, so that K2a's kernel
writes every halo copy from the thread that computed its source.

``faces``/``fold_shifts`` are the ghost-fold constants of
``pallas_step.make_halo_consts`` (pallas_step.py:513-551): the six ghost
face masks (aux rows 0-5: x lo/hi, y lo/hi, z lo/hi) and, per axis, the
roll shifts ``((-n*s) % P, (n*s) % P)`` that carry a face's reactions
onto the interior cells it images (the Newton-half stencil's fold).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..ops.grid import halo_maps
from ..system import System


@dataclasses.dataclass(frozen=True)
class HaloImages:
    """The halo map of a plane of P columns inverted: the images of
    source column c are ``[ptr[c], ptr[c + 1])``, sorted by source column
    (in list order within one).  An image lands in column ``dst`` of the
    plane itself (``seg`` -1) or at position ``dst`` of send segment
    ``seg``: the images that another slab's plane takes (``halo_images``'
    ``sends``).  ``own``: the columns whose slots write their own x (every
    column but a local image's)."""

    ptr: np.ndarray     # (P + 1,) int32
    src: np.ndarray     # (I,) int32 source column
    dst: np.ndarray     # (I,) int32 destination column or segment position
    shift: np.ndarray   # (I, 3) coordinate shift
    seg: np.ndarray     # (I,) int32 send segment, -1 if local
    sizes: Tuple[int, ...]  # columns of each send segment
    own: np.ndarray     # (P,) bool


def halo_images(P: int, src, dst, shift, sends=()) -> HaloImages:
    """The images of the halo lists (``src`` interior source column,
    ``dst`` halo column of the same plane, ``shift`` (H, 3)) and of the
    send segments ``sends`` (each a (source columns, shifts) pair, its
    images at positions 0, 1, ... of the segment), inverted by source
    column."""
    segs = [(np.asarray(src, np.int64), np.asarray(dst, np.int64), shift)]
    segs += [(np.asarray(s, np.int64), np.arange(len(s)), sh)
             for s, sh in sends]
    all_src = np.concatenate([s for s, _, _ in segs])
    order = np.argsort(all_src, kind="stable")

    def cat(parts):
        return np.concatenate(parts)[order]

    own = np.ones(P, bool)
    own[segs[0][1]] = False
    return HaloImages(
        ptr=np.concatenate([[0], np.cumsum(np.bincount(
            all_src, minlength=P))]).astype(np.int32),
        src=all_src[order].astype(np.int32),
        dst=cat([d for _, d, _ in segs]).astype(np.int32),
        shift=cat([np.asarray(sh, np.float64).reshape(-1, 3)
                   for _, _, sh in segs]),
        seg=cat([np.full(len(s), g - 1) for g, (s, _, _) in
                 enumerate(segs)]).astype(np.int32),
        sizes=tuple(len(s) for s, _, _ in segs[1:]), own=own)


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
    faces: np.ndarray        # (6, P) bool ghost faces x lo/hi, y, z
    fold_shifts: Tuple[Tuple[int, int], ...]  # per axis (lo, hi) roll
    images: HaloImages       # the halo map inverted


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
    ix, iy, iz = np.meshgrid(np.arange(nx + 2), np.arange(py),
                             np.arange(pz), indexing="ij")
    faces = np.zeros((6, p), bool)
    for k, (c, m) in enumerate(((ix, nx), (iy, ny), (iz, nz))):
        faces[2 * k, :p_raw] = (c == 0).reshape(-1)
        faces[2 * k + 1, :p_raw] = (c == m + 1).reshape(-1)
    fold_shifts = tuple(((-m * s) % p, (m * s) % p)
                        for m, s in zip((nx, ny, nz), strides))
    maps = FastMaps(
        cap=cfg.cell_cap, P=p, p_raw=p_raw, nxyz=(nx, ny, nz),
        strides=strides, src_cols=src_cols, interior=interior,
        shifts=shifts, halo_cols=halo_cols,
        halo_src=src_cols[halo_cols], halo_shift=shifts[halo_cols],
        faces=faces, fold_shifts=fold_shifts,
        images=halo_images(p, src_cols[halo_cols], halo_cols,
                           shifts[halo_cols]),
    )
    _MAPS_CACHE[key] = maps
    return maps
