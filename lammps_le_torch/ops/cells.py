"""Periodic wrapping, cell assignment, cell bins and the verlet list
(``lammps_le_tpu.ops.cells``).

Cells are a dense (ncells, cell_cap) table built by one stable sort; the
verlet list a dense (N, max_neighbors) full list.  Overflows set sticky
flag bits, never drop pairs silently.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from ..state import FLAG_CELL_OVERFLOW, FLAG_NEIGHBOR_OVERFLOW, NeighborList
from ..system import System

# 27-cell stencil offsets, static (cells.py:36).
_STENCIL = np.array(
    [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    dtype=np.int64,
)


@functools.lru_cache(maxsize=64)
def const(values: tuple, dtype, device) -> torch.Tensor:
    """A small constant tensor, made once per values, type and device: a
    tensor made from host values is a copy that waits for the card, and
    placement takes these at every rebuild.  Never written."""
    return torch.tensor(values, dtype=dtype, device=device)


_SYSTEM_CONSTS = collections.OrderedDict()


def system_const(system: System, name: str, make, dtype, device):
    """A tensor of one of ``system``'s static arrays (``make()`` gives it
    as numpy) on ``device``, made once per system, name, type and device
    and never written: a step takes these without a host-to-device copy,
    which would wait for the card.  The entry holds the system, so its
    id is not reused while the entry lives; at most 256 entries."""
    key = (id(system), name, dtype, str(device))
    hit = _SYSTEM_CONSTS.get(key)
    if hit is None:
        hit = (system, torch.as_tensor(np.asarray(make()), dtype=dtype,
                                       device=device))
        _SYSTEM_CONSTS[key] = hit
        if len(_SYSTEM_CONSTS) > 256:
            _SYSTEM_CONSTS.popitem(last=False)
    return hit[1]


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return const(tuple(np.asarray(values).tolist()), like.dtype, like.device)


def minimum_image(d: torch.Tensor, box_size) -> torch.Tensor:
    """Wrap displacements to the nearest image (domain.cpp:980); rounds
    half to even like ``jnp.round``."""
    box = _vec(box_size, d)
    return d - box * torch.round(d / box)


def wrap_positions(x: torch.Tensor, system: System, img: torch.Tensor):
    """Remap positions into [lo, hi), updating image counters
    (domain.cpp:528).  In f32 ``x - shift*box`` can round onto ``hi`` (or
    a hair below ``lo``); the corrections below land every coordinate
    exactly in [lo, hi), counting each full-box move (cells.py:47)."""
    lo = _vec(system.box_lo, x)
    box = _vec(system.box_size, x)
    hi = lo + box
    shift = torch.floor((x - lo) / box).to(torch.int64)
    x = x - shift.to(x.dtype) * box
    over = x >= hi
    x = torch.where(over, x - box, x)
    shift = shift + over.to(torch.int64)
    under = x < lo
    x = torch.where(under, x + box, x)
    shift = shift - under.to(torch.int64)
    pin = x >= hi
    x = torch.where(pin, lo.expand_as(x), x)
    shift = shift + pin.to(torch.int64)
    return x, img + shift


def cell_coords(x: torch.Tensor, system: System) -> torch.Tensor:
    """(N, 3) integer cell coordinates of wrapped positions.  Clips rather
    than re-wrapping, so a coordinate within an ulp of ``hi`` keeps a cell
    consistent with it (cells.py:80)."""
    cfg = system.neighbor
    lo = _vec(system.box_lo, x)
    box = _vec(system.box_size, x)
    dims = const((cfg.nx, cfg.ny, cfg.nz), torch.int64, x.device)
    s = (x - lo) / box
    c = torch.floor(s * dims.to(x.dtype)).to(torch.int64)
    return torch.minimum(torch.clamp(c, min=0), dims - 1)


def _flatten_cells(c3: torch.Tensor, system: System) -> torch.Tensor:
    cfg = system.neighbor
    return (c3[..., 0] * cfg.ny + c3[..., 1]) * cfg.nz + c3[..., 2]


def sorted_ranks(cid: torch.Tensor):
    """(order, sorted ids, rank within its cell) of beads by cell id: a
    stable sort, as ``jnp.argsort``, and each bead's distance from its
    cell's first bead (``lax.associative_scan(max)``, cells.py:118)."""
    scid, order = torch.sort(cid, stable=True)
    idx = torch.arange(cid.shape[0], dtype=torch.int64, device=cid.device)
    is_start = torch.ones_like(scid, dtype=torch.bool)
    is_start[1:] = scid[1:] != scid[:-1]
    start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    return order, scid, idx - start


def overflow_flag(rank: torch.Tensor, cap: int, bit: int) -> torch.Tensor:
    """``bit`` where any rank reaches ``cap``, else 0 (an int64 scalar on
    the device: no host read)."""
    return (rank.max() >= cap).to(torch.int64) * bit


def build_cell_bins(x: torch.Tensor, system: System):
    """Dense (ncells, cell_cap) table of bead ids padded with N (cells.py
    :105); ranks past cap are dropped and flagged."""
    cfg = system.neighbor
    n = system.n
    ncells = cfg.nx * cfg.ny * cfg.nz
    cap = cfg.cell_cap
    cid = _flatten_cells(cell_coords(x, system), system)
    order, scid, rank = sorted_ranks(cid)
    # one collision-free write: each (cell, rank < cap) once, the rest
    # into a dropped entry
    tgt = torch.where(rank < cap, scid * cap + rank, ncells * cap)
    bins = torch.full((ncells * cap + 1,), n, dtype=torch.int64,
                      device=x.device)
    bins[tgt] = order
    bins = bins[:-1].reshape(ncells, cap)
    return bins, overflow_flag(rank, cap, FLAG_CELL_OVERFLOW)


def build_neighbor_list(x: torch.Tensor, system: System):
    """(N, max_neighbors) full verlet list within cutoff + skin (cells.py
    :131): (NeighborList, flags).  With ``use_cells=False`` row i lists
    every other bead.  Each row keeps the ``max_neighbors`` closest
    candidates (``torch.topk`` orders ties unlike ``lax.top_k``: rows
    agree as sets)."""
    cfg = system.neighbor
    n = system.n
    dev = x.device
    if not cfg.use_cells:
        idx = torch.arange(n, dtype=torch.int64, device=dev).expand(n, n)
        rows = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
        idx = torch.where(idx == rows, n, idx)
        idx = torch.sort(idx, dim=1).values[:, :max(n - 1, 1)]
        return (NeighborList(idx=idx, x_ref=x),
                torch.zeros((), dtype=torch.int64, device=dev))

    rc = (system.pair.max_cutoff if system.pair is not None
          else cfg.cell_size - cfg.skin)
    rlist_sq = (rc + cfg.skin) ** 2

    bins, flags = build_cell_bins(x, system)
    c3 = cell_coords(x, system)
    dims = const((cfg.nx, cfg.ny, cfg.nz), torch.int64, dev)
    stencil = const(tuple(map(tuple, _STENCIL.tolist())), torch.int64, dev)
    ncc = torch.remainder(c3[:, None, :] + stencil[None], dims)
    cand = bins[_flatten_cells(ncc, system)].reshape(n, 27 * cfg.cell_cap)

    xp = torch.cat([x, x.new_zeros((1, 3))])
    d = minimum_image(xp[cand] - x[:, None, :], system.box_size)
    rsq = torch.sum(d * d, dim=-1)
    self_rows = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    valid = (cand != n) & (cand != self_rows) & (rsq < rlist_sq)

    k = cfg.max_neighbors
    big = torch.finfo(rsq.dtype).max
    keys = torch.where(valid, rsq, big)
    sel = torch.topk(-keys, k, dim=1).indices
    idx = torch.where(torch.gather(valid, 1, sel),
                      torch.gather(cand, 1, sel), n)
    nvalid = valid.sum(dim=1)
    flags = flags | (nvalid.max() > k).to(torch.int64) * \
        FLAG_NEIGHBOR_OVERFLOW
    return NeighborList(idx=idx, x_ref=x), flags
