"""Rebuild: bin beads into fresh grid planes (engine._place, _ex_slots and
the halo refreshes, engine.py:307-404, 562-602).

Plain PyTorch on every device, as it is XLA (not Pallas) in the
reference.  The bin order must match the reference slot for slot, so the
sort is stable (``jnp.argsort`` is, torch's default is not) and the
segment starts of the sorted cell ids come from ``torch.cummax`` (the
reference's ``associative_scan(max)``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.cells import cell_coords, const, wrap_positions
from ..state import FLAG_CELL_OVERFLOW, extruder_partner
from ..system import System
from .kernels_ref import _FAR
from .maps import FastMaps


@dataclasses.dataclass
class GridConsts:
    """The maps' arrays on the run's device."""

    interior: torch.Tensor    # (P,) bool
    halo_cols: torch.Tensor   # (H,) int32
    halo_src: torch.Tensor    # (H,) int32
    halo_shift: torch.Tensor  # (3, H) run float type
    has_next: torch.Tensor    # (N,) bool: bead has a chain-next link
    faces: torch.Tensor       # (6, P) bool ghost faces (FastMaps.faces)

    @classmethod
    def build(cls, system: System, maps: FastMaps, device):
        dtype = getattr(torch, system.dtype)
        return cls(
            interior=torch.as_tensor(maps.interior, device=device),
            halo_cols=torch.as_tensor(maps.halo_cols, device=device),
            halo_src=torch.as_tensor(maps.halo_src, device=device),
            halo_shift=torch.as_tensor(maps.halo_shift.T.copy(),
                                       dtype=dtype, device=device),
            has_next=torch.as_tensor(system.next_bead >= 0, device=device),
            faces=torch.as_tensor(maps.faces, device=device),
        )


def halo_refresh(gx, g: GridConsts):
    """Position planes (any leading axes): halo columns <- interior
    sources + image shift."""
    gx[..., g.halo_cols] = gx[..., g.halo_src] + g.halo_shift[:, None, :]
    return gx


def halo_refresh_int(planes, g: GridConsts):
    """Stacked int/bool planes: halo columns <- interior sources."""
    planes[..., g.halo_cols] = planes[..., g.halo_src]
    return planes


def ex_slots(slot_of, ex_left, ex_right):
    """Flat slots of both anchors (int32); inactive springs read bead 0's
    slot, as in the reference.  Any leading (replica) axes."""
    active = ex_left >= 0
    sl = torch.gather(slot_of, -1, torch.where(active, ex_left, 0))
    sr = torch.gather(slot_of, -1, torch.where(active, ex_right, 0))
    return sl.to(torch.int32), sr.to(torch.int32)


def place(system: System, maps: FastMaps, g: GridConsts, x, v, f,
          ex_left, ex_right, img):
    """Bin one run's beads into fresh planes.  Returns (gx, gv, gf, bid,
    hn, pid, slot_of, exl_slot, exr_slot, x_wrapped, img, overflow_flag).
    R replicas: ``place_replicas``, kept apart so that a run's rebuild
    issues none of its reshaping (the host issues placement's ops at
    every rebuild of a host-bound path)."""
    n = system.n
    cap, P = maps.cap, maps.P
    capP = cap * P
    dev = x.device
    _, ny, nz = maps.nxyz
    py, pz = ny + 2, nz + 2

    x, img = wrap_positions(x, system, img)
    c3 = cell_coords(x, system)
    col = ((c3[:, 0] + 1) * py + c3[:, 1] + 1) * pz + c3[:, 2] + 1
    order = torch.argsort(col, stable=True)
    scol = col[order]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = scol[1:] != scol[:-1]
    start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - start
    overflow = (rank.max() >= cap).to(torch.int64) * FLAG_CELL_OVERFLOW
    # overflowed beads get DISTINCT slots >= capP (engine.py:337)
    slot_sorted = torch.where(rank < cap, rank * P + scol, capP + idx)
    slot_of = torch.empty(n, dtype=torch.int64, device=dev)
    slot_of[order] = slot_sorted
    # bead at each slot (n = empty); overflow slots land past capP and
    # are cut off
    bas = torch.full((capP + n,), n, dtype=torch.int64, device=dev)
    bas[slot_sorted] = order
    bas = bas[:capP]

    arr9 = torch.cat([x.T, v.T, f.T])
    sentinel = const((_FAR,) * 3 + (0.0,) * 6, x.dtype, dev)[:, None]
    planes9 = torch.cat([arr9, sentinel], dim=1)[:, bas]
    gx = planes9[0:3].reshape(3, cap, P)
    gv = planes9[3:6].reshape(3, cap, P).contiguous()
    gf = planes9[6:9].reshape(3, cap, P).contiguous()

    partner = extruder_partner(ex_left, ex_right, n)
    none = torch.full((1,), -1, dtype=partner.dtype, device=dev)
    no_link = torch.zeros(1, dtype=torch.bool, device=dev)
    ints = torch.stack([
        bas,
        torch.cat([g.has_next, no_link])[bas].to(torch.int64),
        torch.cat([partner, none])[bas],
    ]).reshape(3, cap, P)
    ints = halo_refresh_int(ints, g)
    bid = ints[0].to(torch.int32)
    hn = ints[1] > 0
    pid = ints[2].to(torch.int32)
    gx = halo_refresh(gx.contiguous(), g)
    exl_slot, exr_slot = ex_slots(slot_of, ex_left, ex_right)
    return (gx, gv, gf, bid, hn, pid, slot_of, exl_slot, exr_slot, x, img,
            overflow)


def place_replicas(system: System, maps: FastMaps, g: GridConsts, x, v, f,
                   ex_left, ex_right, img):
    """``place`` for R replicas at once: bead arrays (R, N, ...) and
    extruder tables (R, E) give every output with a leading R axis
    (``overflow_flag`` (R,)), each replica's bitwise its own ``place``:
    one stable sort of the (replica, column) keys, the segment starts'
    ``cummax`` along each replica's row (its first key starts a segment),
    and every scatter and gather over the replicas' arrays laid end to
    end."""
    R, n = x.shape[:2]
    cap, P = maps.cap, maps.P
    capP = cap * P
    dev = x.device
    _, ny, nz = maps.nxyz
    py, pz = ny + 2, nz + 2

    x, img = wrap_positions(x, system, img)
    c3 = cell_coords(x, system)
    col = ((c3[..., 0] + 1) * py + c3[..., 1] + 1) * pz + c3[..., 2] + 1
    # replica-major keys (every column is < P); replica r's beads, its
    # grid's slots and bead arrays (with their sentinel) lie at r * n,
    # r * (capP + n) and r * (n + 1) of the arrays laid end to end
    rep = torch.arange(R, device=dev)[:, None]
    key = (col + P * rep).reshape(-1)
    order = torch.argsort(key, stable=True)
    scol = key[order]
    idx = torch.arange(R * n, dtype=torch.int64, device=dev)
    is_start = torch.ones(R * n, dtype=torch.bool, device=dev)
    is_start[1:] = scol[1:] != scol[:-1]
    # each replica's first place starts a segment: the scan runs per
    # replica, one row each
    start = torch.cummax(torch.where(is_start, idx, 0).reshape(R, n),
                         dim=1).values.reshape(-1)
    rank = idx - start
    # sorted place i holds replica i // n's bead order[i] - n * (i // n)
    # in its column scol[i] - P * (i // n)
    rep_i = idx // n
    local = idx - n * rep_i
    scol = scol - P * rep_i
    overflow = (rank.reshape(R, n).amax(dim=1) >= cap).to(
        torch.int64) * FLAG_CELL_OVERFLOW
    # overflowed beads get DISTINCT slots >= capP (engine.py:337)
    slot_sorted = torch.where(rank < cap, rank * P + scol, capP + local)
    slot_of = torch.empty(R * n, dtype=torch.int64, device=dev)
    slot_of[order] = slot_sorted
    # bead at each slot (n = empty); overflow slots land past capP and
    # are cut off
    bas = torch.full((R, capP + n), n, dtype=torch.int64, device=dev)
    bas.view(-1)[slot_sorted + (capP + n) * rep_i] = order - n * rep_i
    bas = bas[:, :capP]
    # each slot's index into the replicas' (n + 1)-long bead arrays
    src = bas + (n + 1) * rep

    sentinel = const((_FAR,) * 3 + (0.0,) * 6, x.dtype, dev)[:, None]
    arr9 = torch.cat([torch.cat([x.mT, v.mT, f.mT], dim=-2),
                      sentinel.expand(R, 9, 1)], dim=-1)
    planes9 = arr9.transpose(0, 1).reshape(9, -1)[:, src.reshape(-1)]
    planes9 = planes9.reshape(9, R, cap, P).transpose(0, 1)
    gx = planes9[:, 0:3]
    gv = planes9[:, 3:6].contiguous()
    gf = planes9[:, 6:9].contiguous()

    partner = extruder_partner(ex_left, ex_right, n)
    none = torch.full((R, 1), -1, dtype=partner.dtype, device=dev)
    no_link = torch.zeros(1, dtype=torch.bool, device=dev)
    ints = torch.stack([
        bas,
        torch.cat([g.has_next, no_link])[bas].to(torch.int64),
        torch.cat([partner, none], dim=1).reshape(-1)[src.reshape(-1)]
        .reshape(R, capP),
    ], dim=1).reshape(R, 3, cap, P)
    ints = halo_refresh_int(ints, g)
    bid = ints[:, 0].to(torch.int32)
    hn = ints[:, 1] > 0
    pid = ints[:, 2].to(torch.int32)
    gx = halo_refresh(gx.contiguous(), g)
    slot_of = slot_of.reshape(R, n)
    exl_slot, exr_slot = ex_slots(slot_of, ex_left, ex_right)
    return (gx, gv, gf, bid, hn, pid, slot_of, exl_slot, exr_slot, x, img,
            overflow)
