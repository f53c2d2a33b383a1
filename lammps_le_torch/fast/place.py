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

from ..ops.cells import cell_coords, wrap_positions
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
    """Position planes: halo columns <- interior sources + image shift."""
    gx[:, :, g.halo_cols] = gx[:, :, g.halo_src] + g.halo_shift[:, None, :]
    return gx


def halo_refresh_int(planes, g: GridConsts):
    """Stacked int/bool planes: halo columns <- interior sources."""
    planes[..., g.halo_cols] = planes[..., g.halo_src]
    return planes


def ex_slots(slot_of, ex_left, ex_right):
    """Flat slots of both anchors (int32); inactive springs read bead 0's
    slot, as in the reference."""
    active = ex_left >= 0
    sl = slot_of[torch.where(active, ex_left, 0)]
    sr = slot_of[torch.where(active, ex_right, 0)]
    return sl.to(torch.int32), sr.to(torch.int32)


def place(system: System, maps: FastMaps, g: GridConsts, x, v, f,
          ex_left, ex_right, img):
    """Bin beads into fresh planes.  Returns (gx, gv, gf, bid, hn, pid,
    slot_of, exl_slot, exr_slot, x_wrapped, img, overflow_flag)."""
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
    sentinel = torch.tensor([_FAR] * 3 + [0.0] * 6, dtype=x.dtype,
                            device=dev)[:, None]
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
