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

import numpy as np
import torch

from ..ops.cells import cell_coords, const, wrap_positions
from ..state import FLAG_CELL_OVERFLOW, _partner_table
from ..system import System
from .kernels_ref import _FAR
from .maps import FastMaps, HaloImages


@dataclasses.dataclass
class ImageTensors:
    """A ``maps.HaloImages`` on the run's device, for one plane of
    ``cap`` rows: the kernel's map (``ptr``, ``idx``, ``src``, ``shift``,
    ``own``) and the plain version's lists (``loc_*``: the local images,
    ``send_*``: the sent ones in segment order).  ``idx`` holds each
    image's (base, w): a local image of row r and component k lands at
    ``base + (k cap + r) w`` of the planes (base its column, w = P), a
    sent one at ``base + (k cap + r) |w|`` of the send buffer (w = -its
    segment's columns, base its segment's start, 3 cap columns before
    it, plus its position): the send buffer holds the segments one after
    another, each a (3, cap, columns) block."""

    cap: int
    P: int
    sizes: tuple              # columns of each send segment
    ptr: torch.Tensor         # (P + 1,) int32 CSR offsets
    idx: torch.Tensor         # (I, 2) int32 (base, w)
    src: torch.Tensor         # (I,) int32 source column
    shift: torch.Tensor       # (3, I) run float type
    own: torch.Tensor         # (P,) bool: the slot writes its own x
    loc_src: torch.Tensor     # (L,) int64
    loc_dst: torch.Tensor     # (L,) int64
    loc_shift: torch.Tensor   # (3, L)
    send_src: torch.Tensor    # (S,) int64, segment after segment
    send_shift: torch.Tensor  # (3, S)

    @property
    def n_send(self) -> int:
        return sum(self.sizes)

    @property
    def halo_lists(self):
        """The local images as the halo lists the plain version's gather
        takes: (halo_cols, halo_src, halo_shift (3, L))."""
        return self.loc_dst, self.loc_src, self.loc_shift

    @classmethod
    def build(cls, im: HaloImages, cap: int, dtype, device):
        P = im.own.shape[0]
        sent = im.seg >= 0
        start = np.concatenate([[0], np.cumsum(im.sizes)]).astype(np.int64)
        size = np.asarray(im.sizes + (0,), np.int64)[im.seg]
        base = np.where(sent, 3 * cap * start[im.seg], 0) + im.dst
        w = np.where(sent, -size, P)
        # the sent images in segment order, each segment by position
        order = np.lexsort((im.dst, im.seg))[int((~sent).sum()):]
        loc = np.nonzero(~sent)[0]

        def t(a, dt=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=device)

        return cls(
            cap=cap, P=P, sizes=tuple(int(n) for n in im.sizes),
            ptr=t(im.ptr, torch.int32),
            idx=t(np.stack([base, w], 1), torch.int32),
            src=t(im.src, torch.int32),
            shift=t(im.shift.T, dtype), own=t(im.own, torch.bool),
            loc_src=t(im.src[loc]), loc_dst=t(im.dst[loc]),
            loc_shift=t(im.shift[loc].T, dtype),
            send_src=t(im.src[order]), send_shift=t(im.shift[order].T, dtype))


@dataclasses.dataclass
class GridConsts:
    """The maps' arrays on the run's device."""

    interior: torch.Tensor    # (P,) bool
    halo_cols: torch.Tensor   # (H,) int32
    halo_src: torch.Tensor    # (H,) int32
    halo_shift: torch.Tensor  # (3, H) run float type
    has_next: torch.Tensor    # (N,) bool: bead has a chain-next link
    faces: torch.Tensor       # (6, P) bool ghost faces (FastMaps.faces)
    images: ImageTensors      # the halo map inverted (FastMaps.images)

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
            images=ImageTensors.build(maps.images, maps.cap, dtype, device),
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

    partner = _partner_table(ex_left, ex_right, n)
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

    partner = _partner_table(ex_left, ex_right, n)
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
