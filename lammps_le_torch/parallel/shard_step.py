"""The sharded slab stencil: the counterpart of
``lammps_le_tpu/parallel/shard_step.py`` (K4).

Every (cap, P) plane splits into ``sp`` contiguous x-slabs of C = P / sp
columns.  All stencil offsets reach at most M = sx + sy + sz columns, so a
margin of M columns on each side makes every own column's j reads and
every Newton reaction local to the slab's window [M | C | M] of W
columns:

    windows    each slab's own columns with its neighbours' edge columns
               (periodic over P, as the unsharded rolls are)
    kernel     ``kernels.window_forces``: the Newton-half offset loop over
               every window, reactions kept in the window, one launch per
               device for all of its slabs
    reactions  each margin's reactions added to the owner's columns, in
               the reference's order (shard_step.py:201-206)
    ghost fold the six faces folded on the assembled planes, z -> y -> x
               (``kernels_ref.ghost_fold``, the reference's masked rolls)

The reference's ``Mesh`` with an ``sp`` axis is here ``mesh``: an ordered
sequence of ``torch.device``, one per slab, driven by one process as
JAX's single controller drives its mesh.  Slabs may share a device.  The
planes stay whole on the device they come in on (the FastState's); the
windows of the slabs of each device are gathered there and moved with
``.to(device)``, which is a no-op when the slabs live there, and their
forces come back the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fast import kernels as K
from ..fast.consts import StencilConsts
from ..fast.kernels_ref import ghost_fold
from ..fast.maps import halo_images
from ..fast.place import ImageTensors
from ..state import FLAG_BOND_REACH, FLAG_FENE_CLAMP
from ..system import System

# a copy of lammps_le_tpu/fast/blocked_kernel.py:72-73: the reference's
# measured VMEM bytes per window lane at cap 8 and 9, and its budget.  The
# port keeps the reference's gate, so it refuses exactly what the
# reference refuses.
_BYTES_PER_LANE = {8: 3610.0, 9: 2970.0}
_VMEM_BUDGET = 100 * 1024 * 1024


def _geometry(maps, nsp: int):
    """(C, M, W): chunk, margin and window widths."""
    C = maps.P // nsp
    M = sum(maps.strides)
    return C, M, M + C + M


def _windows(maps, mesh):
    """The slabs' windows on ``mesh`` (one device per slab): the global
    column of every window lane (sp, W) (shard_step.py:163), the lanes
    that are own interior columns (sp, W), and the device groups
    [(device, its slabs in order)] in the order of their first slabs."""
    nsp = len(mesh)
    C, M, W = _geometry(maps, nsp)
    lane = np.arange(W)
    cols = (lane[None, :] + np.arange(nsp)[:, None] * C - M) % maps.P
    in_own = (lane >= M) & (lane < M + C)
    groups = {}
    for s, dev in enumerate(mesh):
        groups.setdefault(dev, []).append(s)
    return cols, in_own[None, :] & maps.interior[cols], list(groups.items())


def _add_margins(own, from_right, from_left, M: int):
    """A slab's own columns ``own`` with the margins' reactions added in
    the reference's order (shard_step.py:201-206): its right neighbour's
    left margin onto its last M columns, then its left neighbour's right
    margin onto its first M."""
    own[..., -M:] += from_right
    own[..., :M] += from_left
    return own


def _stencil_out(stats):
    """The stencil's (energies (2,), ints (2,) = [flag bits, clamps]) from
    the window stats summed over the slabs (shard_step.py:238-254)."""
    clamps = (0.5 * stats[3]).to(torch.int64)
    reach = (0.5 * stats[2] < stats[4] - 0.5).to(torch.int64)
    flags = reach * FLAG_BOND_REACH + (clamps > 0).to(
        torch.int64) * FLAG_FENE_CLAMP
    return 0.5 * stats[:2], torch.stack([flags, clamps])


def shardable(system: System, maps, mesh):
    """None if ``mesh`` (one device per slab) and the geometry admit the
    slab stencil, else the reference's reason (shard_step.py:95-122).

    The sp-sizing hint keeps the reference's arithmetic as it is: it
    divides by ``_VMEM_BUDGET / bpl - 2 * M``, which is <= 0 when the
    budget holds no more than the two margins, and then gives a negative
    hint or raises ZeroDivisionError (a known fault of the reference)."""
    nsp = len(mesh)
    if maps.P % nsp:
        return f"P={maps.P} not divisible by sp={nsp}"
    C, M, W = _geometry(maps, nsp)
    if C < M:
        return f"chunk {C} lanes < margin {M} (grid too small for sp={nsp})"
    bpl = _BYTES_PER_LANE.get(maps.cap, 3610.0 / 8.0 * maps.cap)
    # the reference's window padded to its TPU lane tiling
    Wp = -(-W // 1024) * 1024
    need = Wp * bpl
    if need > _VMEM_BUDGET:
        # the reference's hint as it is: its divisor can be <= 0
        hint = int(np.ceil(maps.P / (_VMEM_BUDGET / bpl - 2 * M)))
        return (f"window {Wp} lanes x {bpl:.0f} B/lane = "
                f"{need / 2**20:.0f} MiB exceeds the "
                f"{_VMEM_BUDGET / 2**20:.0f} MiB VMEM envelope "
                f"(need sp >= {hint})")
    return None


def make_sharded_kernel(system: System, maps, ex_btype: int, mesh):
    """``engine.make_kernel``'s contract over the slab decomposition of
    ``mesh``: ``kernel(g, gx, bid, hn, pid, energy) -> (gf, energies (2,),
    ints (2,) = [flag bits, clamps])`` with the ghost columns of ``gf``
    folded onto their owners (shard_step.py:125-258; ``ex_btype`` as
    there).  Raises ValueError where ``shardable`` gives a reason.

    The kernel's ``window_args(gx, bid, hn, pid, energy)`` yields, per
    device, that device's slabs and the arguments of its
    ``kernels.window_forces`` call; ``margin``, ``chunk`` and ``window``
    are M, C and W.

    The reference pads each window to Wp lanes for the TPU's tiling; the
    port's windows are W columns, the period of their rolls.  The result
    is the same: an own column's j columns lie at most M columns on, so
    inside its window with no wrap, and only own columns act as i."""
    assert system.dtype == "float32", "sharded stencil is the f32 path"
    reason = shardable(system, maps, mesh)
    if reason:
        raise ValueError(f"sharded stencil unavailable: {reason}")
    mesh = [torch.device(d) for d in mesh]
    nsp = len(mesh)
    n = system.n
    cap, P = maps.cap, maps.P
    C, M, W = _geometry(maps, nsp)
    Cn = StencilConsts(system, np.float32)
    cols, ownint, groups = _windows(maps, mesh)
    cache = {}

    def consts(home):
        """Per device of the planes: each group's window columns there
        and its own-interior mask on its own device."""
        if home not in cache:
            cache[home] = [
                (dev, slabs,
                 torch.as_tensor(cols[slabs].reshape(-1), device=home),
                 torch.as_tensor(ownint[slabs].reshape(-1), device=dev))
                for dev, slabs in groups]
        return cache[home]

    def window_args(gx, bid, hn, pid, energy: bool):
        for dev, slabs, idx, own in consts(gx.device):
            planes = (p.index_select(-1, idx).to(dev)
                      for p in (gx, bid, hn, pid))
            yield slabs, (*planes, own, Cn, n, W, maps.strides, energy)

    def kernel(g, gx, bid, hn, pid, energy: bool):
        home = gx.device
        F = None
        stats = torch.zeros(5, dtype=gx.dtype, device=home)
        for slabs, args in window_args(gx, bid, hn, pid, energy):
            f, st = K.window_forces(*args)
            f = f.to(home).view(3, cap, len(slabs), W)
            stats = stats + st.to(home)
            if len(slabs) == nsp:
                F = f
            else:
                if F is None:
                    F = gx.new_empty((3, cap, nsp, W))
                F[:, :, slabs] = f
        # margin reactions back to their owners: slab s takes slab s+1's
        # left margin and slab s-1's right margin
        own = _add_margins(F[..., M:M + C].clone(),
                           torch.roll(F[..., :M], -1, 2),
                           torch.roll(F[..., M + C:], 1, 2), M)
        gf = ghost_fold(own.reshape(3, cap, P), g.faces, maps.fold_shifts)
        return (gf, *_stencil_out(stats))

    kernel.window_args = window_args
    kernel.margin, kernel.chunk, kernel.window = M, C, W
    return kernel


# ---------------------------------------------------------------------------
# the slab-resident state's exchanges (parallel/slab_step.py)

# copies between slabs (and between a slab and the global-small state on
# mesh[0], held with slab 0) since the last reset_traffic(): their count
# and bytes
TRAFFIC = {"copies": 0, "bytes": 0}


def reset_traffic():
    for k in TRAFFIC:
        TRAFFIC[k] = 0


def send(t: torch.Tensor, dev) -> torch.Tensor:
    """A contiguous ``t`` copied onto ``dev`` by one copy call, whether or
    not ``dev`` is ``t``'s device (on one card a device-to-device memcpy,
    between cards a peer copy), counted in TRAFFIC."""
    out = torch.empty(t.shape, dtype=t.dtype, device=dev)
    out.copy_(t, non_blocking=True)
    TRAFFIC["copies"] += 1
    TRAFFIC["bytes"] += t.numel() * t.element_size()
    return out


def _index(a, dev, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


def _routes(src, dst, C, devs, s, own):
    """Of the global columns ``src`` whose images ``dst`` lie in slab s,
    by source slab t: ([(t, those columns in t's planes, on t's
    device)], their positions in ``src`` in that order); ``own`` keeps
    the ones whose source is slab s itself."""
    into = dst // C == s
    moves, order = [], []
    for t, dev in enumerate(devs):
        sel = np.nonzero(into & (src // C == t))[0]
        if sel.size and (own or t != s):
            moves.append((t, _index(src[sel] - t * C, dev)))
            order.append(sel)
    return moves, np.concatenate(order) if order else np.zeros(0, np.int64)


class SlabPlan:
    """What the slab-resident step exchanges on ``mesh`` (one
    ``torch.device`` per slab), from the maps: slab s owns the columns
    [s C, (s + 1) C) of every plane.

    ``halo``: ``kernels.kick_drift_halo`` with a slab's image map
    (``images``) writes the halo columns whose interior source lies in
    the slab itself (in slab columns) and, for each
    other slab its columns image into, a segment of its send buffer;
    each slab takes its other halo columns from those segments
    (``halo_pairs``: per slab, (source slab, segment start and end, the
    columns it lands in)).  ``windows``: each slab's [M | C | M] window
    from its own columns and its ring neighbours' M edge columns
    (shard_step.py:187-194), grouped by device as ``make_sharded_kernel``
    groups them.  ``forces``: one ``window_forces`` launch per device,
    the margins' reactions sent back to their owners in the reference's
    order (shard_step.py:201-206), the stats summed on ``mesh[0]`` in the
    groups' order, and the ghost fold z -> y -> x with each face's
    columns sent to the slab of the columns they image (the fold's
    shifts, 2,248 columns at 100k beads, reach past the margin).
    ``anchors`` / ``springs``: the extruder springs' 2E anchors gathered
    from their slabs onto ``mesh[0]``, one ``extruder_springs`` launch
    there on those anchors' rows, each anchor's row sent back and written
    once.  Every value is the whole-plane form's (the same operations on
    the same operands); only the sign of a zero sum can differ."""

    def __init__(self, system: System, maps, mesh):
        reason = shardable(system, maps, mesh)
        if reason:
            raise ValueError(f"slab-resident step unavailable: {reason}")
        self.mesh = tuple(torch.device(d) for d in mesh)
        nsp = self.nsp = len(self.mesh)
        self.n = system.n
        self.cap, P = maps.cap, maps.P
        self.chunk, self.margin, self.window = _geometry(maps, nsp)
        C = self.chunk
        self.strides = maps.strides
        self.Cn = StencilConsts(system, np.float32)
        dtype = getattr(torch, system.dtype)
        devs = self.mesh
        slab = np.arange(P) // C
        self.interior = [_index(maps.interior[s * C:(s + 1) * C], d,
                                torch.bool) for s, d in enumerate(devs)]
        # halo columns: each slab's image map, its local images and one
        # send segment per other slab its columns image into (in
        # halo-list order), and each slab's receipts by source slab
        hc, hs = maps.halo_cols.astype(np.int64), maps.halo_src.astype(
            np.int64)
        hsh = maps.halo_shift
        self.images = []
        self.halo_pairs = [[] for _ in devs]
        for s, d in enumerate(devs):
            loc = (slab[hc] == s) & (slab[hs] == s)
            sends, at = [], 0
            for t, dt in enumerate(devs):
                sel = np.nonzero((slab[hs] == s) & (slab[hc] == t))[0]
                if t == s or not sel.size:
                    continue
                sends.append((hs[sel] - s * C, hsh[sel]))
                n_sel = 3 * self.cap * sel.size
                self.halo_pairs[t].append(
                    (s, at, at + n_sel, _index(hc[sel] - t * C, dt)))
                at += n_sel
            self.images.append(ImageTensors.build(
                halo_images(C, hs[loc] - s * C, hc[loc] - s * C, hsh[loc],
                            sends), self.cap, dtype, d))
        # the ghost fold: per axis z, y, x the keep mask of each slab and,
        # per direction (lo, hi) and destination slab, the face columns
        # of each source slab and where they land
        faces = maps.faces
        self.fold = []
        for axis in (2, 1, 0):
            keep = (1.0 - faces[2 * axis].astype(np.float32)
                    - faces[2 * axis + 1].astype(np.float32))
            dirs = []
            for side in (0, 1):
                src = np.nonzero(faces[2 * axis + side])[0]
                dst = (src - maps.fold_shifts[axis][side]) % P
                per = []
                for s, d in enumerate(devs):
                    moves, order = _routes(src, dst, C, devs, s, own=True)
                    per.append((moves, _index(dst[order] - s * C, d)))
                dirs.append(per)
            self.fold.append((
                [torch.as_tensor(keep[s * C:(s + 1) * C], device=d)
                 for s, d in enumerate(devs)], dirs))
        # the windows' own interior masks, per device group
        _, ownint, groups = _windows(maps, devs)
        self.groups = [(dev, slabs, _index(ownint[slabs].reshape(-1), dev,
                                           torch.bool))
                       for dev, slabs in groups]

    def recv(self, t: torch.Tensor, src: int, dst: int):
        """Slab ``src``'s tensor ``t`` on slab ``dst``: a copy unless it is
        the same slab (slab 0 also holds the global-small state)."""
        if src == dst:
            return t
        return send(t.contiguous(), self.mesh[dst])

    def halo(self, gx, sends):
        """The remote halo columns of every slab's position planes ``gx``
        (a list, written in place) from the slabs' send buffers ``sends``
        (``kernels.kick_drift_halo`` with the slab's ``images``: each
        image's source value plus its shift): per pair of slabs, one copy
        of the source's segment and one ``index_copy_``."""
        cap = self.cap
        for s, pairs in enumerate(self.halo_pairs):
            for t, lo, hi, dst in pairs:
                seg = sends[t][lo:hi].view(3, cap, -1)
                gx[s].index_copy_(-1, dst, self.recv(seg, t, s))

    def windows(self, planes):
        """Per device group, its slabs' windows of ``planes`` (each slab's
        (..., C) plane) side by side: (..., S * W) on the group's
        device."""
        nsp, C, M = self.nsp, self.chunk, self.margin
        out = []
        for _, slabs, _ in self.groups:
            parts = []
            for s in slabs:
                left, right = (s - 1) % nsp, (s + 1) % nsp
                parts += [self.recv(planes[left][..., C - M:], left, s),
                          planes[s],
                          self.recv(planes[right][..., :M], right, s)]
            out.append(torch.cat(parts, -1))
        return out

    def window_ints(self, bid, hn, pid):
        """The groups' windows of the integer planes (they change only at
        rebuilds and LE events): [(bidw, hnw, pidw)]."""
        return list(zip(self.windows(bid), self.windows(hn),
                        self.windows(pid)))

    def forces(self, gx, wints, energy: bool):
        """The stencil over the slabs' position planes ``gx`` with the
        groups' integer windows ``wints``: (per slab a flat buffer of its
        force plane (3 cap C values, then one scratch value: ``plane``
        views it), energies (2,), ints (2,) = [flag bits, clamps]) on
        ``mesh[0]``, as ``make_sharded_kernel``'s kernel gives them for
        the whole planes."""
        cap, nsp, C, M, W = (self.cap, self.nsp, self.chunk, self.margin,
                             self.window)
        home = self.mesh[0]
        F = [None] * nsp
        stats = torch.zeros(5, dtype=gx[0].dtype, device=home)
        for (dev, slabs, own), xw, (bidw, hnw, pidw) in zip(
                self.groups, self.windows(gx), wints):
            f, st = K.window_forces(xw, bidw, hnw, pidw, own, self.Cn,
                                    self.n, W, self.strides, energy)
            f = f.view(3, cap, len(slabs), W)
            for j, s in enumerate(slabs):
                F[s] = f[:, :, j]
            stats = stats + self.recv(st, slabs[0], 0)
        # margin reactions back to their owners: slab s takes slab s+1's
        # left margin and slab s-1's right margin
        own = []
        for s in range(nsp):
            right, left = (s + 1) % nsp, (s - 1) % nsp
            own.append(_add_margins(
                F[s][..., M:M + C].clone(
                    memory_format=torch.contiguous_format),
                self.recv(F[right][..., :M], right, s),
                self.recv(F[left][..., M + C:], left, s), M))
        return (self._fold(own), *_stencil_out(stats))

    def plane(self, buf):
        """A slab's (3, cap, C) force plane in its flat buffer."""
        return buf[:-1].view(3, self.cap, self.chunk)

    def _fold(self, f):
        """``kernels_ref.ghost_fold`` over the slabs' planes ``f``: per axis
        f * keep, then each lo face's columns added where they image, then
        each hi face's (the whole form's (f * keep + lo) + hi).  The last
        axis writes into flat buffers with a scratch value."""
        cap, C = self.cap, self.chunk
        for k, (keep, dirs) in enumerate(self.fold):
            new = []
            for s, part in enumerate(f):
                if k == len(self.fold) - 1:
                    buf = torch.empty(3 * cap * C + 1, dtype=part.dtype,
                                      device=part.device)
                    torch.mul(part, keep[s], out=self.plane(buf))
                    new.append(buf)
                else:
                    new.append(part * keep[s])
            planes = [self.plane(b) for b in new] if k == len(
                self.fold) - 1 else new
            for per in dirs:
                for s, (moves, dst) in enumerate(per):
                    if not moves:
                        continue
                    vals = [self.recv(f[t].index_select(-1, src), t, s)
                            for t, src in moves]
                    vals = vals[0] if len(vals) == 1 else torch.cat(vals, -1)
                    planes[s].index_copy_(
                        -1, dst, planes[s].index_select(-1, dst) + vals)
            f = new
        return f

    def anchors(self, exl_slot, exr_slot, active):
        """The extruder springs' anchor maps for ``springs`` (they change
        at rebuilds and LE events): per slab the flat indices of its
        anchors' values in its planes (clamped where the anchor is not its)
        and in its force buffer (the scratch value where not), the masks
        of each slab's anchors on ``mesh[0]``, and the anchor pair of
        each spring in the gathered (3, 1, 2E) planes (2E, past them,
        where an anchor lies off the grid, as the whole kernel skips
        it)."""
        cap, C, P = self.cap, self.chunk, self.chunk * self.nsp
        capC, E = cap * C, exl_slot.shape[-1]
        home = exl_slot.device
        slots = torch.cat([exl_slot, exr_slot]).to(torch.int64)
        on = (slots >= 0) & (slots < cap * P)
        row, col = slots // P, slots % P
        local = row * C + col % C
        owner = col // C
        comp = torch.arange(3, device=home)[:, None] * capC
        ok = torch.cat([active, active]) & on
        maps = []
        for s, dev in enumerate(self.mesh):
            mine = ok & (owner == s)
            at = (comp + torch.where(mine, local, 0)).reshape(-1)
            dst = torch.where(mine, comp + local, 3 * capC).reshape(-1)
            maps.append((self.recv(at, 0, s), self.recv(dst, 0, s), mine))
        e = torch.arange(E, dtype=torch.int32, device=home)
        far = torch.full_like(e, 2 * E)
        pair = (torch.where(on[:E], e, far), torch.where(on[E:], e + E, far))
        return maps, pair

    def gather_anchors(self, gx, bufs, anchors):
        """The anchors' rows of the slabs' position planes ``gx`` and
        force buffers ``bufs`` on ``mesh[0]``: (xa, fa), (3, 1, 2E)
        planes whose column ``anchors``' pairs index."""
        maps, (left, _) = anchors
        E2 = left.shape[0] * 2
        xa = fa = None
        for s, (at, _, mine) in enumerate(maps):
            x = self.recv(gx[s].reshape(-1)[at], s, 0).view(3, E2)
            f = self.recv(bufs[s][at], s, 0).view(3, E2)
            if xa is None:
                xa, fa = x, f
            else:
                xa, fa = torch.where(mine, x, xa), torch.where(mine, f, fa)
        return xa.reshape(3, 1, E2), fa.reshape(3, 1, E2).contiguous()

    def springs(self, gx, bufs, anchors, active, S):
        """``kernels.extruder_springs`` on the anchors' rows gathered onto
        ``mesh[0]`` (``gather_anchors``), each anchor's new force row
        written back into its slab's buffer (once: a bead anchors at most
        one leg, and every other index lands on the scratch value).
        Returns the per-spring energies (E,) on ``mesh[0]``."""
        maps, (left, right) = anchors
        xa, fa = self.gather_anchors(gx, bufs, anchors)
        eb = K.extruder_springs(xa, fa, left, right, active, S)
        for s, (_, dst, _) in enumerate(maps):
            bufs[s].index_put_((dst,), self.recv(fa.reshape(-1), 0, s))
        return eb
