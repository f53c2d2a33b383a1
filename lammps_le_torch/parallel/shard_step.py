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
    lane = np.arange(W)
    # global column of every window lane (shard_step.py:163)
    cols = (lane[None, :] + np.arange(nsp)[:, None] * C - M) % P
    in_own = (lane >= M) & (lane < M + C)
    ownint = in_own[None, :] & maps.interior[cols]
    groups = {}
    for s, dev in enumerate(mesh):
        groups.setdefault(dev, []).append(s)
    groups = list(groups.items())
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
        # left margin, then slab s-1's right margin (shard_step.py:201-206)
        own = F[..., M:M + C].clone()
        own[..., C - M:] += torch.roll(F[..., :M], -1, 2)
        own[..., :M] += torch.roll(F[..., M + C:M + C + M], 1, 2)
        gf = ghost_fold(own.reshape(3, cap, P), g.faces, maps.fold_shifts)
        # the stats summed over slabs (shard_step.py:238-254)
        clamps = (0.5 * stats[3]).to(torch.int64)
        reach = (0.5 * stats[2] < stats[4] - 0.5).to(torch.int64)
        flags = reach * FLAG_BOND_REACH + (clamps > 0).to(
            torch.int64) * FLAG_FENE_CLAMP
        return gf, 0.5 * stats[:2], torch.stack([flags, clamps])

    kernel.window_args = window_args
    kernel.margin, kernel.chunk, kernel.window = M, C, W
    return kernel
