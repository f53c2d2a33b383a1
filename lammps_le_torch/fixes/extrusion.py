"""Loop-extrusion stepping (``lammps_le_tpu/fixes/extrusion.py``, the port of
``FixExtrusion::post_integrate``, fix_extrusion.cpp:256-872).

Each extruder [l, r] tries to widen to [l-1, r+1]; a side moves when its
target bead is chain-interior, unoccupied, and passes the barrier-type
gate (a CTCF barrier lets it through with probability ``through_prob``).
Two proposals for one bead: the shorter new bond wins (ties: lower
slot) and the loser stalls.  Draws come from ``rng`` and equal the
reference's bit for bit.
"""

from __future__ import annotations

import torch

from .. import rng
from ..ops.cells import minimum_image
from ..system import System
from .config import Extrusion


def _rsq(x, a, b, box):
    d = minimum_image(x[b] - x[a], box)
    return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]


def scatter_election(targets, rsq, n: int):
    """Two-pass scatter-min election (extrusion.py:40-59): per bead (plus
    one dropped entry) the lowest slot among the proposals with the
    smallest score.  ``targets``: list of (idx, mask) per proposal."""
    e = rsq.shape[0]
    dev = rsq.device
    big = torch.finfo(rsq.dtype).max
    best = torch.full((n + 1,), big, dtype=rsq.dtype, device=dev)
    for idx, mask in targets:
        safe = torch.where(mask, idx, n)
        best.scatter_reduce_(0, safe, torch.where(mask, rsq, big), "amin",
                             include_self=True)
    best_slot = torch.full((n + 1,), e + 1, dtype=torch.int64, device=dev)
    slots = torch.arange(e, dtype=torch.int64, device=dev)
    for idx, mask in targets:
        safe = torch.where(mask, idx, n)
        tied = mask & (rsq == best[safe])
        best_slot.scatter_reduce_(0, safe, torch.where(tied, slots, e + 1),
                                  "amin", include_self=True)
    return best_slot


def make_extrusion_update(system: System, fix: Extrusion, device="cuda"):
    """update(x, types, ex_left, ex_right, occ, key)
    -> (left, right, n_moves, n_released), its tables on ``device``."""
    n = system.n
    nxt = torch.as_tensor(system.next_bead, dtype=torch.int64, device=device)
    prv = torch.as_tensor(system.prev_bead, dtype=torch.int64, device=device)
    neutral = fix.neutral_type - 1
    c_left = fix.ctcf_left - 1
    c_right = fix.ctcf_right - 1
    c_both = fix.ctcf_left_right - 1 if fix.ctcf_left_right > 0 else -999
    through = fix.through_prob
    release_sq = fix.release_r * fix.release_r
    box = system.box_size

    def update(x, types, ex_left, ex_right, occ, key):
        e = ex_left.shape[0]
        active = ex_left >= 0
        l = torch.where(active, ex_left, 0)
        r = torch.where(active, ex_right, 0)
        nreleased = torch.zeros((), dtype=torch.int64, device=device)
        if release_sq > 0.0:
            wound = active & (_rsq(x, l, r, box) > release_sq)
            nreleased = wound.sum()
            ex_left = torch.where(wound, -1, ex_left)
            ex_right = torch.where(wound, -1, ex_right)
            active = active & ~wound
            l = torch.where(active, ex_left, 0)
            r = torch.where(active, ex_right, 0)

        lt = prv[l]
        rt = nxt[r]
        lt_ok = active & (lt >= 0)
        rt_ok = active & (rt >= 0)
        lt_s = torch.where(lt_ok, lt, 0)
        rt_s = torch.where(rt_ok, rt, 0)

        def bead_free(b, ok):
            return ok & (prv[b] >= 0) & (nxt[b] >= 0) & ~occ[b]

        tl = types[lt_s]
        tr = types[rt_s]

        def allowed(t):
            return ((t == neutral) | (t == c_left) | (t == c_right)
                    | (t == c_both))

        ku_l, ku_r = rng.split(key)
        u_l = rng.uniform(ku_l, e, device)
        u_r = rng.uniform(ku_r, e, device)
        pass_l = ~((tl == c_left) | (tl == c_both)) | (through > u_l)
        pass_r = ~((tr == c_right) | (tr == c_both)) | (through > u_r)

        left_ok = bead_free(lt_s, lt_ok) & allowed(tl) & pass_l
        right_ok = bead_free(rt_s, rt_ok) & allowed(tr) & pass_r
        nl = torch.where(left_ok, lt_s, l)
        nr = torch.where(right_ok, rt_s, r)
        moved = left_ok | right_ok

        rsq = _rsq(x, nl, nr, box).to(torch.float32)
        best_slot = scatter_election([(nl, left_ok), (nr, right_ok)], rsq, n)
        slots = torch.arange(e, dtype=torch.int64, device=device)
        win_l = ~left_ok | (best_slot[torch.where(left_ok, nl, n)] == slots)
        win_r = ~right_ok | (best_slot[torch.where(right_ok, nr, n)] == slots)
        win = moved & win_l & win_r
        return (torch.where(win, nl, ex_left), torch.where(win, nr, ex_right),
                win.sum(), nreleased)

    return update
