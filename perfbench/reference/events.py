"""The loop-extrusion events, written from the fixes' rules.

The fixes of the polly-code/lammps_le deck (``fix extrusion``, ``fix
ex_load``, ``fix ex_unload``) as the engine defines them, on bead arrays:

* extrusion: each active extruder [l, r] tries to widen to [l-1, r+1].  A
  side moves onto its target bead when the target is chain-interior,
  unoccupied and of an allowed type; a CTCF barrier facing it lets it
  pass with probability ``through_prob``.  Two proposals for one bead:
  the shorter new bond wins, ties to the lower table slot, and the loser
  does not move at all.  With ``release_r`` > 0 an extruder whose anchors
  lie farther apart than that is unloaded first.
* load: bead pairs (i, i+2) around a mid bead, all three chain-interior
  and unoccupied, of the fix's types, closer than ``cutoff``; candidates
  that share a bead go to the closest pair, ties to the lower mid bead;
  each winner is kept with probability ``fraction`` and takes the next
  free table slot in mid-bead order.
* unload: an extruder whose anchors lie farther apart than ``cutoff``
  breaks with probability ``fraction``.

Each event's draws come from its key, folded from the run key with the
step, the fix's kind and index, and the fix's seed (``threefry``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import threefry as tf
from .forces import min_image, partner_table

KIND = {"extrusion": 1, "ex_load": 2, "ex_unload": 3}
FLAG_EXTRUDER_OVERFLOW = 16


def f32(p: float) -> float:
    """A probability as the float32 that the draws are compared with."""
    return float(np.float32(p))


def event_key(key_words, step: int, kind: str, index: int, seed: int):
    return tf.fold_in(tf.fold_in(tf.fold_in(key_words, step),
                                 (KIND[kind] << 20) + index), seed)


def _rsq(x, a, b, box):
    d = min_image(x[a] - x[b], box)
    return (d * d).sum(1)


def _elect(proposals, rsq, slots, n: int):
    """For each bead, the slot of its winning proposal: the smallest
    ``rsq``, ties to the lowest slot.  ``proposals``: (bead, mask) per
    side; returns (n + 1,) with ``slots.max() + 1`` where none."""
    big = torch.finfo(rsq.dtype).max
    best = torch.full((n + 1,), big, dtype=rsq.dtype, device=rsq.device)
    for b, m in proposals:
        best.scatter_reduce_(0, torch.where(m, b, n),
                             torch.where(m, rsq, big), "amin")
    none = int(slots.max()) + 1 if slots.numel() else 0
    win = torch.full((n + 1,), none, dtype=torch.int64, device=rsq.device)
    for b, m in proposals:
        tb = torch.where(m, b, n)
        tied = m & (rsq == best[tb])
        win.scatter_reduce_(0, tb, torch.where(tied, slots, none), "amin")
    return win


def extrusion(st, fix, chain, box, key):
    left, right = st["ex_left"], st["ex_right"]
    x, types = st["x"], st["types"]
    prv, nxt = chain
    n = x.shape[0]
    e = left.shape[0]
    dev = x.device
    occ = partner_table(left, right, n) >= 0
    active = left >= 0
    released = 0
    if fix["release_r"] > 0.0:
        lsafe = torch.where(active, left, 0)
        rsafe = torch.where(active, right, 0)
        wound = active & (_rsq(x, lsafe, rsafe, box) > fix["release_r"] ** 2)
        released = int(wound.sum())
        left = torch.where(wound, -1, left)
        right = torch.where(wound, -1, right)
        active = active & ~wound
    l = torch.where(active, left, 0)
    r = torch.where(active, right, 0)
    tl_bead, tr_bead = prv[l], nxt[r]
    ok_l = active & (tl_bead >= 0)
    ok_r = active & (tr_bead >= 0)
    tl_bead = torch.where(ok_l, tl_bead, 0)
    tr_bead = torch.where(ok_r, tr_bead, 0)
    neutral = fix["neutral_type"] - 1
    c_left, c_right = fix["ctcf_left"] - 1, fix["ctcf_right"] - 1
    c_both = fix["ctcf_left_right"] - 1 if fix["ctcf_left_right"] > 0 \
        else -999
    k_l, k_r = tf.split(key)
    u_l = tf.uniform(k_l, e, dev)
    u_r = tf.uniform(k_r, e, dev)

    def side(target, ok, barrier, u):
        t = types[target]
        free = ok & (prv[target] >= 0) & (nxt[target] >= 0) & ~occ[target]
        allowed = (t == neutral) | (t == c_left) | (t == c_right) \
            | (t == c_both)
        passes = ~((t == barrier) | (t == c_both)) \
            | (f32(fix["through_prob"]) > u)
        return free & allowed & passes

    go_l = side(tl_bead, ok_l, c_left, u_l)
    go_r = side(tr_bead, ok_r, c_right, u_r)
    nl = torch.where(go_l, tl_bead, l)
    nr = torch.where(go_r, tr_bead, r)
    slots = torch.arange(e, device=dev)
    win = _elect([(nl, go_l), (nr, go_r)], _rsq(x, nl, nr, box), slots, n)
    keep_l = ~go_l | (win[torch.where(go_l, nl, n)] == slots)
    keep_r = ~go_r | (win[torch.where(go_r, nr, n)] == slots)
    moved = (go_l | go_r) & keep_l & keep_r
    st["ex_left"] = torch.where(moved, nl, left)
    st["ex_right"] = torch.where(moved, nr, right)
    st["n_moves"] += int(moved.sum())
    st["n_unloads"] += released


def ex_load(st, fix, chain, box, key):
    left, right = st["ex_left"], st["ex_right"]
    x, types = st["x"], st["types"]
    prv, nxt = chain
    n = x.shape[0]
    e = left.shape[0]
    dev = x.device
    occ = partner_table(left, right, n) >= 0
    mids = torch.arange(n, device=dev)
    has = (prv >= 0) & (nxt >= 0)
    i = torch.where(has, prv, 0)
    j = torch.where(has, nxt, 0)

    def degree(b):
        return (prv[b] >= 0).long() + (nxt[b] >= 0).long() + occ[b].long()

    ok = has & (degree(i) == 2) & (degree(mids) == 2) & (degree(j) == 2)
    it, jt = fix["iatomtype"] - 1, fix["jatomtype"] - 1
    imax, jmax = fix["imaxbond"], fix["jmaxbond"]
    oi, oj = occ[i].long(), occ[j].long()
    lim_ij = ((imax == 0) | (oi < imax)) & ((jmax == 0) | (oj < jmax))
    lim_ji = ((jmax == 0) | (oi < jmax)) & ((imax == 0) | (oj < imax))
    ti, tj = types[i], types[j]
    ok = ok & (((ti == it) & (tj == jt) & lim_ij)
               | ((ti == jt) & (tj == it) & lim_ji))
    rsq = _rsq(x, i, j, box)
    ok = ok & (rsq < fix["cutoff"] ** 2)
    win = _elect([(i, ok), (mids, ok), (j, ok)], rsq, mids, n)
    won = ok & (win[torch.where(ok, i, n)] == mids) \
        & (win[torch.where(ok, mids, n)] == mids) \
        & (win[torch.where(ok, j, n)] == mids)
    if fix["fraction"] < 1.0:
        won = won & (tf.uniform(key, n, dev) < f32(fix["fraction"]))
    free = torch.nonzero(left < 0).flatten()
    winners = torch.nonzero(won).flatten()
    taken = min(int(winners.numel()), int(free.numel()))
    winners = winners[:taken]
    left = left.clone()
    right = right.clone()
    left[free[:taken]] = i[winners]
    right[free[:taken]] = j[winners]
    new_types = types.clone()
    for b in (i[winners], j[winners]):
        if imax == 1 and fix["inewtype"] > 0:
            new_types[b[types[b] == it]] = fix["inewtype"] - 1
        if jmax == 1 and fix["jnewtype"] > 0 and jt != it:
            new_types[b[types[b] == jt]] = fix["jnewtype"] - 1
    st["ex_left"], st["ex_right"], st["types"] = left, right, new_types
    st["n_loads"] += taken
    if int(won.sum()) > int(free.numel()):
        st["flags"] |= FLAG_EXTRUDER_OVERFLOW


def ex_unload(st, fix, chain, box, key):
    left, right = st["ex_left"], st["ex_right"]
    e = left.shape[0]
    active = left >= 0
    l = torch.where(active, left, 0)
    r = torch.where(active, right, 0)
    go = active & (_rsq(st["x"], l, r, box) > fix["cutoff"] ** 2)
    if fix["fraction"] < 1.0:
        go = go & (tf.uniform(key, e, left.device) < f32(fix["fraction"]))
    st["ex_left"] = torch.where(go, -1, left)
    st["ex_right"] = torch.where(go, -1, right)
    st["n_unloads"] += int(go.sum())


APPLY = {"extrusion": extrusion, "ex_load": ex_load, "ex_unload": ex_unload}
