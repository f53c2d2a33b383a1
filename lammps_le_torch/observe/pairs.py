"""Host-side pair enumeration for diagnostic computes
(``lammps_le_tpu/observe/pairs.py``; host numpy, as the reference's: the
deck runner reads the State to the host, so the rows come out in the
reference's order, which ``dump local`` writes).

``compute pair/local`` and ``compute group/group`` need an explicit
in-cutoff pair list (reference: src/compute_pair_local.cpp,
src/compute_group_group.cpp).  The production engines never materialize
one — the hot path is a dense halo grid precisely because per-pair
gathers are slow on the accelerator — so this module builds the list
on demand in numpy.  Dump/diagnostic cadence only, never per-step.
"""

from __future__ import annotations

import numpy as np

from ..state import host


def enumerate_pairs(x, box, cutoff):
    """All i<j pairs with minimum-image distance < ``cutoff``.

    Cell-list construction (the host twin of npair_half_bin_newton.cpp's
    bin sweep): bins of >= cutoff, 27-offset cell pairing, vectorized
    over a padded (ncells, cap) occupancy table.  Returns
    ``(i, j, dist)`` — int64, int64, float64 — unsorted.
    """
    x = np.asarray(x, np.float64)
    box = np.asarray(box, np.float64)
    n = x.shape[0]
    nc = np.maximum((box / cutoff).astype(np.int64), 1)
    if np.prod(nc) <= 27:
        # degenerate small box: all-pairs
        return _all_pairs(x, box, cutoff)
    cw = box / nc
    xi = np.mod(x, box)
    ci = np.minimum((xi / cw).astype(np.int64), nc - 1)
    cid = (ci[:, 0] * nc[1] + ci[:, 1]) * nc[2] + ci[:, 2]
    ncells = int(np.prod(nc))
    counts = np.bincount(cid, minlength=ncells)
    cap = int(counts.max())
    # padded occupancy: slot[c, k] = k-th atom in cell c, -1 pad
    order = np.argsort(cid, kind="stable")
    starts = np.zeros(ncells + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    tab = np.full((ncells, cap), -1, np.int64)
    pos = np.arange(n) - starts[cid[order]]
    tab[cid[order], pos] = order

    cz = np.arange(ncells, dtype=np.int64)
    cx, rem = np.divmod(cz, nc[1] * nc[2])
    cy, czz = np.divmod(rem, nc[2])
    out_i, out_j, out_d = [], [], []
    cut2 = float(cutoff) ** 2
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                ox = (cx + dx) % nc[0]
                oy = (cy + dy) % nc[1]
                oz = (czz + dz) % nc[2]
                nb = (ox * nc[1] + oy) * nc[2] + oz
                a = tab                      # (C, cap) center atoms
                b = tab[nb]                  # (C, cap) neighbor atoms
                ii = a[:, :, None]           # (C, cap, 1)
                jj = b[:, None, :]           # (C, 1, cap)
                ok = (ii >= 0) & (jj >= 0) & (ii < jj)
                if not ok.any():
                    continue
                iw = np.broadcast_to(ii, ok.shape)[ok]
                jw = np.broadcast_to(jj, ok.shape)[ok]
                d = x[jw] - x[iw]
                d -= box * np.round(d / box)
                d2 = np.sum(d * d, axis=1)
                keep = d2 < cut2
                out_i.append(iw[keep])
                out_j.append(jw[keep])
                out_d.append(np.sqrt(d2[keep]))
    if not out_i:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float64)
    i = np.concatenate(out_i)
    j = np.concatenate(out_j)
    d = np.concatenate(out_d)
    # a pair whose cells are adjacent under more than one periodic
    # offset (small cell counts) appears once per offset: dedup
    key = i * n + j
    _, first = np.unique(key, return_index=True)
    return i[first], j[first], d[first]


def _all_pairs(x, box, cutoff):
    n = x.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    d = x[ju] - x[iu]
    d -= box * np.round(d / box)
    dist = np.sqrt(np.sum(d * d, axis=1))
    keep = dist < cutoff
    return iu[keep], ju[keep], dist[keep]


def special_weights(system, state, i, j):
    """Per-pair special_bonds lj weight (force.cpp:748-800 semantics):
    1-2 (bonded: implicit chain successor or a live extruder bond) ->
    special_lj[0]; 1-3/1-4 along the chain -> special_lj[1]/[2]."""
    w = np.ones(i.shape[0], np.float64)
    s12, s13, s14 = system.special_lj
    nxt = np.asarray(system.next_bead)
    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    chain1 = (hi == lo + 1) & chain_run(nxt, lo, 1)
    chain2 = (hi == lo + 2) & chain_run(nxt, lo, 2)
    chain3 = (hi == lo + 3) & chain_run(nxt, lo, 3)
    w[chain3] = s14
    w[chain2] = s13
    w[chain1] = s12
    if state is not None:
        exl = host(state.ex_left)
        exr = host(state.ex_right)
        live = exl >= 0
        if live.any():
            bl = np.minimum(exl[live], exr[live])
            br = np.maximum(exl[live], exr[live])
            key = set(zip(bl.tolist(), br.tolist()))
            pk = np.fromiter(
                ((int(a), int(b)) in key for a, b in zip(lo, hi)),
                bool, count=lo.shape[0])
            w[pk] = s12
    return w


def chain_run(nxt, lo, k):
    """True where beads lo..lo+k are one contiguous chain run."""
    n = nxt.shape[0]
    ok = np.ones(lo.shape[0], bool)
    for s in range(k):
        ls = np.minimum(lo + s, n - 1)
        ok &= (nxt[ls] == lo + s + 1)
    return ok


def lj_pair_values(system, types, i, j, dist):
    """(eng, force) of the lj/cut pair style for each listed pair —
    src/pair_lj_cut.cpp:68-141 single/compute forms, with the
    pair_modify shift convention.  ``force`` is the magnitude fpair*r
    (what compute pair/local's 'force' column reports: F dot rhat)."""
    eps = np.asarray(system.pair.epsilon, np.float64)
    sig = np.asarray(system.pair.sigma, np.float64)
    cut = np.asarray(system.pair.cutoff, np.float64)
    ti = types[i]
    tj = types[j]
    e = eps[ti, tj]
    s = sig[ti, tj]
    c = cut[ti, tj]
    inside = dist < c
    sr2 = np.where(inside, (s / np.maximum(dist, 1e-12)) ** 2, 0.0)
    sr6 = sr2 ** 3
    eng = 4.0 * e * sr6 * (sr6 - 1.0)
    if system.pair.shift:
        src6 = np.where(inside, (s / np.maximum(c, 1e-12)) ** 6, 0.0)
        eng = eng - 4.0 * e * src6 * (src6 - 1.0)
    frc = 24.0 * e * sr6 * (2.0 * sr6 - 1.0) / np.maximum(dist, 1e-12)
    return np.where(inside, eng, 0.0), np.where(inside, frc, 0.0)
