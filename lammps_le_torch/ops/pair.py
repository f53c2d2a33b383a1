"""Lennard-Jones pair forces over the verlet list and by brute force
(``lammps_le_tpu.ops.pair``).

``pair_style lj/cut`` (pair_lj_cut.cpp:68-141): 12-6 LJ with per-type-pair
cutoff, optional energy shift, and ``special_bonds`` weights of bonded
pairs (force.cpp:748-800) evaluated at force time from the chain arrays
and the per-bead extruder partner, so extruder rewiring never needs a
neighbour rebuild.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..state import NeighborList
from ..system import System
from .cells import minimum_image, system_const

# LJ evaluation floor (pair.py:35): interactions closer than 0.75 sigma
# are evaluated at 0.75 sigma, identically in every path, so special pairs
# that the exclusion-free grid counts and the correction subtracts cancel
# exactly and never overflow.
_RSQ_FLOOR_FRAC = 0.5625  # (0.75 sigma)^2

NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _ipow(a, k: int):
    """``a ** k`` as ``lax.integer_pow`` computes it (binary
    exponentiation), so f32 tables round as the reference's do."""
    acc = None
    while k > 0:
        if k & 1:
            acc = a if acc is None else acc * a
        k >>= 1
        if k:
            a = a * a
    return acc


def lj_tables_host(system: System, np_dtype):
    """(lj1, lj2, lj3, lj4, cutsq, offset, floorsq) as (T, T) numpy
    arrays computed in ``np_dtype`` (pair.py:38)."""
    p = system.pair
    eps = np.asarray(p.epsilon, np_dtype)
    sig = np.asarray(p.sigma, np_dtype)
    cut = np.asarray(p.cutoff, np_dtype)
    sig6 = _ipow(sig, 6)
    lj1 = np_dtype(48.0) * eps * sig6 * sig6
    lj2 = np_dtype(24.0) * eps * sig6
    lj3 = np_dtype(4.0) * eps * sig6 * sig6
    lj4 = np_dtype(4.0) * eps * sig6
    if p.shift:
        rc6 = _ipow(cut, 6)
        offset = lj3 / (rc6 * rc6) - lj4 / rc6
    else:
        offset = np.zeros_like(eps)
    floorsq = np_dtype(_RSQ_FLOOR_FRAC) * sig * sig
    return lj1, lj2, lj3, lj4, _ipow(cut, 2), offset, floorsq


def _lj_tables(system: System, dtype, device):
    """The LJ tables as (T, T) tensors on ``device``, made once."""
    names = ("lj1", "lj2", "lj3", "lj4", "cutsq", "offset", "floorsq")
    return tuple(
        system_const(system, "lj_" + name,
                     lambda i=i: lj_tables_host(system, NP_DTYPE[dtype])[i],
                     dtype, device)
        for i, name in enumerate(names))


def _pair_terms(rsq, ti, tj, tables):
    """fpair (force/r) and pair energy for the type pairs; zero beyond the
    cutoff (pair.py:60)."""
    lj1, lj2, lj3, lj4, cutsq, offset, floorsq = tables
    r2inv = 1.0 / torch.maximum(rsq, floorsq[ti, tj])
    r6inv = r2inv * r2inv * r2inv
    inside = rsq < cutsq[ti, tj]
    fpair = r6inv * (lj1[ti, tj] * r6inv - lj2[ti, tj]) * r2inv
    e = r6inv * (lj3[ti, tj] * r6inv - lj4[ti, tj]) - offset[ti, tj]
    return torch.where(inside, fpair, 0.0), torch.where(inside, e, 0.0)


def chain_tables(system: System, device):
    """(next_bead, prev_bead) as int64 tensors on ``device``."""
    return (system_const(system, "next_bead", lambda: system.next_bead,
                         torch.int64, device),
            system_const(system, "prev_bead", lambda: system.prev_bead,
                         torch.int64, device))


def _special_factor(i, j, system: System, ex_partner, dtype):
    """special_bonds lj weight of the pairs (i, j) (pair.py:77): 1-2 for
    backbone neighbours and extruder partners (fix_extrusion.cpp:743-771),
    1-3 / 1-4 along the static backbone when their weights differ from 1."""
    s12, s13, s14 = system.special_lj
    nxt, prv = chain_tables(system, j.device)
    n = system.n
    pad = torch.full((1,), -1, dtype=torch.int64, device=j.device)

    def chain_hop(idx, table):
        safe = torch.where(idx >= 0, idx, n)
        return torch.cat([table, pad])[torch.clamp(safe, 0, n)]

    w = torch.ones(j.shape, dtype=dtype, device=j.device)
    is12 = (j == nxt[i]) | (j == prv[i])
    if ex_partner is not None:
        is12 = is12 | (j == ex_partner[i])
    w = torch.where(is12, s12, w)
    if s13 != 1.0:
        n2 = chain_hop(nxt[i], nxt)
        p2 = chain_hop(prv[i], prv)
        w = torch.where((j == n2) | (j == p2), s13, w)
        if s14 != 1.0:
            n3 = chain_hop(n2, nxt)
            p3 = chain_hop(p2, prv)
            w = torch.where((j == n3) | (j == p3), s14, w)
    return w


def lj_force_nbr(x: torch.Tensor, types: torch.Tensor, nbr: NeighborList,
                 system: System, ex_partner: Optional[torch.Tensor] = None):
    """Forces and total pair energy from the full verlet list (pair.py
    :110): each pair evaluated from both rows, a per-row reduction, the
    energy halved."""
    n = system.n
    dtype = x.dtype
    dev = x.device
    tables = _lj_tables(system, dtype, dev)
    idx = nbr.idx
    xp = torch.cat([x, x.new_zeros((1, 3))])
    tp = torch.cat([types, types.new_zeros(1)])
    d = minimum_image(xp[idx] - x[:, None, :], system.box_size)
    rsq = torch.sum(d * d, dim=-1)
    rows = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    pad = idx == n
    rsq = torch.where(pad, 1e30, rsq)
    fpair, e = _pair_terms(rsq, types[:, None], tp[idx], tables)
    w = _special_factor(rows, idx, system, ex_partner, dtype)
    w = torch.where(pad, 0.0, w)
    fpair = fpair * w
    e = e * w
    f = -torch.sum(d * fpair[..., None], dim=1)
    return f, 0.5 * torch.sum(e)


def lj_force_bruteforce(x: torch.Tensor, types: torch.Tensor,
                        system: System,
                        ex_partner: Optional[torch.Tensor] = None):
    """O(N^2) path for tests and tiny boxes (pair.py:147)."""
    n = system.n
    dtype = x.dtype
    dev = x.device
    tables = _lj_tables(system, dtype, dev)
    d = minimum_image(x[None, :, :] - x[:, None, :], system.box_size)
    rsq = torch.sum(d * d, dim=-1)
    i = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    j = torch.arange(n, dtype=torch.int64, device=dev).expand(n, n)
    # the self pair stays out of the arithmetic (inf * 0 is nan in f32)
    rsq = torch.where(j == i, 1e30, rsq)
    fpair, e = _pair_terms(rsq, types[:, None], types[None, :], tables)
    w = _special_factor(i, j, system, ex_partner, dtype)
    w = torch.where(j == i, 0.0, w)
    fpair = fpair * w
    e = e * w
    f = -torch.sum(d * fpair[..., None], dim=1)
    return f, 0.5 * torch.sum(e)
