"""Conservative forces of the loop-extrusion polymer, computed plainly.

* Shifted Lennard-Jones between every pair closer than the cutoff
  (``pair_style lj/cut`` + ``pair_modify shift yes``), except chain
  neighbours (``special_bonds fene``: 1-2 weight 0) and the two anchors of
  an extruder (a bonded pair once loaded).  As in the engine, the force
  is evaluated at no less than (0.75 sigma)^2.
* FENE on every chain bond (``bond_style fene``): -k r / (1 - (r/r0)^2),
  the log's argument clamped at 0.1 as LAMMPS does (bond_fene.cpp), plus
  the WCA repulsion below 2^(1/6) sigma.
* A harmonic spring, -2 k (r - r0) r-hat, between the anchors of each
  active extruder (``bond_style harmonic``).

Pairs come from a cell list with cells no smaller than the cutoff,
enumerated over the 14 cells of a half stencil so that each pair is seen
once, in blocks of beads so that a million beads fit.  Distances are
minimum images of unwrapped positions.  Plain PyTorch on any device, in
the float type of the positions.
"""

from __future__ import annotations

import itertools

import torch

HALF_OFFSETS = [(0, 0, 0)] + [o for o in itertools.product((-1, 0, 1),
                                                            repeat=3)
                              if o > (0, 0, 0)]
LJ_FLOOR = 0.5625  # (0.75 sigma)^2


def min_image(d: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    return d - box * torch.round(d / box)


def cell_list(x: torch.Tensor, lo: torch.Tensor, box: torch.Tensor,
              edge: float):
    """(cell coords (N, 3), dims (3,), order, start, count) of positions
    ``x`` binned into the box's grid of cells no smaller than ``edge``."""
    dims = torch.floor(box / edge).to(torch.int64)
    if bool((dims < 3).any()):
        raise ValueError(f"box {box.tolist()} holds fewer than 3 cells of "
                         f"{edge} a side")
    frac = (x - lo) / box
    frac = frac - torch.floor(frac)
    c3 = torch.minimum(torch.floor(frac * dims.to(x.dtype)).to(torch.int64),
                       dims - 1)
    cid = (c3[:, 0] * dims[1] + c3[:, 1]) * dims[2] + c3[:, 2]
    order = torch.argsort(cid)
    count = torch.bincount(cid, minlength=int(dims.prod()))
    start = torch.cumsum(count, 0) - count
    return c3, dims, order, start, count


def close_pairs(x: torch.Tensor, lo, box, cut: float, block: int = 1 << 18):
    """Every pair (i, j) closer than ``cut`` (minimum image), each once:
    yields (i, j, d = x_i - x_j, rsq) in blocks."""
    c3, dims, order, start, count = cell_list(x, lo, box, cut)
    n = x.shape[0]
    dev = x.device
    cutsq = cut * cut
    for b0 in range(0, n, block):
        rows = torch.arange(b0, min(n, b0 + block), device=dev)
        for off in HALF_OFFSETS:
            nc = torch.remainder(c3[rows] + torch.tensor(off, device=dev),
                                 dims)
            ncid = (nc[:, 0] * dims[1] + nc[:, 1]) * dims[2] + nc[:, 2]
            cnt = count[ncid]
            total = int(cnt.sum())
            if total == 0:
                continue
            i = torch.repeat_interleave(rows, cnt)
            first = torch.repeat_interleave(start[ncid], cnt)
            k = torch.arange(total, device=dev) - torch.repeat_interleave(
                torch.cumsum(cnt, 0) - cnt, cnt)
            j = order[first + k]
            if off == (0, 0, 0):
                keep = i < j
                i, j = i[keep], j[keep]
            d = min_image(x[i] - x[j], box)
            rsq = (d * d).sum(1)
            near = rsq < cutsq
            yield i[near], j[near], d[near], rsq[near]


def partner_table(ex_left, ex_right, n: int) -> torch.Tensor:
    """(N,) the extruder partner of each bead, or -1."""
    part = torch.full((n,), -1, dtype=torch.int64, device=ex_left.device)
    act = ex_left >= 0
    part[ex_left[act]] = ex_right[act]
    part[ex_right[act]] = ex_left[act]
    return part


def lj_factor(rsq, p):
    """The LJ force over r (force on i = d * factor) at max(rsq, floor)."""
    r2 = 1.0 / torch.clamp(rsq, min=LJ_FLOOR * p["sigma"] ** 2)
    s6 = (p["sigma"] ** 2 * r2) ** 3
    return 24.0 * p["epsilon"] * s6 * (2.0 * s6 - 1.0) * r2


def forces(x, next_bead, ex_left, ex_right, p, lo, box):
    """(N, 3) conservative forces and the number of FENE clamps.

    ``p``: ``epsilon``, ``sigma``, ``cutoff`` (LJ), ``fene`` (k, r0,
    epsilon, sigma), ``spring`` (k, r0); ``next_bead`` (N,) the chain
    neighbour (-1 at a chain end)."""
    n = x.shape[0]
    f = torch.zeros_like(x)
    part = partner_table(ex_left, ex_right, n)
    for i, j, d, rsq in close_pairs(x, lo, box, p["cutoff"]):
        keep = (next_bead[i] != j) & (next_bead[j] != i) & (part[i] != j)
        i, j, d, rsq = i[keep], j[keep], d[keep], rsq[keep]
        fij = d * lj_factor(rsq, p)[:, None]
        f.index_add_(0, i, fij)
        f.index_add_(0, j, -fij)

    k, r0, eps_b, sig_b = p["fene"]
    a = torch.nonzero(next_bead >= 0).flatten()
    b = next_bead[a]
    d = min_image(x[a] - x[b], box)
    rsq = (d * d).sum(1)
    rlog = 1.0 - rsq / (r0 * r0)
    clamps = int((rlog < 0.1).sum())
    fb = -k / torch.clamp(rlog, min=0.1)
    wca = rsq < 2.0 ** (1.0 / 3.0) * sig_b * sig_b
    fb = fb + torch.where(wca, lj_factor(rsq, {"epsilon": eps_b,
                                               "sigma": sig_b}),
                          torch.zeros_like(fb))
    fab = d * fb[:, None]
    f.index_add_(0, a, fab)
    f.index_add_(0, b, -fab)

    ks, rs0 = p["spring"]
    act = torch.nonzero(ex_left >= 0).flatten()
    if act.numel():
        a, b = ex_left[act], ex_right[act]
        d = min_image(x[a] - x[b], box)
        r = torch.sqrt(torch.clamp((d * d).sum(1), min=1e-12))
        fab = d * (-2.0 * ks * (r - rs0) / r)[:, None]
        f.index_add_(0, a, fab)
        f.index_add_(0, b, -fab)
    return f, clamps


def pair_count(x, lo, box, cut: float) -> int:
    """How many pairs lie closer than ``cut``: the problem's pair work,
    whatever grid an engine keeps them in."""
    return sum(int(i.numel()) for i, _, _, _ in close_pairs(x, lo, box, cut))
