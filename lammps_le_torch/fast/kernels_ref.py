"""Plain PyTorch versions of the step kernels.

They follow the reference's XLA chain op for op (engine.make_kernel
engine.py:618-786, make_extruder_pass 838-899 and the reactive ``step``
1348-1455), the blocked Newton-half stencil (blocked_kernel.py:90), the
sharded slab stencil's window call (parallel/shard_step.py:55) and the
tiled full stencil (pallas_kernel.py:59), with exact division, in any
float type.  On CPU tensors the wrappers in ``kernels.py`` run these; on
the card ``chip_smoke.py`` holds each CUDA kernel against them.
"""

from __future__ import annotations

import torch

from ..ops.grid import _OFFSETS
from ..rng import uniform3
from ..state import (FLAG_BOND_REACH, FLAG_FENE_CLAMP,
                     FLAG_SKIN_VIOLATION)

_FAR = -1.0e4  # sentinel coordinate of empty slots (engine.py:72)


def valid_mask(bid: torch.Tensor, interior: torch.Tensor, n: int):
    """(cap, P) bool: a real bead in an interior (non-halo) column."""
    return (bid < n) & interior[None, :]


def kick_drift_halo(gx, gv, gf, bid, interior, halo_cols, halo_src,
                    halo_shift, n: int, kick: float, dt: float):
    """Half kick + drift of the valid slots (fix_nve.cpp:64-103), then the
    halo columns refreshed from their interior sources (forward_comm,
    comm_brick.cpp:452).  ``halo_shift`` is (3, H).  Returns (gx, gv)."""
    valid = valid_mask(bid, interior, n).to(gx.dtype)
    gv = gv + kick * gf * valid
    gx = gx + dt * gv * valid
    gx[:, :, halo_cols] = gx[:, :, halo_src] + halo_shift[:, None, :]
    return gx, gv


def _shift_minor(a, delta: int, fill):
    if delta == 0:
        return a
    pad = torch.full(a.shape[:-1] + (abs(delta),), fill, dtype=a.dtype,
                     device=a.device)
    if delta > 0:
        return torch.cat([a[..., delta:], pad], dim=-1)
    return torch.cat([pad, a[..., :delta]], dim=-1)


def _lj(C, rsq_den, w_f, w_e, energy: bool):
    """The LJ force factor weighted by ``w_f`` and, with ``energy``, the
    pair energy weighted by ``w_e``, at the evaluation distance
    ``rsq_den`` (pair_lj_cut.cpp:119-131).  Returns (r2, r6, ffac, el)."""
    r2 = 1.0 / rsq_den
    r6 = r2 * r2 * r2
    ffac = r6 * (C.lj1 * r6 - C.lj2) * r2 * w_f
    el = (r6 * (C.lj3 * r6 - C.lj4) - C.offe) * w_e if energy else None
    return r2, r6, ffac, el


def _pair_terms(C, i, j, w_i, energy: bool):
    """LJ + FENE + exclusion terms of broadcast (i, j) slot pairs
    (engine.make_kernel engine.py:683-756, make_offset_loop
    pallas_step.py:343-444).  ``i`` = (x, y, z, bid, u1, pid), ``j`` =
    (x, y, z, bid, u1); ``w_i`` is the i side's weight.

    Returns (dx, dy, dz, ffac, el, w_b, w_cl, eb): the force on i is
    ``d * ffac``; ``el`` the weighted LJ pair energies, ``w_b``/``w_cl``
    the weighted bond sightings / FENE clamps and ``eb`` the bond energies
    (to weigh by ``w_b``), each None where it does not apply."""
    xi, yi, zi, bi, u1i, pi = i
    xj, yj, zj, bj, u1j = j
    zero = torch.zeros((), dtype=xi.dtype, device=xi.device)
    one = torch.ones((), dtype=xi.dtype, device=xi.device)
    dx = xi - xj
    dy = yi - yj
    dz = zi - zj
    rsq = dx * dx + dy * dy + dz * dz
    nz_pair = rsq > 0.0
    bonded = (bj == u1i) | (bi == u1j)
    in_cut = rsq < C.cutsq
    if C.kf != 0.0:
        w_b_m = bonded & (rsq < C.bond_reach_sq)
    lj_ok = (in_cut & nz_pair) & (~bonded) & (bj != pi)
    if C.wca_is_lj:
        pair_ok = lj_ok | (w_b_m & (rsq < C.wca_cutsq))
        rsq_den = torch.clamp(torch.where(pair_ok, rsq, one), min=C.floorsq)
        w12 = torch.where(pair_ok, w_i, zero)
    else:
        rsq_den = torch.where(
            bonded & nz_pair,
            torch.clamp(rsq, min=C.wca_floorsq),
            torch.clamp(torch.where(in_cut & nz_pair, rsq, one),
                        min=C.floorsq))
        w12 = torch.where(lj_ok, w_i, zero)
    w_lj = torch.where(lj_ok, w_i, zero) if C.wca_is_lj else w12
    r2, r6, ffac, el = _lj(C, rsq_den, w12, w_lj, energy)
    w_b = w_cl = eb = None
    if C.kf != 0.0:
        w_b = torch.where(w_b_m, w_i, zero)
        rsq_b = torch.where(bonded, rsq, one)
        rlog = 1.0 - rsq_b * C.inv_r0sq
        cl = rlog < 0.1
        rlog = torch.clamp(rlog, min=0.1)
        fb = C.neg_kf / rlog
        sr2 = C.sigf_sq * r2
        sr6 = sr2 * sr2 * sr2
        wca = rsq_b < C.wca_cutsq
        if not C.wca_is_lj:
            fb = fb + torch.where(
                wca, C.f_wca * sr6 * (sr6 - 0.5) * r2, zero)
        ffac = ffac + fb * w_b
        w_cl = torch.where(cl, w_b, zero)
        if energy:
            eb = C.e_fene * torch.log(rlog) + torch.where(
                wca, C.e_wca * sr6 * (sr6 - 1.0) + C.epsf, zero)
    return dx, dy, dz, ffac, el, w_b, w_cl, eb


def _tallies(e_lj, e_b, nb_found, n_clamp, valid, hn):
    """Energies, flag bits and clamp count from the weighted pair sums
    (engine.py:759-783): every pair is counted twice (both sides, or
    weight 2), so energies and clamps are halved; fewer bond sightings
    than two per interior link = a bond out of the stencil's reach."""
    dtype = e_lj.dtype
    n_links = torch.sum(valid & hn).to(dtype)
    reach = (0.5 * nb_found < n_links - 0.5).to(torch.int64)
    clamps = (0.5 * n_clamp).to(torch.int64)
    flags = reach * FLAG_BOND_REACH + (clamps > 0).to(torch.int64) \
        * FLAG_FENE_CLAMP
    return (torch.stack([0.5 * e_lj, 0.5 * e_b]),
            torch.stack([flags, clamps]))


def stencil_forces(gx, bid, hn, pid, interior, C, n: int, strides,
                   energy: bool):
    """Full 27-offset LJ + FENE + exclusion stencil (engine.make_kernel).

    Returns (gf (3, cap, P), energies (2,) = [e_lj, e_b] (each pair seen
    from both sides, so halved), ints (2,) int64 = [flag bits, FENE clamp
    events])."""
    dtype = gx.dtype
    cap, P = bid.shape
    sx, sy, sz = strides
    X, Y, Z = gx[0], gx[1], gx[2]
    int_i = interior[None, None, :].to(dtype)
    zero = torch.zeros((), dtype=dtype, device=gx.device)
    u1 = torch.where(hn, bid + 1, n + 2)
    i = (X[:, None, :], Y[:, None, :], Z[:, None, :], bid[:, None, :],
         u1[:, None, :], pid[:, None, :])
    fx = torch.zeros((cap, P), dtype=dtype, device=gx.device)
    fy = torch.zeros_like(fx)
    fz = torch.zeros_like(fx)
    e_lj = e_b = nb_found = n_clamp = zero
    for (a, b, c) in _OFFSETS:
        delta = a * sx + b * sy + c * sz
        j = tuple(_shift_minor(p, delta, fill)[None] for p, fill in (
            (X, _FAR), (Y, _FAR), (Z, _FAR), (bid, n), (u1, n + 2)))
        dx, dy, dz, ffac, el, w_b, w_cl, eb = _pair_terms(C, i, j, int_i,
                                                          energy)
        if w_b is not None:
            nb_found = nb_found + torch.sum(w_b)
            n_clamp = n_clamp + torch.sum(w_cl)
            if energy:
                e_b = e_b + torch.sum(eb * w_b)
        fx = fx + torch.sum(dx * ffac, dim=1)
        fy = fy + torch.sum(dy * ffac, dim=1)
        fz = fz + torch.sum(dz * ffac, dim=1)
        if energy:
            e_lj = e_lj + torch.sum(el)
    en, ints = _tallies(e_lj, e_b, nb_found, n_clamp,
                        valid_mask(bid, interior, n), hn)
    return torch.stack([fx, fy, fz]), en, ints


# the self cell, then the 13 forward offsets o > (0, 0, 0)
# (blocked_kernel.py:108)
HALF_OFFSETS = [(0, 0, 0)] + [o for o in _OFFSETS if o > (0, 0, 0)]


def newton_half_forces(gx, bid, hn, pid, interior, faces, C, n: int,
                       strides, fold_shifts, energy: bool):
    """The Newton-half stencil of the blocked kernel (make_blocked_kernel
    blocked_kernel.py:90, body make_offset_loop pallas_step.py:300-510)
    over the whole grid, then the ghost fold.  ``faces`` (6, P) and
    ``fold_shifts`` are FastMaps' fold constants.

    Only valid slots (a bead in an interior column) act as i.  The self
    cell sees both pair orders at energy weight 1 with no reaction; each
    forward offset d sees a pair once, at weight 2, and subtracts its
    reaction from the j slot at column (c + d) mod P — circular over P, as
    the reference's rolls are.  The reactions that land on ghost columns
    then fold onto the interior cells they image, z -> y -> x
    (blocked_kernel.py:261-269, comm_brick.cpp:519 reverse_comm), leaving
    ghost columns zero.  Returns what ``stencil_forces`` returns."""
    valid = valid_mask(bid, interior, n)
    f, e_lj, e_b, nb_found, n_clamp = _half_offset_loop(
        gx, bid, hn, pid, valid, C, n, strides, energy,
        lambda p, s: torch.roll(p, s, -1))
    f = ghost_fold(f, faces, fold_shifts)
    en, ints = _tallies(e_lj, e_b, nb_found, n_clamp, valid, hn)
    return f, en, ints


def _half_offset_loop(gx, bid, hn, pid, valid, C, n: int, strides,
                      energy: bool, roll):
    """The Newton-half offset loop (make_offset_loop pallas_step.py:300-
    510) over planes whose column axis ``roll(p, s)`` rolls by ``s`` (the
    whole grid, or each window of a slab decomposition).  Only ``valid``
    slots act as i.  Returns (f, e_lj, e_b, nb_found, n_clamp): forces
    with the reactions subtracted in, and the weighted sums."""
    dtype = gx.dtype
    sx, sy, sz = strides
    X, Y, Z = gx[0], gx[1], gx[2]
    w_i = valid[:, None, :].to(dtype)
    zero = torch.zeros((), dtype=dtype, device=gx.device)
    u1 = torch.where(hn, bid + 1, n + 2)
    i = (X[:, None, :], Y[:, None, :], Z[:, None, :], bid[:, None, :],
         u1[:, None, :], pid[:, None, :])
    f = torch.zeros_like(gx)
    e_lj = e_b = nb_found = n_clamp = zero
    for (a, b, c) in HALF_OFFSETS:
        delta = a * sx + b * sy + c * sz
        wgt = 1.0 if delta == 0 else 2.0
        # j planes at column (c + delta) mod the period
        j = tuple(roll(p, -delta)[None] for p in (X, Y, Z, bid, u1))
        dx, dy, dz, ffac, el, w_b, w_cl, eb = _pair_terms(C, i, j, w_i,
                                                          energy)
        if w_b is not None:
            nb_found = nb_found + wgt * torch.sum(w_b)
            n_clamp = n_clamp + wgt * torch.sum(w_cl)
            if energy:
                e_b = e_b + wgt * torch.sum(eb * w_b)
        if energy:
            e_lj = e_lj + wgt * torch.sum(el)
        pair_f = torch.stack([dx * ffac, dy * ffac, dz * ffac])
        f = f + torch.sum(pair_f, dim=2)
        if delta:
            f = f - roll(torch.sum(pair_f, dim=1), delta)
    return f, e_lj, e_b, nb_found, n_clamp


def ghost_fold(f, faces, fold_shifts):
    """Reactions left on ghost columns folded onto the interior cells they
    image, z -> y -> x, as the reference's masked rolls
    (blocked_kernel.py:261-269, shard_step.py:229-237; comm_brick.cpp:519
    reverse_comm), leaving ghost columns zero.  ``faces`` (6, P) bool and
    ``fold_shifts`` are FastMaps' fold constants.  Besides the plain
    Newton-half stencil, the sharded stencil folds its assembled planes
    with it on every device: there the reference folds in XLA, outside
    its kernel, and the port in plain PyTorch."""
    P = f.shape[-1]
    faces = faces.to(f.dtype)
    for axis in (2, 1, 0):
        s_lo, s_hi = fold_shifts[axis]
        m_lo, m_hi = faces[2 * axis], faces[2 * axis + 1]
        keep = 1.0 - m_lo - m_hi
        f = (f * keep + torch.roll(f * m_lo, (P - s_lo) % P, -1)
             + torch.roll(f * m_hi, (P - s_hi) % P, -1))
    return f


def window_forces(xw, bidw, hnw, pidw, ownint, C, n: int, period: int,
                  strides, energy: bool):
    """The sharded stencil's window call (shard_step._window_call
    shard_step.py:55, K4; body make_offset_loop): the Newton-half offset
    loop over every slab's margin-extended window, with the reactions
    kept in the window and no ghost fold.

    The planes hold S windows of ``period`` columns side by side: ``xw``
    (3, cap, S * period), ``bidw``/``hnw``/``pidw`` (cap, S * period),
    ``ownint`` (S * period,) bool, each slab's own interior columns.  A
    slot acts as i where it holds a bead in an own interior column; the
    j column of offset d is (w + d) mod ``period`` in the same window
    (shard_step.py:152-158).  Returns (f (3, cap, S * period), stats (5,)
    = [e_lj, e_b, bond sightings, clamp events, interior links], summed
    over the windows, unhalved)."""
    S = xw.shape[-1] // period
    valid = valid_mask(bidw, ownint, n)

    def roll(p, s):
        shape = p.shape
        return torch.roll(p.reshape(shape[:-1] + (S, period)), s,
                          -1).reshape(shape)

    f, e_lj, e_b, nb_found, n_clamp = _half_offset_loop(
        xw, bidw, hnw, pidw, valid, C, n, strides, energy, roll)
    n_links = torch.sum(valid & hnw).to(xw.dtype)
    return f, torch.stack([e_lj, e_b, nb_found, n_clamp, n_links])


def tiled_stencil_forces(gx, bid, hn, pid, interior, C, n: int, strides,
                         energy: bool):
    """The tiled full 27-offset stencil (make_pallas_kernel
    pallas_kernel.py:94-263, K5), in its own formulas, which differ from
    ``stencil_forces``': the bonded test reads the has-next bits (the
    same boolean as the chain codes); the exclusion is bonded or partner;
    a bond needs rsq > 0 too; the bond's WCA is its own term at rsq
    floored to the WCA floor, never merged into the LJ chain, and the
    FENE log takes rsq / r0^2 by division.  The LJ force and energy terms
    are ``_lj``, shared with ``_pair_terms``.  The i weight is the column's
    interior bit; j columns outside [0, P) hold far-away empty slots (no
    wrap).  Forces accumulate per (i row, j row) over the offsets and are
    summed over the j rows at the end; tallies as ``stencil_forces``.
    Returns what ``stencil_forces`` returns (f32 only, as K5)."""
    dtype = gx.dtype
    cap, P = bid.shape
    sx, sy, sz = strides
    X, Y, Z = gx[0], gx[1], gx[2]
    w_i = interior[None, None, :].to(dtype)
    zero = torch.zeros((), dtype=dtype, device=gx.device)
    one = torch.ones((), dtype=dtype, device=gx.device)
    xi, yi, zi = X[:, None, :], Y[:, None, :], Z[:, None, :]
    bi, hi, pi = bid[:, None, :], hn[:, None, :], pid[:, None, :]
    fx = torch.zeros((cap, cap, P), dtype=dtype, device=gx.device)
    fy = torch.zeros_like(fx)
    fz = torch.zeros_like(fx)
    e_lj = e_b = nb_found = n_clamp = zero
    for (a, b, c) in _OFFSETS:
        delta = a * sx + b * sy + c * sz
        xj, yj, zj, bj, hj = (_shift_minor(p, delta, fill)[None] for p, fill
                              in ((X, _FAR), (Y, _FAR), (Z, _FAR), (bid, n),
                                  (hn, False)))
        dx = xi - xj
        dy = yi - yj
        dz = zi - zj
        rsq = dx * dx + dy * dy + dz * dz
        nz_pair = rsq > 0.0
        bonded = ((bj == bi + 1) & hi) | ((bi == bj + 1) & hj)
        in_cut = rsq < C.cutsq
        w_lj = torch.where(in_cut & nz_pair & ~(bonded | (bj == pi)), w_i,
                           zero)
        rsq_lj = torch.clamp(torch.where(in_cut & nz_pair, rsq, one),
                             min=C.floorsq)
        _, _, ffac, el = _lj(C, rsq_lj, w_lj, w_lj, energy)
        if energy:
            e_lj = e_lj + torch.sum(el)
        if C.kf != 0.0:
            bond = bonded & nz_pair & (rsq < C.bond_reach_sq)
            w_b = torch.where(bond, w_i, zero)
            rsq_b = torch.where(bond, rsq, one)
            rlog = 1.0 - rsq_b / C.r0sq
            cl = rlog < 0.1
            rlog = torch.where(cl, 0.1, rlog)
            fb = C.neg_kf / rlog
            rsq_w = torch.clamp(rsq_b, min=C.wca_floorsq)
            sr2 = C.sigf_sq / rsq_w
            sr6 = sr2 * sr2 * sr2
            wca = rsq_b < C.wca_cutsq
            fb = fb + torch.where(
                wca, C.f_wca * sr6 * (sr6 - 0.5) / rsq_w, zero)
            ffac = ffac + fb * w_b
            nb_found = nb_found + torch.sum(w_b)
            n_clamp = n_clamp + torch.sum(torch.where(cl, w_b, zero))
            if energy:
                e_b = e_b + torch.sum(w_b * (
                    C.e_fene * torch.log(rlog) + torch.where(
                        wca, C.e_wca * sr6 * (sr6 - 1.0) + C.epsf, zero)))
        fx = fx + dx * ffac
        fy = fy + dy * ffac
        fz = fz + dz * ffac
    gf = torch.stack([fx.sum(dim=1), fy.sum(dim=1), fz.sum(dim=1)])
    en, ints = _tallies(e_lj, e_b, nb_found, n_clamp,
                        valid_mask(bid, interior, n), hn)
    return gf, en, ints


def extruder_springs(gx, gf, exl_slot, exr_slot, active, S):
    """Extruder springs straight on the planes (make_extruder_pass):
    gather both anchors, minimum image, harmonic or FENE + WCA, and add
    +-force to the anchors' slots of ``gf`` IN PLACE.  Inactive springs
    and anchors outside the grid (overflowed beads, slot >= cap*P) are
    skipped.  Returns the per-spring energies (E,) (0 where skipped)."""
    dtype = gx.dtype
    capP = gx.shape[1] * gx.shape[2]
    sl = exl_slot.long()
    sr = exr_slot.long()
    ok = active & (sl < capP) & (sr < capP)
    sl = torch.where(ok, sl, 0)
    sr = torch.where(ok, sr, 0)
    flat = gx.reshape(3, capP)
    box = torch.tensor(S.box, dtype=dtype, device=gx.device)[:, None]
    d = flat[:, sl] - flat[:, sr]
    d = d - box * torch.round(d / box)
    rsq = torch.clamp(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], min=1e-12)
    zero = torch.zeros((), dtype=dtype, device=gx.device)
    if S.harmonic:
        r = torch.sqrt(rsq)
        dr = r - S.r0
        fb = S.neg_2k * dr / r
        eb = S.k * dr * dr
    else:
        rlog = torch.clamp(1.0 - rsq / S.r0sq, min=0.1)
        fb = S.neg_k / rlog
        rsq_w = torch.clamp(rsq, min=S.wca_floorsq)
        sr2 = S.sig_sq / rsq_w
        sr6 = sr2 * sr2 * sr2
        wca = rsq < S.wca_cutsq
        fb = fb + torch.where(wca, S.f_wca * sr6 * (sr6 - 0.5) / rsq_w, zero)
        eb = S.e_fene * torch.log(rlog) + torch.where(
            wca, S.e_wca * sr6 * (sr6 - 1.0) + S.eps, zero)
    am = ok.to(dtype)
    fvec = d * (fb * am)[None, :]
    gflat = gf.view(3, capP)
    gflat.index_add_(1, sl, fvec)
    gflat.index_add_(1, sr, -fvec)
    return eb * am


def langevin_noise(key_words, bid, sstep: int, dtype):
    """(3, cap, P) Langevin noise in [-0.5, 0.5) (engine.py:1421)."""
    return uniform3(key_words, bid, sstep, dtype) - 0.5


def langevin_kick_monitor(gx, gx_ref, gv, gf, bid, interior, key_words,
                          sstep: int, gamma1: float, gamma2: float,
                          kick: float, dt: float, bad_cut: float,
                          trig_cut: float, n: int, langevin: bool):
    """Langevin force (fix_langevin.cpp:654-674), the final half kick
    (fix_nve.cpp:108-140) and the skin monitor (engine.py:1308-1316,
    1448-1455).  ``gamma2`` already carries sqrt(T(t)).

    Returns (gf, gv, ints (2,) int64 = [flag bits, trig]): the skin bit
    is set when the two largest displacements since the rebuild sum past
    ``bad_cut`` (the pairwise coverage bound), ``trig`` when a bead's
    predicted next displacement |d| + dt*|v + kick*f| passes ``trig_cut``.
    """
    valid = valid_mask(bid, interior, n)
    vf = valid.to(gx.dtype)[None]
    if langevin:
        noise = langevin_noise(key_words, bid, sstep, gx.dtype)
        gf = gf + (gamma1 * gv + gamma2 * noise) * vf
    gv = gv + kick * gf * vf
    d = gx - gx_ref
    zero = torch.zeros((), dtype=gx.dtype, device=gx.device)
    dsq = torch.where(valid, d[0] * d[0] + d[1] * d[1] + d[2] * d[2], zero)
    m1 = torch.max(dsq)
    m2 = torch.max(torch.where(dsq == m1, zero, dsq))
    bad = torch.sqrt(m1) + torch.sqrt(m2) > bad_cut
    vn = gv + kick * gf
    vsq = torch.where(valid, vn[0] * vn[0] + vn[1] * vn[1] + vn[2] * vn[2],
                      zero)
    pred = torch.max(torch.sqrt(dsq) + dt * torch.sqrt(vsq))
    trig = pred > trig_cut
    ints = torch.stack([bad.to(torch.int64) * FLAG_SKIN_VIOLATION,
                        trig.to(torch.int64)])
    return gf, gv, ints
