"""Plain PyTorch versions of the four step kernels.

They follow the reference's XLA chain op for op (engine.make_kernel
engine.py:618-786, make_extruder_pass 838-899 and the reactive ``step``
1348-1455), with exact division, in any float type.  On CPU tensors the
wrappers in ``kernels.py`` run these; on the card ``chip_smoke.py`` holds
each CUDA kernel against them.
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
    one = torch.ones((), dtype=dtype, device=gx.device)
    u1 = torch.where(hn, bid + 1, n + 2)
    xi, yi, zi = X[:, None, :], Y[:, None, :], Z[:, None, :]
    bi, u1i, pi = bid[:, None, :], u1[:, None, :], pid[:, None, :]
    fx = torch.zeros((cap, P), dtype=dtype, device=gx.device)
    fy = torch.zeros_like(fx)
    fz = torch.zeros_like(fx)
    e_lj = zero
    e_b = zero
    nb_found = zero
    n_clamp = zero
    for (a, b, c) in _OFFSETS:
        delta = a * sx + b * sy + c * sz
        xj = _shift_minor(X, delta, _FAR)[None]
        yj = _shift_minor(Y, delta, _FAR)[None]
        zj = _shift_minor(Z, delta, _FAR)[None]
        bj = _shift_minor(bid, delta, n)[None]
        u1j = _shift_minor(u1, delta, n + 2)[None]
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
            rsq_den = torch.clamp(torch.where(pair_ok, rsq, one),
                                  min=C.floorsq)
            w12 = torch.where(pair_ok, int_i, zero)
        else:
            rsq_den = torch.where(
                bonded & nz_pair,
                torch.clamp(rsq, min=C.wca_floorsq),
                torch.clamp(torch.where(in_cut & nz_pair, rsq, one),
                            min=C.floorsq))
            w12 = torch.where(lj_ok, int_i, zero)
        r2 = 1.0 / rsq_den
        r6 = r2 * r2 * r2
        ffac = r6 * (C.lj1 * r6 - C.lj2) * r2 * w12
        if C.kf != 0.0:
            w_b = torch.where(w_b_m, int_i, zero)
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
            nb_found = nb_found + torch.sum(w_b)
            n_clamp = n_clamp + torch.sum(torch.where(cl, w_b, zero))
            if energy:
                eb = C.e_fene * torch.log(rlog) + torch.where(
                    wca, C.e_wca * sr6 * (sr6 - 1.0) + C.epsf, zero)
                e_b = e_b + 0.5 * torch.sum(eb * w_b)
        fx = fx + torch.sum(dx * ffac, dim=1)
        fy = fy + torch.sum(dy * ffac, dim=1)
        fz = fz + torch.sum(dz * ffac, dim=1)
        if energy:
            w_lj = torch.where(lj_ok, int_i, zero) if C.wca_is_lj else w12
            el = (r6 * (C.lj3 * r6 - C.lj4) - C.offe) * w_lj
            e_lj = e_lj + 0.5 * torch.sum(el)
    gf = torch.stack([fx, fy, fz])
    # each backbone bond is seen twice (both directions) by the full
    # stencil; fewer sightings than interior links = a bond out of reach
    n_links = torch.sum(valid_mask(bid, interior, n) & hn).to(dtype)
    reach = (0.5 * nb_found < n_links - 0.5).to(torch.int64)
    clamps = (0.5 * n_clamp).to(torch.int64)
    flags = reach * FLAG_BOND_REACH + (clamps > 0).to(torch.int64) \
        * FLAG_FENE_CLAMP
    return gf, torch.stack([e_lj, e_b]), torch.stack([flags, clamps])


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
