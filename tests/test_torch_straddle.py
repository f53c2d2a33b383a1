"""chip_smoke.straddle_explain, the check that holds the sharded stencil
of path 3 to the full one: a seeded pair across the periodic boundary is
put where the full and the Newton-half stencils' f32 squared distances
fall on opposite sides of the LJ cut, and the plain Newton-half stencil's
deviation from the plain full one there must be that pair's LJ force;
the check must refuse a deviation nudged by 1e-3 x max|f|."""

import numpy as np
import torch

import chip_smoke
import lammps_le_torch.fixes as tf
from lammps_le_torch.fast import kernels_ref as R
from lammps_le_torch.fast import to_fast
from lammps_le_torch.fast.consts import StencilConsts
from lammps_le_torch.fast.maps import fast_maps
from lammps_le_torch.fast.place import GridConsts
from lammps_le_torch.integrate import Simulation
from lammps_le_torch.ops.grid import _OFFSETS
from lammps_le_torch.state import state_from_arrays
from torch_parity import melt_arrays


def _rsq(a, b):
    d = a - b
    return d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def _planes():
    """melt32 translated by half the box, so that its bulk, where pairs
    lie at the cut, straddles the periodic faces."""
    system, d = melt_arrays()
    sim = Simulation(system=system, dt=0.005, ex_btype=2,
                     fixes=(tf.NVE(), tf.Langevin(1.0, 1.0, 1.0)))
    d = dict(d, x=d["x"] + np.float32(0.5) * np.asarray(
        system.box_size, np.float32))
    fs = to_fast(state_from_arrays(d, "cpu"), sim)
    maps = fast_maps(system)
    return (system, maps, GridConsts.build(system, maps, "cpu"),
            StencilConsts(system), fs)


def _cross_pairs(x, bid, valid, strides, n, cutsq):
    """(s, q) of the valid slots s and the ghost slots q they see at a
    backward offset, two beads not neighbours along the chain, nearest to
    the cut first."""
    cap, P = bid.shape
    sx, sy, sz = strides
    b_of, ok = bid.reshape(-1), valid.reshape(-1)
    cols = np.arange(P)
    out = []
    for o in _OFFSETS:
        if not o < (0, 0, 0):
            continue
        qc = (cols + o[0] * sx + o[1] * sy + o[2] * sz) % P
        s = np.arange(cap)[:, None, None] * P + cols[None, None, :]
        q = np.arange(cap)[None, :, None] * P + qc[None, None, :]
        s, q = np.broadcast_arrays(s, q)
        keep = ok[s] & (b_of[q] < n) & ~ok[q] \
            & (np.abs(b_of[s] - b_of[q]) > 1)
        out.append(np.stack([s[keep], q[keep]], 1))
    pairs = np.concatenate(out)
    gap = np.abs(_rsq(x[:, pairs[:, 0]], x[:, pairs[:, 1]]) - cutsq)
    return pairs[np.argsort(gap, kind="stable")]


def _view(s, b, bid, strides):
    """The slot holding bead b among the 27 cells of slot s."""
    cap, P = bid.shape
    sx, sy, sz = strides
    for o in _OFFSETS:
        col = (s % P + o[0] * sx + o[1] * sy + o[2] * sz) % P
        for r in range(cap):
            if bid[r, col] == b:
                return r * P + col
    raise AssertionError(f"bead {b} not seen from slot {s}")


def _straddling_position(x, s, q, sj, qj, box, cut):
    """A position of the bead at slot s, near its place, where its pair
    with the bead at sj straddles the cut: |x_b - x[q]|^2 and
    |x[sj] - (x_b + shift)|^2 in f32 on opposite sides of ``cut``, the
    second through the rounding of b's image; or None."""
    shift = np.float32(np.round((x[:, qj] - x[:, s]) / box) * box)
    u = (x[:, s] - x[:, q]).astype(np.float64)
    x0 = x[:, q] + u / np.linalg.norm(u) * np.sqrt(float(cut))
    for axis in np.flatnonzero(shift):
        # steps of an eighth of the image's ulp, so that its rounding
        # sweeps while the distance crosses the cut
        step = float(np.spacing(np.float32(x0[axis] + shift[axis]))) / 8
        for k in range(-512, 513):
            xb = x0.astype(np.float32)
            xb[axis] = np.float32(x0[axis] + k * step)
            if (_rsq(xb, x[:, q]) < cut) != (_rsq(x[:, sj], xb + shift)
                                             < cut):
                return xb, shift
    return None


def _straddled():
    """The planes with one bead moved (by at most a hundredth of the
    cut) so that its pair across the boundary straddles the cut:
    (system, maps, grid consts, stencil consts, FastState, gx), the
    bead's slot."""
    system, maps, g, C, fs = _planes()
    n, P = system.n, fs.bid.shape[1]
    bid = fs.bid.numpy()
    b_of = bid.reshape(-1)
    valid = R.valid_mask(fs.bid, g.interior, n).numpy()
    x = fs.gx.reshape(3, -1).numpy()
    cut = np.float32(C.cutsq)
    box = np.asarray(system.box_size, np.float32)
    for s, q in _cross_pairs(x, bid, valid, maps.strides, n, cut)[:50]:
        sj = int(np.flatnonzero(valid.reshape(-1) & (b_of == b_of[q]))[0])
        qj = _view(sj, b_of[s], bid, maps.strides)
        found = _straddling_position(x, s, q, sj, qj, box, cut)
        if found is not None:
            break
    else:
        raise AssertionError("no straddling position found")
    xb, shift = found
    assert float(np.abs(xb - x[:, s]).max()) < 1e-2 * np.sqrt(float(cut))
    gx = fs.gx.clone()
    gx[:, s // P, s % P] = torch.from_numpy(xb)
    zero = torch.zeros_like(gx)
    gx, _ = R.kick_drift_halo(gx, zero, zero, fs.bid, g.interior,
                              g.halo_cols, g.halo_src, g.halo_shift, n, 0.0,
                              0.0)
    assert torch.equal(gx.reshape(3, -1)[:, qj], torch.from_numpy(xb + shift))
    return (system, maps, g, C, fs, gx), int(s)


def test_straddle_explained_and_nudge_refused():
    (system, maps, g, C, fs, gx), s = _straddled()
    n = system.n
    args = (gx, fs.bid, fs.hn, fs.pid)
    full = R.stencil_forces(*args, g.interior, C, n, maps.strides, False)[0]
    half = R.newton_half_forces(*args, g.interior, g.faces, C, n,
                                maps.strides, maps.fold_shifts, False)[0]
    valid = R.valid_mask(fs.bid, g.interior, n)
    diff = (half.double() - full.double() * valid).numpy()
    fmax = max(float(full.abs().max()), 1.0)
    thr = chip_smoke.F_REL * fmax
    host = [t.numpy() for t in (gx, fs.bid, fs.hn, fs.pid, valid)]

    def explain(d):
        return chip_smoke.straddle_explain(*host, C, n, maps.strides, d, thr)

    beads, pairs, resid, left = explain(diff)
    dev = np.abs(diff.reshape(3, -1)).max(0)
    assert dev[s] > 10 * thr  # the pair's force is well past the threshold
    assert beads >= 1 and pairs >= 1 and not left, (beads, pairs, left)
    assert resid <= thr
    # one force nudged by 1e-3 max|f|: at the straddling bead, then at a
    # bead with no straddling pair
    cap, P = fs.bid.shape
    far = int(np.flatnonzero(valid.numpy().reshape(-1) & (dev < thr))[0])
    for slot in (s, far):
        nudged = diff.copy()
        nudged[0, slot // P, slot % P] += 1e-3 * fmax
        assert explain(nudged)[3], slot
