"""Wrappers of the Hopper kernels of the LE step (``csrc/step.cu``,
``csrc/blocked.cu``, ``csrc/tiled.cu``).

Each wrapper takes the tensors of the plain version in ``kernels_ref.py``
and returns the same results.  On CPU tensors it runs the plain version;
on CUDA tensors it checks device, dtype, shape and contiguity, allocates
its outputs with ``torch.empty``, launches the kernel on PyTorch's current
stream (building the library with nvcc at first use) and raises if the
launch is refused — there is no fallback.  ``LAUNCHES`` counts, per
wrapper, the calls that launched the kernel.

=====================  ==================================================
kick_drift_halo        pallas_step.py:731-751 (K2a)
stencil_forces         pallas_step.py:249-510, 753-774 (K1 / K2b)
extruder_springs       pallas_step.py:776-930 (K2c)
langevin_kick_monitor  pallas_step.py:932-1000 (K2d + K2e)
newton_half_forces     blocked_kernel.py:90 (K3), body K1
window_forces          parallel/shard_step.py:55 (K4), body K1
tiled_stencil_forces   pallas_kernel.py:59 (K5)
=====================  ==================================================
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.grid import _OFFSETS
from . import kernels_ref as ref

LAUNCHES = {"kick_drift_halo": 0, "stencil_forces": 0,
            "extruder_springs": 0, "langevin_kick_monitor": 0,
            "newton_half_forces": 0, "window_forces": 0,
            "tiled_stencil_forces": 0}

_LIBS = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class StencilArgs(ctypes.Structure):
    _fields_ = ([(k, _F) for k in (
        "lj1", "lj2", "lj3", "lj4", "cutsq", "offe", "floorsq", "inv_r0sq",
        "neg_kf", "sigf_sq", "wca_cutsq", "wca_floorsq", "f_wca", "e_wca",
        "epsf", "e_fene", "bond_reach_sq", "r0sq")]
        + [(k, _I) for k in ("has_bond", "wca_is_lj", "energy", "cap", "P",
                             "n")]
        + [("delta", _I * 27)])


class SpringArgs(ctypes.Structure):
    _fields_ = ([("box", _F * 3)]
                + [(k, _F) for k in (
                    "r0", "neg_2k", "k", "r0sq", "neg_k", "sig_sq",
                    "wca_floorsq", "wca_cutsq", "f_wca", "e_wca", "eps",
                    "e_fene")]
                + [(k, _I) for k in ("harmonic", "E", "cap", "P")])


class FoldArgs(ctypes.Structure):
    _fields_ = [("shift", (_I * 2) * 3)]


class LangevinArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_uint32) for k in ("k0", "k1", "base")]
                + [(k, _F) for k in ("gamma1", "gamma2", "kick", "dt",
                                     "bad_cut", "trig_cut")]
                + [(k, _I) for k in ("langevin", "cap", "P", "n", "group",
                                     "zero")]
                + [("inv_n", _F)])


def _lib(name="step"):
    """The built library ``name`` (``csrc/<name>.cu``), every entry
    point's argtypes set; the first call builds all of them."""
    global _LIBS
    if _LIBS is None:
        from ..csrc.build import build

        paths = build()
        lib = ctypes.CDLL(str(paths["step"]))
        lib.lle_blocks.argtypes = [ctypes.c_long]
        lib.lle_blocks.restype = _I
        lib.lle_kick_drift_halo.argtypes = (
            [_P] * 10 + [_I] * 4 + [_F, _F, _P])
        lib.lle_stencil_forces.argtypes = [_P] * 10 + [StencilArgs, _P]
        lib.lle_extruder_springs.argtypes = [_P] * 6 + [SpringArgs, _P]
        lib.lle_langevin_kick_monitor.argtypes = (
            [_P] * 12 + [LangevinArgs, _P])
        for fn in ("lle_kick_drift_halo", "lle_stencil_forces",
                   "lle_extruder_springs", "lle_langevin_kick_monitor"):
            getattr(lib, fn).restype = _I
        blk = ctypes.CDLL(str(paths["blocked"]))
        blk.lle_newton_max_cap.restype = _I
        blk.lle_newton_half_forces.argtypes = (
            [_P] * 12 + [StencilArgs, FoldArgs, _P])
        blk.lle_newton_half_forces.restype = _I
        blk.lle_window_forces.argtypes = (
            [_P] * 10 + [StencilArgs, _I, _I, _P])
        blk.lle_window_forces.restype = _I
        blk.lle_window_blocks.argtypes = [_I, _I]
        blk.lle_window_blocks.restype = _I
        tld = ctypes.CDLL(str(paths["tiled"]))
        tld.lle_tiled_max_cap.restype = _I
        tld.lle_tiled_blocks.argtypes = [_I]
        tld.lle_tiled_blocks.restype = _I
        tld.lle_tiled_stencil_forces.argtypes = [_P] * 10 + [StencilArgs,
                                                             _P]
        tld.lle_tiled_stencil_forces.restype = _I
        _LIBS = {"step": lib, "blocked": blk, "tiled": tld}
    return _LIBS[name]


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"lammps_le_torch kernels run on cpu or cuda, not "
                         f"{t.device}")
    return False


def _check(name, t, dtype, shape=None):
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} CUDA tensor, "
                         f"got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _planes(gx, bid):
    cap, P = bid.shape
    _check("gx", gx, torch.float32, (3, cap, P))
    _check("bid", bid, torch.int32, (cap, P))
    return cap, P


def kick_drift_halo(gx, gv, gf, bid, interior, halo_cols, halo_src,
                    halo_shift, n: int, kick: float, dt: float):
    """Half kick + drift of valid slots, then the halo columns refreshed
    from their interior sources.  Returns new (gx, gv)."""
    if _on_cpu(gx):
        return ref.kick_drift_halo(gx, gv, gf, bid, interior, halo_cols,
                                   halo_src, halo_shift, n, kick, dt)
    cap, P = _planes(gx, bid)
    H = halo_cols.shape[0]
    _check("gv", gv, torch.float32, gx.shape)
    _check("gf", gf, torch.float32, gx.shape)
    _check("interior", interior, torch.bool, (P,))
    _check("halo_cols", halo_cols, torch.int32, (H,))
    _check("halo_src", halo_src, torch.int32, (H,))
    _check("halo_shift", halo_shift, torch.float32, (3, H))
    gx_out = torch.empty_like(gx)
    gv_out = torch.empty_like(gv)
    err = _lib().lle_kick_drift_halo(
        _ptr(gx), _ptr(gv), _ptr(gf), _ptr(bid), _ptr(interior),
        _ptr(halo_cols), _ptr(halo_src), _ptr(halo_shift), _ptr(gx_out),
        _ptr(gv_out), cap, P, H, n, kick, dt, _stream())
    _raise("kick_drift_halo", err)
    LAUNCHES["kick_drift_halo"] += 1
    return gx_out, gv_out


def _stencil_args(C, n, strides, offsets, energy, cap, P):
    sx, sy, sz = strides
    deltas = [a * sx + b * sy + c * sz for (a, b, c) in offsets]
    return StencilArgs(
        C.lj1, C.lj2, C.lj3, C.lj4, C.cutsq, C.offe, C.floorsq, C.inv_r0sq,
        C.neg_kf, C.sigf_sq, C.wca_cutsq, C.wca_floorsq, C.f_wca, C.e_wca,
        C.epsf, C.e_fene, C.bond_reach_sq, C.r0sq, int(C.kf != 0.0),
        int(C.wca_is_lj), int(energy), cap, P, n,
        (_I * 27)(*deltas))  # unused slots stay 0


def _stencil_outputs(gx, nblk):
    """gf, per-block tally partials, energies (2,), ints (2,)."""
    dev = gx.device
    return (torch.empty_like(gx),
            torch.empty(2 * nblk, dtype=torch.float32, device=dev),
            torch.empty(3 * nblk, dtype=torch.int32, device=dev),
            torch.empty(2, dtype=torch.float32, device=dev),
            torch.empty(2, dtype=torch.int64, device=dev))


def _stencil_inputs(gx, bid, hn, pid, interior):
    cap, P = _planes(gx, bid)
    _check("hn", hn, torch.bool, (cap, P))
    _check("pid", pid, torch.int32, (cap, P))
    _check("interior", interior, torch.bool, (P,))
    return cap, P


def stencil_forces(gx, bid, hn, pid, interior, C, n: int, strides,
                   energy: bool):
    """27-offset LJ + FENE + exclusion forces.  Returns (gf, energies (2,)
    = [e_lj, e_b], ints (2,) int64 = [flag bits, clamp events])."""
    if _on_cpu(gx):
        return ref.stencil_forces(gx, bid, hn, pid, interior, C, n, strides,
                                  energy)
    cap, P = _stencil_inputs(gx, bid, hn, pid, interior)
    lib = _lib()
    gf, fpart, ipart, en, ints = _stencil_outputs(gx, lib.lle_blocks(cap * P))
    a = _stencil_args(C, n, strides, _OFFSETS, energy, cap, P)
    err = lib.lle_stencil_forces(
        _ptr(gx), _ptr(bid), _ptr(hn), _ptr(pid), _ptr(interior), _ptr(gf),
        _ptr(fpart), _ptr(ipart), _ptr(en), _ptr(ints), a, _stream())
    _raise("stencil_forces", err)
    LAUNCHES["stencil_forces"] += 1
    return gf, en, ints


def newton_half_forces(gx, bid, hn, pid, interior, faces, C, n: int,
                       strides, fold_shifts, energy: bool):
    """Newton-half LJ + FENE + exclusion forces with the ghost fold (the
    blocked kernel's function, kernels_ref.newton_half_forces).  Returns
    what ``stencil_forces`` returns.  Deterministic: no atomics."""
    if _on_cpu(gx):
        return ref.newton_half_forces(gx, bid, hn, pid, interior, faces, C,
                                      n, strides, fold_shifts, energy)
    cap, P = _stencil_inputs(gx, bid, hn, pid, interior)
    _check("faces", faces, torch.bool, (6, P))
    blk = _lib("blocked")
    if cap > blk.lle_newton_max_cap():
        raise ValueError(f"newton_half_forces: cell cap {cap} is past the "
                         f"{blk.lle_newton_max_cap()} rows the kernel is "
                         f"built for")
    gf, fpart, ipart, en, ints = _stencil_outputs(gx, _lib().lle_blocks(P))
    # own forces + 13 reaction buffers, then the fold's ping-pong planes
    work = torch.empty((len(ref.HALF_OFFSETS), 3, cap, P),
                       dtype=torch.float32, device=gx.device)
    a = _stencil_args(C, n, strides, ref.HALF_OFFSETS, energy, cap, P)
    f = FoldArgs()
    for axis, (lo, hi) in enumerate(fold_shifts):
        f.shift[axis][0], f.shift[axis][1] = lo, hi
    err = blk.lle_newton_half_forces(
        _ptr(gx), _ptr(bid), _ptr(hn), _ptr(pid), _ptr(interior),
        _ptr(faces), _ptr(work), _ptr(gf), _ptr(fpart), _ptr(ipart),
        _ptr(en), _ptr(ints), a, f, _stream())
    _raise("newton_half_forces", err)
    LAUNCHES["newton_half_forces"] += 1
    return gf, en, ints


def window_forces(xw, bidw, hnw, pidw, ownint, C, n: int, period: int,
                  strides, energy: bool):
    """The Newton-half offset loop over S margin-extended slab windows of
    ``period`` columns, laid side by side, in one launch (the sharded
    stencil's window call, kernels_ref.window_forces).  Returns (f (3,
    cap, S * period), stats (5,) = [e_lj, e_b, bond sightings, clamp
    events, interior links]).  Deterministic: no atomics."""
    if _on_cpu(xw):
        return ref.window_forces(xw, bidw, hnw, pidw, ownint, C, n, period,
                                 strides, energy)
    cap, Q = _stencil_inputs(xw, bidw, hnw, pidw, ownint)
    sx, sy, sz = strides
    if Q % period or sx + sy + sz >= period:
        raise ValueError(f"window_forces: {Q} columns are not windows of "
                         f"{period} wider than the margin {sx + sy + sz}")
    blk = _lib("blocked")
    if cap > blk.lle_newton_max_cap():
        raise ValueError(f"window_forces: cell cap {cap} is past the "
                         f"{blk.lle_newton_max_cap()} rows the kernel is "
                         f"built for")
    nblk = blk.lle_window_blocks(period, Q // period)
    dev = xw.device
    work = torch.empty((len(ref.HALF_OFFSETS), 3, cap, Q),
                       dtype=torch.float32, device=dev)
    f = torch.empty_like(xw)
    fpart = torch.empty(2 * nblk, dtype=torch.float32, device=dev)
    ipart = torch.empty(3 * nblk, dtype=torch.int32, device=dev)
    stats = torch.empty(5, dtype=torch.float32, device=dev)
    a = _stencil_args(C, n, strides, ref.HALF_OFFSETS, energy, cap, Q)
    err = blk.lle_window_forces(
        _ptr(xw), _ptr(bidw), _ptr(hnw), _ptr(pidw), _ptr(ownint),
        _ptr(work), _ptr(f), _ptr(fpart), _ptr(ipart), _ptr(stats), a,
        period, Q // period, _stream())
    _raise("window_forces", err)
    LAUNCHES["window_forces"] += 1
    return f, stats


def tiled_stencil_forces(gx, bid, hn, pid, interior, C, n: int, strides,
                         energy: bool):
    """The tiled full 27-offset stencil in K5's formulas
    (kernels_ref.tiled_stencil_forces).  Returns what ``stencil_forces``
    returns."""
    if _on_cpu(gx):
        return ref.tiled_stencil_forces(gx, bid, hn, pid, interior, C, n,
                                        strides, energy)
    cap, P = _stencil_inputs(gx, bid, hn, pid, interior)
    tld = _lib("tiled")
    if cap > tld.lle_tiled_max_cap():
        raise ValueError(f"tiled_stencil_forces: cell cap {cap} is past the "
                         f"{tld.lle_tiled_max_cap()} rows the kernel is "
                         f"built for")
    gf, fpart, ipart, en, ints = _stencil_outputs(gx,
                                                  tld.lle_tiled_blocks(P))
    a = _stencil_args(C, n, strides, _OFFSETS, energy, cap, P)
    err = tld.lle_tiled_stencil_forces(
        _ptr(gx), _ptr(bid), _ptr(hn), _ptr(pid), _ptr(interior), _ptr(gf),
        _ptr(fpart), _ptr(ipart), _ptr(en), _ptr(ints), a, _stream())
    _raise("tiled_stencil_forces", err)
    LAUNCHES["tiled_stencil_forces"] += 1
    return gf, en, ints


def extruder_springs(gx, gf, exl_slot, exr_slot, active, S):
    """Extruder spring forces added to ``gf`` in place.  Returns the
    per-spring energies (E,)."""
    if _on_cpu(gx):
        return ref.extruder_springs(gx, gf, exl_slot, exr_slot, active, S)
    cap, P = gx.shape[1:]
    E = exl_slot.shape[0]
    _check("gx", gx, torch.float32, (3, cap, P))
    _check("gf", gf, torch.float32, (3, cap, P))
    _check("exl_slot", exl_slot, torch.int32, (E,))
    _check("exr_slot", exr_slot, torch.int32, (E,))
    _check("active", active, torch.bool, (E,))
    eb = torch.empty(E, dtype=torch.float32, device=gx.device)
    a = SpringArgs(
        (_F * 3)(*S.box), S.r0, S.neg_2k, S.k, S.r0sq, S.neg_k, S.sig_sq,
        S.wca_floorsq, S.wca_cutsq, S.f_wca, S.e_wca, S.eps, S.e_fene,
        int(S.harmonic), E, cap, P)
    err = _lib().lle_extruder_springs(
        _ptr(gx), _ptr(gf), _ptr(exl_slot), _ptr(exr_slot), _ptr(active),
        _ptr(eb), a, _stream())
    _raise("extruder_springs", err)
    LAUNCHES["extruder_springs"] += 1
    return eb


def langevin_kick_monitor(gx, gx_ref, gv, gf, bid, interior, key_words,
                          sstep: int, gamma1: float, gamma2: float,
                          kick: float, dt: float, bad_cut: float,
                          trig_cut: float, n: int, langevin: bool,
                          lgm=None, zero: bool = False):
    """Langevin force over the group ``lgm`` ((cap, P) 0/1 plane, or None
    for all beads), with ``zero`` its random force's group mean
    subtracted first; the final half kick and skin monitor.  Returns (gf,
    gv, ints (2,) int64 = [skin flag bits, look-ahead trigger]).  With
    ``zero`` the kernel takes two passes over the planes; the reduction
    between them uses no atomics (bitwise the same run to run)."""
    if _on_cpu(gx):
        return ref.langevin_kick_monitor(
            gx, gx_ref, gv, gf, bid, interior, key_words, sstep, gamma1,
            gamma2, kick, dt, bad_cut, trig_cut, n, langevin, lgm, zero)
    cap, P = _planes(gx, bid)
    for name, t in (("gx_ref", gx_ref), ("gv", gv), ("gf", gf)):
        _check(name, t, torch.float32, gx.shape)
    _check("interior", interior, torch.bool, (P,))
    if lgm is not None:
        _check("lgm", lgm, torch.float32, (cap, P))
    lib = _lib()
    nblk = lib.lle_blocks(cap * P)
    gf_out = torch.empty_like(gf)
    gv_out = torch.empty_like(gv)
    part = torch.empty(3 * nblk, dtype=torch.float32, device=gx.device)
    zero = bool(zero and langevin)
    # the zero pass's block partials (4 a block) and the 3 group means
    zpart = (torch.empty(4 * nblk + 3, dtype=torch.float32,
                         device=gx.device) if zero else None)
    ints = torch.empty(2, dtype=torch.int64, device=gx.device)
    k0, k1 = key_words
    a = LangevinArgs(int(k0), int(k1), (int(sstep) * 4) & 0xFFFFFFFF,
                     gamma1, gamma2, kick, dt, bad_cut, trig_cut,
                     int(langevin), cap, P, n, int(lgm is not None),
                     int(zero), 1.0 / n)
    err = lib.lle_langevin_kick_monitor(
        _ptr(gx), _ptr(gx_ref), _ptr(gv), _ptr(gf), _ptr(bid),
        _ptr(interior), None if lgm is None else _ptr(lgm), _ptr(gf_out),
        _ptr(gv_out), _ptr(part), None if zpart is None else _ptr(zpart),
        _ptr(ints), a, _stream())
    _raise("langevin_kick_monitor", err)
    LAUNCHES["langevin_kick_monitor"] += 1
    return gf_out, gv_out, ints


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0

