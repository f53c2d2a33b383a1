"""Wrappers of the Hopper kernels of the LE step (``csrc/step.cu``,
``csrc/blocked.cu``, ``csrc/tiled.cu``).

Each wrapper takes the tensors of the plain version in ``kernels_ref.py``
and returns the same results.  On CPU tensors it runs the plain version;
on CUDA tensors it checks device, dtype, shape and contiguity, allocates
its outputs with ``torch.empty`` (the Langevin kernel's small zeroed
scratch is kept per stream), launches the kernel on its first tensor's
device, on PyTorch's current stream there (building the library with
nvcc at first use; a host with several cards runs slabs and replicas on
each), and raises if the launch is refused — there is no fallback.  ``LAUNCHES`` counts, per
wrapper, the calls that launched the kernel.

=====================  ==================================================
kick_drift_halo        pallas_step.py:731-751 (K2a)
stencil_forces         pallas_step.py:249-510, 753-774 (K1 / K2b)
extruder_springs       pallas_step.py:776-930 (K2c)
langevin_kick_monitor  pallas_step.py:932-1000 (K2d + K2e)
langevin_sums          the same, split at zero's means: the sums pass
langevin_kick_parts    and the main pass, for one slab of the slab step
StepLoop               pallas_step.py:554, 725-1022 (K2's step loop)
newton_half_forces     blocked_kernel.py:90 (K3), body K1
window_forces          parallel/shard_step.py:55 (K4), body K1
tiled_stencil_forces   pallas_kernel.py:59 (K5), body K1
=====================  ==================================================

Replicas: ``kick_drift_halo``, ``stencil_forces``, ``newton_half_forces``,
``extruder_springs`` and ``langevin_kick_monitor`` also take R runs'
tensors stacked on a leading axis (planes (R, 3, cap, P) and (R, cap, P),
anchor slots (R, E), Langevin key words an (R, 2) int32 tensor of their
bits) and return their outputs with that axis ((R, 2) energies and ints),
in one launch of each kernel for all R (each counted once): replica r is
bitwise the call on its own tensors.  The unbatched call is the same
launch at R = 1.  The other kernels take one run.

``langevin_sums`` and ``langevin_kick_parts`` are ``langevin_kick_monitor``
split where ``zero`` needs the whole group's sums (the slab step,
``parallel/slab_step.py``, launches them per slab): the first returns a
slab's four unscaled sums, the second takes the means the step makes of
every slab's and returns, in place of the flag bits and trigger, the
three values they are taken from, which the step merges over its slabs
(``slab_step.merge_monitor``).

``StepLoop`` launches the step kernels' launch-controlled forms over up to
LAUNCH_MAX steps as one launch of a CUDA graph whose WHILE conditional
node runs a step an iteration until the trigger or the limit ends it;
its count ``step_loop`` counts launches, and each step kernel's count
grows by the steps it executed (the springs run inside the stencil's
fold launch there, and count as ``extruder_springs``).

The pair stencils share one block body (``csrc/stencil.cuh``); all but
``tiled_stencil_forces`` (``stencil_forces``, ``newton_half_forces``,
``window_forces``, and the step loop's stencil) take their reciprocals
approximately (``rcp.approx`` plus one Newton step), as the reference does
on hardware, when ``APPROX_RCP`` is true at the call (at the step loop's
first launch for the loop): the default, unless the environment sets
``LLE_APPROX_RCP=0`` (the reference's switch, pallas_step.py:128), read
once at import.  With it false they divide exactly, and every per-pair
value is the plain version's bit for bit.  ``tiled_stencil_forces``
divides exactly, as its reference (pallas_kernel.py) does.
"""

from __future__ import annotations

import ctypes
import functools
import os
import weakref

import torch

from ..ops.grid import _OFFSETS
from . import kernels_ref as ref

LAUNCHES = {"kick_drift_halo": 0, "stencil_forces": 0,
            "extruder_springs": 0, "langevin_kick_monitor": 0,
            "step_loop": 0, "newton_half_forces": 0, "window_forces": 0,
            "tiled_stencil_forces": 0, "langevin_sums": 0,
            "langevin_kick_parts": 0}

APPROX_RCP = os.environ.get("LLE_APPROX_RCP", "1") == "1"

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
                             "n", "approx")]
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
                + [("inv_n", _F), ("keys", _P)])


class StepPlanes(ctypes.Structure):
    _fields_ = ([(k, _P) for k in (
        "gx", "gv", "gf", "gxr", "bid", "hn", "pid", "interior", "own",
        "img_ptr", "img_idx", "img_src", "img_shift", "exl", "exr",
        "active", "eb", "lgm", "fpart", "ipart", "lpart", "zpart", "ctl")]
        + [("I", _I), ("kick", _F), ("dt", _F)])


def _lib(name="step"):
    """The built library ``name`` (``csrc/<name>.cu``), every entry
    point's argtypes set; the first call builds all of them."""
    global _LIBS
    if _LIBS is None:
        from ..csrc.build import build

        _LIBS = bind(build())
    return _LIBS[name]


def bind(paths):
    """The step, blocked and tiled libraries at ``paths`` ({name: path},
    as csrc.build.build returns them) loaded, every entry point's argtypes
    set: {name: ctypes.CDLL}."""
    lib = ctypes.CDLL(str(paths["step"]))
    lib.lle_blocks.argtypes = [ctypes.c_long]
    lib.lle_blocks.restype = _I
    lib.lle_stencil_blocks.argtypes = [_I]
    lib.lle_stencil_blocks.restype = _I
    lib.lle_stencil_max_cap.restype = _I
    lib.lle_kick_drift_halo.argtypes = (
        [_P] * 13 + [_I] * 4 + [_F, _F, _I, _P])
    lib.lle_kick_drift_shape.argtypes = [_I] * 3 + [ctypes.POINTER(_I)]
    lib.lle_kick_drift_floor.argtypes = [_I] * 3 + [_P]
    lib.lle_stencil_forces.argtypes = [_P] * 10 + [StencilArgs, _I, _P]
    lib.lle_extruder_springs.argtypes = [_P] * 6 + [SpringArgs, _I, _P]
    lib.lle_langevin_kick_monitor.argtypes = (
        [_P] * 12 + [LangevinArgs, _I, _P])
    lib.lle_langevin_sums.argtypes = [_P] * 5 + [LangevinArgs, _P]
    lib.lle_langevin_kick_parts.argtypes = [_P] * 12 + [LangevinArgs, _P]
    _U = ctypes.c_uint32
    lib.lle_launch_begin.argtypes = [_P, _U, _U, _U, _I, _I, _F, _F, _P]
    lib.lle_step_ctl.argtypes = [StepPlanes, StencilArgs, SpringArgs,
                                 LangevinArgs, _P]
    for fn in ("lle_kick_drift_halo", "lle_kick_drift_shape",
               "lle_kick_drift_floor", "lle_stencil_forces",
               "lle_extruder_springs", "lle_langevin_kick_monitor",
               "lle_langevin_sums", "lle_langevin_kick_parts",
               "lle_launch_begin", "lle_step_ctl", "lle_ctl_words",
               "lle_ctl_stats"):
        getattr(lib, fn).restype = _I
    # the step loop's graph (a library built before it, which chip_ab.py
    # binds for its other kernels, has none)
    if hasattr(lib, "lle_loop_create"):
        lib.lle_loop_create.argtypes = [StepPlanes, StencilArgs, SpringArgs,
                                        LangevinArgs, ctypes.POINTER(_P)]
        lib.lle_loop_launch.argtypes = [_P, _P]
        lib.lle_loop_nodes.argtypes = [_P, ctypes.POINTER(_I),
                                       ctypes.POINTER(_I)]
        lib.lle_loop_destroy.argtypes = [_P]
        lib.lle_loop_destroy.restype = None
        for fn in ("lle_loop_create", "lle_loop_launch", "lle_loop_nodes",
                   "lle_ctl_iters"):
            getattr(lib, fn).restype = _I
    blk = ctypes.CDLL(str(paths["blocked"]))
    blk.lle_stencil_max_cap.restype = _I
    blk.lle_newton_half_forces.argtypes = (
        [_P] * 13 + [StencilArgs, FoldArgs, _I, _P])
    blk.lle_newton_half_forces.restype = _I
    blk.lle_window_forces.argtypes = (
        [_P] * 9 + [StencilArgs, _I, _I, _P])
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
    return {"step": lib, "blocked": blk, "tiled": tld}


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"lammps_le_torch kernels run on cpu or cuda, not "
                         f"{t.device}")
    return False


def _on_device(fn):
    """A wrapper run with its first tensor's device current (PyTorch's
    device guard): the launch and ``_stream()`` are that device's."""
    @functools.wraps(fn)
    def call(t, *args, **kw):
        if t.device.type != "cuda":
            return fn(t, *args, **kw)
        with torch.cuda.device(t.device):
            return fn(t, *args, **kw)

    return call


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


def _planes(gx, bid, batch=False):
    """(lead, cap, P) of checked planes: ``lead`` () for one run's
    (3, cap, P) and (cap, P) planes, or (R,) for R replicas' stacked on a
    leading axis where the kernel takes them (``batch``)."""
    lead = tuple(bid.shape[:-2])
    if len(lead) > int(batch) or bid.dim() < 2:
        raise ValueError(f"planes of shape {tuple(bid.shape)}: want (cap, P)"
                         + (" or (R, cap, P)" if batch else ""))
    cap, P = bid.shape[-2:]
    _check("gx", gx, torch.float32, lead + (3, cap, P))
    _check("bid", bid, torch.int32, lead + (cap, P))
    return lead, cap, P


def _reps(lead):
    """The replicas of a launch: R, or 1 for one run's planes."""
    return lead[0] if lead else 1


@_on_device
def kick_drift_halo(gx, gv, gf, bid, interior, halo_cols, halo_src,
                    halo_shift, n: int, kick: float, dt: float,
                    images=None):
    """Half kick + drift of valid slots, then the halo columns refreshed
    from their interior sources.  Returns new (gx, gv), and the send
    buffer where ``images`` sends (``kernels_ref.kick_drift_halo``).

    On the card the kernel writes each halo copy from its source's thread
    by the image map ``images`` (``place.ImageTensors``: ``GridConsts
    .images``, a slab's ``SlabPlan.images``), which it needs; it does not
    read the halo lists, which the plain version takes."""
    if _on_cpu(gx):
        return ref.kick_drift_halo(gx, gv, gf, bid, interior, halo_cols,
                                   halo_src, halo_shift, n, kick, dt, images)
    if images is None:
        raise ValueError("kick_drift_halo: the kernel writes the halo from "
                         "the image map: pass images=")
    lead, cap, P = _planes(gx, bid, batch=True)
    _check("gv", gv, torch.float32, gx.shape)
    _check("gf", gf, torch.float32, gx.shape)
    _check("interior", interior, torch.bool, (P,))
    I = _check_images(images, cap, P)
    if images.sizes and lead:
        raise ValueError("kick_drift_halo: sent images take one run's "
                         "planes")
    gx_out = torch.empty_like(gx)
    gv_out = torch.empty_like(gv)
    send = (torch.empty(3 * cap * images.n_send, dtype=torch.float32,
                        device=gx.device) if images.sizes else None)
    err = _lib().lle_kick_drift_halo(
        _ptr(gx), _ptr(gv), _ptr(gf), _ptr(bid), _ptr(interior),
        _ptr(images.own), _ptr(images.ptr), _ptr(images.idx),
        _ptr(images.src), _ptr(images.shift), _ptr(gx_out), _ptr(gv_out),
        None if send is None else _ptr(send), cap, P, I, n, kick, dt,
        _reps(lead), _stream())
    _raise("kick_drift_halo", err)
    LAUNCHES["kick_drift_halo"] += 1
    return (gx_out, gv_out) if send is None else (gx_out, gv_out, send)


def _check_images(images, cap, P):
    """The image map's tensors checked for (3, cap, P) planes: I."""
    I = images.idx.shape[0]
    if (images.cap, images.P) != (cap, P):
        raise ValueError(f"kick_drift_halo: an image map of (cap, P) "
                         f"{(images.cap, images.P)} for planes of "
                         f"{(cap, P)}")
    _check("images.own", images.own, torch.bool, (P,))
    _check("images.ptr", images.ptr, torch.int32, (P + 1,))
    _check("images.idx", images.idx, torch.int32, (I, 2))
    _check("images.src", images.src, torch.int32, (I,))
    _check("images.shift", images.shift, torch.float32, (3, I))
    return I


def kick_drift_shape(cap: int, P: int, R: int = 1):
    """K2a's launch shape for (R, 3, cap, P) planes: (blocks, threads a
    block, replicas)."""
    out = (_I * 3)()
    _raise("kick_drift_shape", _lib().lle_kick_drift_shape(cap, P, R, out))
    return tuple(out)


def kick_drift_floor(cap: int, P: int, R: int = 1):
    """An empty kernel launched at K2a's launch shape on the current
    device and stream: its launch floor.  Not counted."""
    _raise("kick_drift_floor", _lib().lle_kick_drift_floor(cap, P, R,
                                                           _stream()))


def _stencil_args(C, n, strides, energy, cap, P):
    """The kernels' argument block: the 27 offsets' column deltas in
    _OFFSETS order, the reciprocal's form from APPROX_RCP."""
    sx, sy, sz = strides
    deltas = [a * sx + b * sy + c * sz for (a, b, c) in _OFFSETS]
    return StencilArgs(
        C.lj1, C.lj2, C.lj3, C.lj4, C.cutsq, C.offe, C.floorsq, C.inv_r0sq,
        C.neg_kf, C.sigf_sq, C.wca_cutsq, C.wca_floorsq, C.f_wca, C.e_wca,
        C.epsf, C.e_fene, C.bond_reach_sq, C.r0sq, int(C.kf != 0.0),
        int(C.wca_is_lj), int(energy), cap, P, n, int(APPROX_RCP),
        (_I * 27)(*deltas))


def _stencil_outputs(gx, nblk, lead=()):
    """gf, each replica's per-block tally partials, energies lead + (2,),
    ints lead + (2,)."""
    dev, R = gx.device, _reps(lead)
    return (torch.empty_like(gx),
            torch.empty(2 * nblk * R, dtype=torch.float32, device=dev),
            torch.empty(3 * nblk * R, dtype=torch.int32, device=dev),
            torch.empty(lead + (2,), dtype=torch.float32, device=dev),
            torch.empty(lead + (2,), dtype=torch.int64, device=dev))


def _stencil_inputs(gx, bid, hn, pid, interior, batch=False):
    lead, cap, P = _planes(gx, bid, batch)
    _check("hn", hn, torch.bool, lead + (cap, P))
    _check("pid", pid, torch.int32, lead + (cap, P))
    _check("interior", interior, torch.bool, (P,))
    return lead, cap, P


def _check_cap(name, cap, max_cap):
    if cap > max_cap:
        raise ValueError(f"{name}: cell cap {cap} is past the {max_cap} rows "
                         f"the kernel is built for")


@_on_device
def stencil_forces(gx, bid, hn, pid, interior, C, n: int, strides,
                   energy: bool):
    """27-offset LJ + FENE + exclusion forces.  Returns (gf, energies (2,)
    = [e_lj, e_b], ints (2,) int64 = [flag bits, clamp events])."""
    if _on_cpu(gx):
        return ref.stencil_forces(gx, bid, hn, pid, interior, C, n, strides,
                                  energy)
    lead, cap, P = _stencil_inputs(gx, bid, hn, pid, interior, batch=True)
    lib = _lib()
    _check_cap("stencil_forces", cap, lib.lle_stencil_max_cap())
    gf, fpart, ipart, en, ints = _stencil_outputs(
        gx, lib.lle_stencil_blocks(P), lead)
    a = _stencil_args(C, n, strides, energy, cap, P)
    err = lib.lle_stencil_forces(
        _ptr(gx), _ptr(bid), _ptr(hn), _ptr(pid), _ptr(interior), _ptr(gf),
        _ptr(fpart), _ptr(ipart), _ptr(en), _ptr(ints), a, _reps(lead),
        _stream())
    _raise("stencil_forces", err)
    LAUNCHES["stencil_forces"] += 1
    return gf, en, ints


@_on_device
def newton_half_forces(gx, bid, hn, pid, interior, faces, C, n: int,
                       strides, fold_shifts, energy: bool):
    """Newton-half LJ + FENE + exclusion forces with the ghost fold (the
    blocked kernel's function, kernels_ref.newton_half_forces).  Returns
    what ``stencil_forces`` returns.  Deterministic: no float atomics."""
    if _on_cpu(gx):
        return ref.newton_half_forces(gx, bid, hn, pid, interior, faces, C,
                                      n, strides, fold_shifts, energy)
    lead, cap, P = _stencil_inputs(gx, bid, hn, pid, interior, batch=True)
    _check("faces", faces, torch.bool, (6, P))
    blk = _lib("blocked")
    _check_cap("newton_half_forces", cap, blk.lle_stencil_max_cap())
    gf, fpart, ipart, en, ints = _stencil_outputs(
        gx, blk.lle_window_blocks(P, 1), lead)
    # scratch: the ghost columns' reactions, the fold's image codes
    ghost = torch.empty_like(gx)
    code = torch.empty(P, dtype=torch.uint8, device=gx.device)
    a = _stencil_args(C, n, strides, energy, cap, P)
    f = FoldArgs()
    for axis, (lo, hi) in enumerate(fold_shifts):
        f.shift[axis][0], f.shift[axis][1] = lo, hi
    err = blk.lle_newton_half_forces(
        _ptr(gx), _ptr(bid), _ptr(hn), _ptr(pid), _ptr(interior),
        _ptr(faces), _ptr(gf), _ptr(ghost), _ptr(code), _ptr(fpart),
        _ptr(ipart), _ptr(en), _ptr(ints), a, f, _reps(lead), _stream())
    _raise("newton_half_forces", err)
    LAUNCHES["newton_half_forces"] += 1
    return gf, en, ints


@_on_device
def window_forces(xw, bidw, hnw, pidw, ownint, C, n: int, period: int,
                  strides, energy: bool):
    """The Newton-half offset loop over S margin-extended slab windows of
    ``period`` columns, laid side by side, in one launch (the sharded
    stencil's window call, kernels_ref.window_forces).  Returns (f (3,
    cap, S * period), stats (5,) = [e_lj, e_b, bond sightings, clamp
    events, interior links]).  Deterministic: no float atomics."""
    if _on_cpu(xw):
        return ref.window_forces(xw, bidw, hnw, pidw, ownint, C, n, period,
                                 strides, energy)
    _, cap, Q = _stencil_inputs(xw, bidw, hnw, pidw, ownint)
    sx, sy, sz = strides
    if Q % period or sx + sy + sz >= period:
        raise ValueError(f"window_forces: {Q} columns are not windows of "
                         f"{period} wider than the margin {sx + sy + sz}")
    blk = _lib("blocked")
    _check_cap("window_forces", cap, blk.lle_stencil_max_cap())
    nblk = blk.lle_window_blocks(period, Q // period)
    dev = xw.device
    f = torch.empty_like(xw)
    fpart = torch.empty(2 * nblk, dtype=torch.float32, device=dev)
    ipart = torch.empty(3 * nblk, dtype=torch.int32, device=dev)
    stats = torch.empty(5, dtype=torch.float32, device=dev)
    a = _stencil_args(C, n, strides, energy, cap, Q)
    err = blk.lle_window_forces(
        _ptr(xw), _ptr(bidw), _ptr(hnw), _ptr(pidw), _ptr(ownint), _ptr(f),
        _ptr(fpart), _ptr(ipart), _ptr(stats), a, period, Q // period,
        _stream())
    _raise("window_forces", err)
    LAUNCHES["window_forces"] += 1
    return f, stats


@_on_device
def tiled_stencil_forces(gx, bid, hn, pid, interior, C, n: int, strides,
                         energy: bool):
    """The tiled full 27-offset stencil in K5's formulas
    (kernels_ref.tiled_stencil_forces).  Returns what ``stencil_forces``
    returns."""
    if _on_cpu(gx):
        return ref.tiled_stencil_forces(gx, bid, hn, pid, interior, C, n,
                                        strides, energy)
    _, cap, P = _stencil_inputs(gx, bid, hn, pid, interior)
    tld = _lib("tiled")
    _check_cap("tiled_stencil_forces", cap, tld.lle_tiled_max_cap())
    gf, fpart, ipart, en, ints = _stencil_outputs(gx,
                                                  tld.lle_tiled_blocks(P))
    a = _stencil_args(C, n, strides, energy, cap, P)
    err = tld.lle_tiled_stencil_forces(
        _ptr(gx), _ptr(bid), _ptr(hn), _ptr(pid), _ptr(interior), _ptr(gf),
        _ptr(fpart), _ptr(ipart), _ptr(en), _ptr(ints), a, _stream())
    _raise("tiled_stencil_forces", err)
    LAUNCHES["tiled_stencil_forces"] += 1
    return gf, en, ints


def _spring_args(S, E, cap, P):
    return SpringArgs(
        (_F * 3)(*S.box), S.r0, S.neg_2k, S.k, S.r0sq, S.neg_k, S.sig_sq,
        S.wca_floorsq, S.wca_cutsq, S.f_wca, S.e_wca, S.eps, S.e_fene,
        int(S.harmonic), E, cap, P)


@_on_device
def extruder_springs(gx, gf, exl_slot, exr_slot, active, S):
    """Extruder spring forces added to ``gf`` in place.  Returns the
    per-spring energies (E,)."""
    if _on_cpu(gx):
        return ref.extruder_springs(gx, gf, exl_slot, exr_slot, active, S)
    lead = tuple(exl_slot.shape[:-1])
    if len(lead) > 1 or gx.dim() != len(lead) + 3:
        raise ValueError(f"extruder_springs: planes {tuple(gx.shape)} with "
                         f"anchor slots {tuple(exl_slot.shape)}")
    cap, P = gx.shape[-2:]
    E = exl_slot.shape[-1]
    _check("gx", gx, torch.float32, lead + (3, cap, P))
    _check("gf", gf, torch.float32, lead + (3, cap, P))
    _check("exl_slot", exl_slot, torch.int32, lead + (E,))
    _check("exr_slot", exr_slot, torch.int32, lead + (E,))
    _check("active", active, torch.bool, lead + (E,))
    eb = torch.empty(lead + (E,), dtype=torch.float32, device=gx.device)
    a = _spring_args(S, E, cap, P)
    err = _lib().lle_extruder_springs(
        _ptr(gx), _ptr(gf), _ptr(exl_slot), _ptr(exr_slot), _ptr(active),
        _ptr(eb), a, _reps(lead), _stream())
    _raise("extruder_springs", err)
    LAUNCHES["extruder_springs"] += 1
    return eb


_LAN_SCRATCH = {}


def _langevin_buffers(nblk, dev, R=1):
    """The Langevin kernel's zeroed work buffers for up to ``nblk``
    blocks (``lle_blocks``) of each of R replicas: (part: 3 partials a
    block and a ticket word, zpart: zero's 4 partials a block, its 3
    means and a ticket word; a replica's at its stride).  A ticket word
    must be 0 at a launch, and every launch leaves it 0."""
    return (torch.zeros(R * (3 * nblk + 1), dtype=torch.float32,
                        device=dev),
            torch.zeros(R * (4 * nblk + 4), dtype=torch.float32,
                        device=dev))


def _langevin_scratch(dev, nblk, R=1):
    """_langevin_buffers kept per device, stream, size and replicas, so
    that a call allocates and zeroes nothing: launches on one stream run
    in order, and each leaves the ticket words 0 for the next."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream, nblk, R)
    if key not in _LAN_SCRATCH:
        _LAN_SCRATCH[key] = _langevin_buffers(nblk, dev, R)
    return _LAN_SCRATCH[key]


@_on_device
def langevin_kick_monitor(gx, gx_ref, gv, gf, bid, interior, key_words,
                          sstep: int, gamma1: float, gamma2: float,
                          kick: float, dt: float, bad_cut: float,
                          trig_cut: float, n: int, langevin: bool,
                          lgm=None, zero: bool = False):
    """Langevin force over the group ``lgm`` ((cap, P) 0/1 plane, or None
    for all beads), with ``zero`` its random force's group mean
    subtracted first; the final half kick and skin monitor.  Returns (gf,
    gv, ints (2,) int64 = [skin flag bits, look-ahead trigger]).  One
    launch, two with ``zero`` (a pass for the group means first); each
    pass's last block reduces its block partials in a fixed order, with
    no float atomics (bitwise the same run to run).  ``key_words``: the
    pair (k0, k1), or for R replicas' planes an (R, 2) int32 tensor of
    each replica's words' bits on their device."""
    if _on_cpu(gx):
        return ref.langevin_kick_monitor(
            gx, gx_ref, gv, gf, bid, interior, key_words, sstep, gamma1,
            gamma2, kick, dt, bad_cut, trig_cut, n, langevin, lgm, zero)
    lead, cap, P = _planes(gx, bid, batch=True)
    for name, t in (("gx_ref", gx_ref), ("gv", gv), ("gf", gf)):
        _check(name, t, torch.float32, gx.shape)
    _check("interior", interior, torch.bool, (P,))
    if lgm is not None:
        _check("lgm", lgm, torch.float32, lead + (cap, P))
    keys, k0, k1 = None, 0, 0
    if lead:
        keys = key_words
        _check("key_words", keys, torch.int32, lead + (2,))
    else:
        k0, k1 = key_words
    lib = _lib()
    nblk = lib.lle_blocks(cap * P)
    gf_out = torch.empty_like(gf)
    gv_out = torch.empty_like(gv)
    part, zpart = _langevin_scratch(gx.device, nblk, _reps(lead))
    zero = bool(zero and langevin)
    ints = torch.empty(lead + (2,), dtype=torch.int64, device=gx.device)
    a = LangevinArgs(int(k0), int(k1), (int(sstep) * 4) & 0xFFFFFFFF,
                     gamma1, gamma2, kick, dt, bad_cut, trig_cut,
                     int(langevin), cap, P, n, int(lgm is not None),
                     int(zero), 1.0 / n, None if keys is None else _ptr(keys))
    err = lib.lle_langevin_kick_monitor(
        _ptr(gx), _ptr(gx_ref), _ptr(gv), _ptr(gf), _ptr(bid),
        _ptr(interior), None if lgm is None else _ptr(lgm), _ptr(gf_out),
        _ptr(gv_out), _ptr(part), _ptr(zpart), _ptr(ints), a, _reps(lead),
        _stream())
    _raise("langevin_kick_monitor", err)
    LAUNCHES["langevin_kick_monitor"] += 1
    return gf_out, gv_out, ints


def _slab_langevin(gx, bid, interior, lgm):
    """Checks of a split pass's one-run planes; (cap, P, group flag)."""
    _, cap, P = _planes(gx, bid)
    _check("interior", interior, torch.bool, (P,))
    if lgm is not None:
        _check("lgm", lgm, torch.float32, (cap, P))
    return cap, P, int(lgm is not None)


def _lan_args(key_words, sstep, gamma1, gamma2, kick, dt, cap, P, n,
              langevin, group, zero):
    k0, k1 = key_words
    return LangevinArgs(int(k0), int(k1), (int(sstep) * 4) & 0xFFFFFFFF,
                        gamma1, gamma2, kick, dt, 0.0, 0.0, int(langevin),
                        cap, P, n, group, int(zero), 1.0 / n)


@_on_device
def langevin_sums(gx, bid, interior, lgm, key_words, sstep: int, n: int):
    """``zero``'s first pass on one slab's planes (``gx`` for its shape
    and device): (4,) f32 = [the sums of noise * w over the slab's slots
    for x, y and z, the sum of the group plane ``lgm`` (0 without one)],
    unscaled (kernels_ref.langevin_sums).  One launch."""
    if _on_cpu(gx):
        return ref.langevin_sums(gx, bid, interior, lgm, key_words, sstep, n)
    cap, P, group = _slab_langevin(gx, bid, interior, lgm)
    lib = _lib()
    _, zpart = _langevin_scratch(gx.device, lib.lle_blocks(cap * P))
    sums = torch.empty(4, dtype=torch.float32, device=gx.device)
    a = _lan_args(key_words, sstep, 0.0, 0.0, 0.0, 0.0, cap, P, n, True,
                  group, True)
    err = lib.lle_langevin_sums(
        _ptr(bid), _ptr(interior), None if lgm is None else _ptr(lgm),
        _ptr(zpart), _ptr(sums), a, _stream())
    _raise("langevin_sums", err)
    LAUNCHES["langevin_sums"] += 1
    return sums


@_on_device
def langevin_kick_parts(gx, gx_ref, gv, gf, bid, interior, key_words,
                        sstep: int, gamma1: float, gamma2: float,
                        kick: float, dt: float, n: int, langevin: bool,
                        lgm=None, means=None):
    """``langevin_kick_monitor`` on one slab's planes with zero's group
    means given (``means`` (3,) f32, every slab's sums scaled; None: no
    zero): returns (gf, gv, parts (3,) f32 = [the largest squared
    displacement since the rebuild, the largest below it, the largest
    look-ahead]) for the step to merge over its slabs
    (slab_step.merge_monitor).  One launch."""
    if _on_cpu(gx):
        return ref.langevin_kick_parts(
            gx, gx_ref, gv, gf, bid, interior, key_words, sstep, gamma1,
            gamma2, kick, dt, n, langevin, lgm, means)
    cap, P, group = _slab_langevin(gx, bid, interior, lgm)
    for name, t in (("gx_ref", gx_ref), ("gv", gv), ("gf", gf)):
        _check(name, t, torch.float32, gx.shape)
    if means is not None:
        _check("means", means, torch.float32, (3,))
    lib = _lib()
    part, _ = _langevin_scratch(gx.device, lib.lle_blocks(cap * P))
    gf_out = torch.empty_like(gf)
    gv_out = torch.empty_like(gv)
    parts = torch.empty(3, dtype=torch.float32, device=gx.device)
    a = _lan_args(key_words, sstep, gamma1, gamma2, kick, dt, cap, P, n,
                  langevin, group, means is not None)
    err = lib.lle_langevin_kick_parts(
        _ptr(gx), _ptr(gx_ref), _ptr(gv), _ptr(gf), _ptr(bid),
        _ptr(interior), None if lgm is None else _ptr(lgm),
        None if means is None else _ptr(means), _ptr(gf_out), _ptr(gv_out),
        _ptr(part), _ptr(parts), a, _stream())
    _raise("langevin_kick_parts", err)
    LAUNCHES["langevin_kick_parts"] += 1
    return gf_out, gv_out, parts


class StepLoop:
    """K2's step loop on the card (make_step_kernel, pallas_step.py:554):
    ``loop(gx, gv, gf, gx_ref, bid, hn, pid, exl_slot, exr_slot, active,
    lgm, sstep, do_drift, key_words, t0, t_slope, limit, energy)`` runs up
    to ``limit`` <= LAUNCH_MAX steps and returns what ``kernels_ref.
    step_loop`` returns, which it runs on CPU tensors.  ``L``: the launch
    constants (pallas_step.StepConsts), the run's GridConsts among them.

    The kernels run in place on static planes that the loop owns, so that
    a CUDA graph can hold their addresses: a call copies each input plane
    in unless the static plane already holds it (the same tensor, not
    modified in place since), writes the control block (one small
    kernel), launches the loop's graph (``launch``; an energy launch,
    ``limit`` 1, runs its kernels eagerly and adds the springs' energy sum
    with PyTorch, as the chain does), copies the planes out and reads the
    control block: one host sync.  The graph, built in ``csrc/step.cu`` at
    the first launch, is one WHILE conditional node whose body is one
    controlled step: the step's last kernel sets the condition, so a
    launch ends at the step whose trigger fired, or at ``limit``, with no
    dead steps, and one graph serves every limit.  ``iterations``: the
    last launch's loop iterations, which the call holds to its steps.
    ``before_read(gx, gv, gf)``, if given, is called on the output planes
    between the launch and the read, so that the host work it issues
    overlaps the launch."""

    MAX_STEPS = 16

    def __init__(self, L):
        self.L = L
        self.buf = None
        self.held = {}      # static plane name -> (source, its version)
        self.graph = None   # the library's StepGraph handle
        self.iterations = 0

    def _alloc(self, gx, exl_slot, lgm):
        L, lib = self.L, _lib()
        cap, P = gx.shape[1:]
        E = exl_slot.shape[0] if L.S is not None else 0
        nblk = lib.lle_blocks(cap * P)
        _check_cap("step_loop", cap, lib.lle_stencil_max_cap())
        sblk = lib.lle_stencil_blocks(P)
        dev = gx.device
        f32, i32 = dict(dtype=torch.float32, device=dev), dict(
            dtype=torch.int32, device=dev)
        lpart, zpart = _langevin_buffers(nblk, dev)
        b = dict(
            gx=torch.empty((3, cap, P), **f32),
            gv=torch.empty((3, cap, P), **f32),
            gf=torch.empty((3, cap, P), **f32),
            gx_ref=torch.empty((3, cap, P), **f32),
            bid=torch.empty((cap, P), **i32),
            hn=torch.empty((cap, P), dtype=torch.bool, device=dev),
            pid=torch.empty((cap, P), **i32),
            exl_slot=torch.zeros(max(E, 1), **i32),
            exr_slot=torch.zeros(max(E, 1), **i32),
            active=torch.zeros(max(E, 1), dtype=torch.bool, device=dev),
            eb=torch.zeros(max(E, 1), **f32),
            lgm=None if lgm is None else torch.empty((cap, P), **f32),
            fpart=torch.empty(2 * sblk, **f32),
            ipart=torch.empty(3 * sblk, **i32),
            lpart=lpart, zpart=zpart,
            ctl=torch.zeros(lib.lle_ctl_words(), **i32))
        self.buf = b
        self.stats_at = lib.lle_ctl_stats()
        self.iters_at = lib.lle_ctl_iters()
        g = L.g
        ptr = {k: (None if v is None else _ptr(v)) for k, v in b.items()}
        self.planes = StepPlanes(
            ptr["gx"], ptr["gv"], ptr["gf"], ptr["gx_ref"], ptr["bid"],
            ptr["hn"], ptr["pid"], _ptr(g.interior),
            _ptr(g.images.own), _ptr(g.images.ptr), _ptr(g.images.idx),
            _ptr(g.images.src), _ptr(g.images.shift), ptr["exl_slot"],
            ptr["exr_slot"], ptr["active"], ptr["eb"], ptr["lgm"],
            ptr["fpart"], ptr["ipart"], ptr["lpart"], ptr["zpart"],
            ptr["ctl"], _check_images(g.images, cap, P), L.kick, L.dt)
        self.args = {e: _stencil_args(L.C, L.n, L.strides, e, cap, P)
                     for e in (False, True)}
        # E = 0: no springs step (the chain's ctx.S is None)
        self.spring = (_spring_args(L.S, E, cap, P) if E
                       else SpringArgs(E=0))
        # gamma2 carries g2base: each step scales it by sqrt(T(s))
        self.lan = LangevinArgs(
            0, 0, 0, L.gamma1, L.g2base, L.kick, L.dt, L.bad_cut,
            L.trig_cut, int(L.langevin), cap, P, L.n, int(lgm is not None),
            int(L.zero and L.langevin), 1.0 / L.n)

    def nbytes(self):
        """Bytes of the static planes and buffers (0 before the first
        launch): the graph's kernels allocate nothing."""
        return sum(v.numel() * v.element_size()
                   for v in (self.buf or {}).values() if v is not None)

    def _step(self, energy):
        """The launch's next step, run eagerly."""
        _raise("step_loop", _lib().lle_step_ctl(
            self.planes, self.args[energy], self.spring, self.lan,
            _stream()))

    def _build(self):
        """The loop's graph, at the first launch.  Raises if it does not
        build: there is no other form of the loop on the card."""
        lib = _lib()
        # every kernel launched once outside the capture (each returns at
        # once at limit 0), so that none loads there
        self._begin(0, (0, 0), 0, True, 0.0, 0.0)
        self._step(False)
        torch.cuda.synchronize()
        handle = _P()
        _raise("step_loop graph", lib.lle_loop_create(
            self.planes, self.args[False], self.spring, self.lan,
            ctypes.byref(handle)))
        self.graph = handle
        # the graph goes with the loop; at exit the process frees it
        weakref.finalize(self, lib.lle_loop_destroy, handle).atexit = False

    def body_nodes(self):
        """(kernel nodes, all nodes) of the graph's body, one step."""
        kernels, nodes = _I(), _I()
        _raise("step_loop nodes", _lib().lle_loop_nodes(
            self.graph, ctypes.byref(kernels), ctypes.byref(nodes)))
        return kernels.value, nodes.value

    def _begin(self, sstep, key_words, limit, do_drift, t0, t_slope):
        k0, k1 = key_words
        _raise("step_loop", _lib().lle_launch_begin(
            _ptr(self.buf["ctl"]), int(sstep) & 0xFFFFFFFF, int(k0),
            int(k1), int(limit), int(bool(do_drift)), t0, t_slope,
            _stream()))

    def launch(self, sstep, do_drift, key_words, t0, t_slope, limit):
        """The control block written and the graph launched on the static
        planes as they stand, on the current stream: no staging, no
        read."""
        self._begin(sstep, key_words, limit, do_drift, t0, t_slope)
        _raise("step_loop", _lib().lle_loop_launch(self.graph, _stream()))

    def _stage(self, name, src, dtype, shape):
        held = self.held.get(name)
        if held is not None and held[0] is src and held[1] == src._version:
            return
        _check(name, src, dtype, shape)
        self.buf[name].copy_(src)
        self.held[name] = (src, src._version)

    def __call__(self, gx, gv, gf, gx_ref, bid, hn, pid, exl_slot, exr_slot,
                 active, lgm, sstep: int, do_drift: bool, key_words,
                 t0: float, t_slope: float, limit: int,
                 energy: bool = False, before_read=None):
        if _on_cpu(gx):
            return ref.step_loop(self.L, gx, gv, gf, gx_ref, bid, hn, pid,
                                 exl_slot, exr_slot, active, lgm, sstep,
                                 do_drift, key_words, t0, t_slope, limit,
                                 energy, before_read)
        if not 1 <= limit <= self.MAX_STEPS or (energy and limit != 1):
            raise ValueError(f"step_loop: limit {limit} (energy {energy})")
        if self.buf is None:
            self._alloc(gx, exl_slot, lgm)
            # before staging: the warm-up writes the control block
            self._build()
        if (lgm is None) != (self.buf["lgm"] is None):
            raise ValueError("step_loop: a Langevin group plane in one "
                             "launch and none in another")
        b = self.buf
        cap, P = bid.shape
        plane = (3, cap, P)
        for name, t, dtype, shape in (
                ("gx", gx, torch.float32, plane),
                ("gv", gv, torch.float32, plane),
                ("gf", gf, torch.float32, plane),
                ("gx_ref", gx_ref, torch.float32, plane),
                ("bid", bid, torch.int32, (cap, P)),
                ("hn", hn, torch.bool, (cap, P)),
                ("pid", pid, torch.int32, (cap, P)),
                ("lgm", lgm, torch.float32, (cap, P))):
            if t is not None:
                self._stage(name, t, dtype, shape)
        if self.L.S is not None:
            E = exl_slot.shape[0]
            self._stage("exl_slot", exl_slot, torch.int32, (E,))
            self._stage("exr_slot", exr_slot, torch.int32, (E,))
            self._stage("active", active, torch.bool, (E,))
        if energy:
            self._begin(sstep, key_words, limit, do_drift, t0, t_slope)
            self._step(True)
            if self.L.S is not None:
                st = b["ctl"].view(torch.float32)[self.stats_at:]
                st[1:2] += 2.0 * b["eb"].sum()
        else:
            self.launch(sstep, do_drift, key_words, t0, t_slope, limit)
        out = tuple(b[k].clone() for k in ("gx", "gv", "gf"))
        for name, t in zip(("gx", "gv", "gf"), out):
            self.held[name] = (t, t._version)
        if before_read is not None:
            # host work issued here overlaps the launch on the card
            before_read(*out)
        host = b["ctl"].cpu()
        stats = host.view(torch.float32)[self.stats_at:
                                         self.stats_at + 8].double()
        done = int(stats[7])
        self.iterations = int(host[self.iters_at])
        if done < 1 or self.iterations != done:
            raise RuntimeError(f"step_loop: a launch of limit {limit} ran "
                               f"{done} steps in {self.iterations} loop "
                               f"iterations")
        LAUNCHES["step_loop"] += 1
        LAUNCHES["kick_drift_halo"] += done - (0 if do_drift else 1)
        LAUNCHES["stencil_forces"] += done
        LAUNCHES["langevin_kick_monitor"] += done
        if self.L.S is not None:
            LAUNCHES["extruder_springs"] += done
        return out + (stats,)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0

