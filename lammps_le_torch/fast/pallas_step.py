"""K2's step loop: the counterpart of ``lammps_le_tpu/fast/pallas_step.py``
``make_step_kernel`` (its while loop over whole steps, :725-1022).

One launch runs up to ``limit`` whole steps: kick + drift + halo, the full
27-offset stencil (K1), the extruder springs, Langevin + final kick + skin
monitor.  It stops after the step whose per-bead look-ahead trigger fires,
advances the threefry counter by 4 a step, ramps the thermostat target as
``t0 + s * t_slope`` and returns the reference's 8 stats rows.  On the card
it is ``kernels.StepLoop`` (the kernels' launch-controlled forms, one step
an iteration of one CUDA graph's WHILE conditional node); in ``interpret`` mode, and on CPU tensors, it is
``kernels_ref.step_loop``, the chain's plain step functions in the chain's
order.  The reference's loop carries its own Newton-half stencil; the port's
carries the full stencil of its chain, so that both modes step the same
trajectory.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..system import System
from . import kernels as K
from . import kernels_ref as R
from .consts import SpringConsts, StencilConsts
from .maps import FastMaps
from .place import GridConsts

LAUNCH_MAX = K.StepLoop.MAX_STEPS  # steps a launch (engine.py:1702)


@dataclasses.dataclass
class StepConsts:
    """The constants of a run's launches (the reference's SMEM scalars and
    baked constants, pallas_step.py:604-640)."""

    g: GridConsts
    C: StencilConsts
    S: object          # SpringConsts, or None without extruder springs
    strides: tuple
    n: int
    kick: float
    dt: float
    bad_cut: float     # pairwise skin bound: the flag
    trig_cut: float    # per-bead look-ahead bound: the rebuild trigger
    langevin: bool
    gamma1: float
    g2base: float      # gamma2 / sqrt(T)
    zero: bool
    np_dtype: type


def skin_cuts(system: System):
    """(bad_cut, trig_cut): the half-skin from the real cell margin
    (engine.py:1154-1162), twice it for the pairwise coverage flag and 0.85
    of it for the per-bead look-ahead trigger."""
    min_edge = min(b / d for b, d in zip(
        system.box_size,
        (system.neighbor.nx, system.neighbor.ny, system.neighbor.nz)))
    max_cut = float(np.max(np.asarray(system.pair.cutoff)))
    halfskin = 0.5 * max(min_edge - max_cut, 1e-6)
    return 2.0 * halfskin, 0.85 * halfskin


def make_step_kernel(system: System, maps: FastMaps, ex_btype: int, *,
                     dt: float, langevin, energy: bool = False,
                     g: GridConsts = None, interpret: bool = False):
    """Build ``call(gx, gv, gf, gx_ref, bid, hn, pid, exl_slot, exr_slot,
    active, lgm, sstep, do_drift, key_words, t_target, t_slope, limit,
    energy) -> (gx, gv, gf, stats)`` advancing ``d`` = 1..limit
    steps (pallas_step.py:554).  ``langevin``: the run's Langevin fix or
    None; ``energy``: whether a call sums the energies when it is not
    told (the reference builds one kernel each way); ``g``: the run's
    GridConsts (its device is the call's; None builds them on the card);
    ``key_words``: the run-constant Langevin key words (the step enters
    through the counter only); ``stats``: the reference's rows, read back
    to the host (``kernels_ref.step_loop``).  The call writes none of its
    inputs.  ``interpret``: the plain loop, on any device; else the
    kernels, which need CUDA tensors (no fallback)."""
    units = system.units
    mass = float(np.asarray(system.masses).flat[0])
    np_dtype = np.float32 if system.dtype == "float32" else np.float64
    bad_cut, trig_cut = skin_cuts(system)
    lf = langevin
    if g is None:
        g = GridConsts.build(system, maps, "cuda")
    L = StepConsts(
        g=g, C=StencilConsts(system, np_dtype),
        S=SpringConsts(system, ex_btype) if ex_btype > 0 else None,
        strides=maps.strides, n=system.n,
        kick=0.5 * dt * units.ftm2v / mass, dt=dt, bad_cut=bad_cut,
        trig_cut=trig_cut, langevin=lf is not None,
        gamma1=0.0 if lf is None else -mass / lf.damp / units.ftm2v,
        g2base=0.0 if lf is None else float(
            np.sqrt(mass) * np.sqrt(24.0 * units.boltz / (lf.damp * dt)
                                    / units.mvv2e) / units.ftm2v),
        zero=lf is not None and lf.zero, np_dtype=np_dtype)
    loop = None if interpret else K.StepLoop(L)

    def call(gx, *args, **kw):
        if len(args) < 17:  # energy, the 17th after gx, not given
            kw.setdefault("energy", energy)
        if interpret:
            return R.step_loop(L, gx, *args, **kw)
        if gx.device.type != "cuda":
            raise ValueError(f"make_step_kernel: the kernels run on CUDA "
                             f"tensors, not on {gx.device} (interpret=True "
                             f"runs the plain loop)")
        return loop(gx, *args, **kw)

    call.loop = loop
    return call
