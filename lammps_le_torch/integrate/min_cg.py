"""Polak-Ribiere CG + steepest-descent minimizers — ``min_style cg|sd``
(``lammps_le_tpu/integrate/min_cg.py``).

The reference's CG loop (src/min_cg.cpp:40-135) per iteration: line-min
along h, energy-tolerance stop |E-E_prev| < etol*(|E|+|E_prev|+eps)/2,
force-tolerance stop fdotf < ftol^2 (Euclidean 2-norm default), then
Polak-Ribiere beta = f.(f-g)/g.g with restart when beta would exceed 1.
SD (src/min_sd.cpp) is the same loop with beta = 0.

The line minimizer is energy backtracking (the moral twin of the
reference's default ``linemin_quadratic``'s backtracking fallback,
src/min_linesearch.cpp): start from the displacement-capped alpha
(dmax = 0.1 reduced units of max per-component move, matching
Min::dmax's role) and halve until the energy decreases, bounded
halvings.  The reference's two nested ``lax.while_loop`` are host loops
here: each line-search trial and each iteration reads its stop test back
once — minimization is set-up, not the stepping path.
"""

from __future__ import annotations

import torch

from ..state import State
from .verlet import Simulation, _force_pass, _maybe_rebuild, setup

_DMAX = 0.1          # max initial per-component displacement (Min::dmax)
_EPS_ENERGY = 1e-8   # min.cpp EPS_ENERGY
_BACKTRACK_MAX = 14


def minimize_cg(
    sim: Simulation,
    state: State,
    etol: float = 0.0,
    ftol: float = 1e-4,
    maxiter: int = 1000,
    sd: bool = False,
):
    """Relax until the reference's etol/ftol criteria fire or maxiter, on
    the state's device.

    Returns (state, n_iters, fmax).  ``sd=True`` degrades to steepest
    descent (beta = 0).  ftol compares the Euclidean force 2-norm like
    the reference's default ``min_modify norm two``
    (src/min_cg.cpp:114-119).  Velocities are zeroed on exit, as the
    reference does (min_cg.py:129): the reference's CG keeps the
    velocities of the state it was given (min_cg.cpp), so this is a known
    fault of the reference, ported as it is.
    """
    system = sim.system
    state = setup(sim, state)

    def energy_forces(st):
        st = _maybe_rebuild(st, system, force=True)
        fr = _force_pass(st, sim)
        st = st.replace(f=fr.f, epair=fr.epair, ebond=fr.ebond,
                        flags=st.flags | fr.flags)
        return st, fr.epair + fr.ebond, fr.f

    st, e_cur, g = energy_forces(state)
    h = g
    it = 0
    done = False
    while not done and it < maxiter:
        # backtracking line-min along h from st.x
        hmax = torch.max(torch.abs(h))
        alpha = _DMAX / torch.clamp(hmax, min=1e-20)
        st_new, e_new, ls_ok = st, e_cur, False
        for _ in range(_BACKTRACK_MAX):
            st_t, e_t, _ = energy_forces(st.replace(x=st.x + alpha * h))
            if bool(e_t < e_cur):
                st_new, e_new, ls_ok = st_t, e_t, True
                break
            alpha = alpha * 0.5
        # a failed line search (no downhill alpha) terminates like the
        # reference's linemin failure return (min_cg.cpp:76)
        f_new = st_new.f

        # stopping criteria (min_cg.cpp:80-119)
        e_stop = torch.abs(e_new - e_cur) < etol * 0.5 * (
            torch.abs(e_new) + torch.abs(e_cur) + _EPS_ENERGY)
        fdotf = torch.sum(f_new * f_new)
        f_stop = (ftol > 0.0) & (fdotf < ftol * ftol)
        done = (not ls_ok) or bool(e_stop | f_stop)

        # Polak-Ribiere update with the reference's restart guard
        if sd:
            h_new = f_new
        else:
            gg = torch.sum(g * g)
            beta = torch.clamp(torch.sum(f_new * (f_new - g))
                               / torch.clamp(gg, min=1e-30), min=0.0)
            h_new = f_new + beta * h
        # if h.f <= 0 the direction is uphill: restart from f
        uphill = torch.sum(h_new * f_new) <= 0.0
        h = torch.where(uphill, f_new, h_new)
        g = f_new

        # advance the timestep counter like the reference
        # (min_cg.cpp:68 ++update->ntimestep); keep the step taken by
        # the line search
        st = st_new.replace(step=st.step + 1)
        e_cur = e_new
        it += 1
    fmax = float(torch.max(torch.abs(st.f)))
    return st.replace(v=torch.zeros_like(st.v)), it, fmax
