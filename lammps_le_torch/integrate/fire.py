"""FIRE energy minimizer (Bitzek et al. 2006) — the ``minimize`` command
(``lammps_le_tpu/integrate/fire.py``).

The reference ships CG/SD/FIRE minimizers (src/min_fire.cpp, min_cg.cpp);
decks use minimization to relax bad starting configurations before
dynamics.  FIRE is damped MD with adaptive mixing on the general path's
force pass.  The reference's ``lax.while_loop`` is a host loop here: each
iteration issues its device work and reads the stop test (max |F| > ftol)
back once — minimization is set-up, not the stepping path.
"""

from __future__ import annotations

import torch

from ..ops.cells import system_const
from ..state import State
from .verlet import Simulation, _force_pass, _maybe_rebuild, setup

_ALPHA0 = 0.1
_F_INC = 1.1
_F_DEC = 0.5
_F_ALPHA = 0.99
_N_MIN = 5


def minimize(
    sim: Simulation,
    state: State,
    ftol: float = 1e-4,
    maxiter: int = 1000,
    dtmax_factor: float = 10.0,
):
    """Relax the configuration until max |F| < ftol or maxiter steps, on
    the state's device.

    Returns (state, n_iters, fmax).  Velocities are zeroed on exit (the
    reference's minimizers likewise leave a quenched configuration).
    """
    system = sim.system
    state = setup(sim, state)
    dtype = state.x.dtype
    dev = state.x.device
    masses = system_const(system, "masses", lambda: system.masses, dtype,
                          dev)
    dt0 = torch.tensor(sim.dt, dtype=dtype, device=dev)
    dtmax = dtmax_factor * dt0

    st = state
    v = torch.zeros_like(state.v)
    dt = dt0
    alpha = torch.tensor(_ALPHA0, dtype=dtype, device=dev)
    npos = torch.zeros((), dtype=torch.int64, device=dev)
    it = 0
    fmax = torch.max(torch.abs(state.f))
    while it < maxiter and bool(fmax > ftol):
        m = masses[st.type][:, None]
        f = st.f

        # FIRE velocity mixing
        p = torch.sum(f * v)
        fnorm = torch.sqrt(torch.sum(f * f))
        vnorm = torch.sqrt(torch.sum(v * v))
        fhat = f / torch.clamp(fnorm, min=1e-20)
        v_mix = (1.0 - alpha) * v + alpha * vnorm * fhat

        uphill = p <= 0.0
        v_new = torch.where(uphill, torch.zeros_like(v), v_mix)
        npos = torch.where(uphill, 0, npos + 1)
        grow = (~uphill) & (npos > _N_MIN)
        dt = torch.where(grow, torch.minimum(dt * _F_INC, dtmax),
                         torch.where(uphill, dt * _F_DEC, dt))
        alpha = torch.where(grow, alpha * _F_ALPHA,
                            torch.where(uphill, _ALPHA0, alpha))

        # semi-implicit Euler step
        v = v_new + dt * f / m
        x = st.x + dt * v
        # advance the real timestep counter (the reference advances
        # ntimestep during minimization, src/min.cpp update->ntimestep)
        # and force the rebuild whatever the step
        st = st.replace(x=x, step=st.step + 1)
        st = _maybe_rebuild(st, system, force=True)
        fr = _force_pass(st, sim)
        st = st.replace(f=fr.f, epair=fr.epair, ebond=fr.ebond,
                        flags=st.flags | fr.flags)
        fmax = torch.max(torch.abs(fr.f))
        it += 1
    return st.replace(v=torch.zeros_like(st.v)), it, float(fmax)
