"""The general path's per-step driver: velocity-Verlet + every fix
(``lammps_le_tpu.integrate.verlet``, the replacement of ``Verlet::run``,
verlet.cpp:223-354).

One step is, in the reference's order:

    initial integrate (GJF vhalf / vfull, or nve and nve/limit per group)
    -> post_integrate (LE fixes at their phases, registered hooks)
    -> rebuild on the static cadence, or the half-skin check
    -> forces (energies on the energy_every cadence)
    -> post_force (Langevin drag + noise with its zero, group, tally and
       t ramp; registered hooks) -> final integrate -> NON_FINITE flag
    -> end_of_step (registered hooks)

The reference's ``lax.cond`` gates become Python branches on the host's
step counter and its keys are folded on the host from the run key's
words, read once a ``run``: a step issues device operations only and
reads nothing back.  Flags and the skin check stay on the device.  The
steps run where the state lies; plain PyTorch (no module of this path
reaches a ``pallas_call`` in the reference).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import rng
from ..fixes.config import NVE, ExLoad, ExUnload, Extrusion, Langevin, NVELimit
from ..fixes.ex_load import make_ex_load_update
from ..fixes.ex_unload import make_ex_unload_update
from ..fixes.extrusion import make_extrusion_update
from ..ops import cells
from ..ops.cells import system_const
from ..ops.forces import compute_forces
from ..ops.pair import NP_DTYPE
from ..state import (FLAG_NON_FINITE, FLAG_SKIN_VIOLATION, State,
                     extruder_occupancy, extruder_partner)
from ..system import System
from .simulation import Simulation

__all__ = ["Simulation", "ThermoSample", "make_step", "run", "setup",
           "thermo_row"]

# the stream salts of the reference's key schedule (verlet.py:273-283,
# 386-392, 461-465): (kind << 20) + the fix's index
_KIND = {Extrusion: 1, ExLoad: 2, ExUnload: 3}
_LANGEVIN_KIND, _GJF_KIND = 4, 5


class ThermoSample(NamedTuple):
    step: torch.Tensor
    temp: torch.Tensor
    epair: torch.Tensor
    ebond: torch.Tensor
    ke: torch.Tensor
    etotal: torch.Tensor
    n_extruders: torch.Tensor


def _masses(state: State, system: System):
    """(N, 1) per-bead masses of the state's types."""
    masses = system_const(system, "masses", lambda: system.masses,
                          state.v.dtype, state.v.device)
    return masses[state.type][:, None]


def thermo_row(state: State, system: System) -> ThermoSample:
    """Thermo of a State (verlet.py:77): T with dof = 3N - 3
    (compute_temp.cpp dof_compute), energies, extruders; device tensors."""
    m = _masses(state, system)
    ke2 = torch.sum(m * state.v * state.v)
    temp = ke2 / ((3.0 * system.n - 3.0) * system.units.boltz)
    ke = 0.5 * ke2
    return ThermoSample(
        step=state.step, temp=temp, epair=state.epair, ebond=state.ebond,
        ke=ke, etotal=ke + state.epair + state.ebond,
        n_extruders=torch.sum(state.ex_left >= 0))


def _force_pass(state: State, sim: Simulation, energy: bool = True):
    system = sim.system
    partner = ex_l = ex_r = None
    if sim.ex_btype > 0:
        partner = extruder_partner(state, system.n)
        ex_l, ex_r = state.ex_left, state.ex_right
    return compute_forces(state.x, state.type, state.nbr, system,
                          ex_left=ex_l, ex_right=ex_r,
                          ex_btype=sim.ex_btype - 1, ex_partner=partner,
                          energy=energy)


def _build_nbr(x, system: System):
    if system.neighbor.mode == "grid":
        from ..ops.grid import build_grid

        return build_grid(x, system)
    return cells.build_neighbor_list(x, system)


def _maybe_rebuild(state: State, system: System, step_no: int = 0,
                   force: bool = False):
    """Rebuild on the static cadence (verlet.py:118): wrap the positions
    (domain->pbc() runs on reneighbor steps only, verlet.cpp:271) and
    build the grid or list; between rebuilds the half-skin check
    (neighbor.cpp:1948-1962) sets a sticky flag.  ``force`` rebuilds
    whatever the step."""
    cfg = system.neighbor
    if not cfg.use_cells:
        return state
    if force or step_no % cfg.rebuild_every == 0:
        x, img = cells.wrap_positions(state.x, system, state.img)
        nbr, fl = _build_nbr(x, system)
        return state.replace(x=x, img=img, nbr=nbr, flags=state.flags | fl)
    d = cells.minimum_image(state.x - state.nbr.x_ref, system.box_size)
    bad = torch.max(torch.sum(d * d, dim=-1)) > (0.5 * cfg.skin) ** 2
    return state.replace(
        flags=state.flags | bad.to(torch.int64) * FLAG_SKIN_VIOLATION)


def _fold3(key_words, step_no: int, salt: int, seed: int):
    """The reference's three-level stream fold (step, salt, seed)."""
    return rng.fold_in(rng.fold_in(rng.fold_in(key_words, step_no), salt),
                       seed)


def _group_mean(a, gm, dtype):
    """``a`` minus its mean over the group (all beads when ``gm`` is
    None): the zeroflag adjustment (fix_langevin.cpp post_force end)."""
    if gm is None:
        return a - torch.mean(a, dim=0, keepdim=True)
    cnt = torch.clamp(torch.sum(gm.to(dtype)), min=1.0)
    return a - torch.sum(torch.where(gm, a, 0.0), dim=0, keepdim=True) / cnt


def make_step(sim: Simulation, groups: Optional[dict] = None, *,
              device="cuda"):
    """``step(state, step_no, key_words, run_begin=None, run_end=None) ->
    State`` on ``device`` (verlet.py:159): ``step_no`` the step being made
    (the state's step + 1) and ``key_words`` the run key's words, both
    host ints; ``run_begin`` / ``run_end`` bound the Langevin t ramp
    (without them, t_start).  ``groups``: the deck's name -> (N,) bool
    masks the fixes' groups name.  Raises the reference's validation
    errors."""
    system = sim.system
    dt = sim.dt
    units = system.units
    dtf = 0.5 * dt * units.ftm2v

    def group_mask(name):
        if name is None:
            return None
        if groups is None or name not in groups:
            raise KeyError(f"undefined group {name!r}")
        return torch.as_tensor(np.asarray(groups[name], bool),
                               device=device)[:, None]

    nve_fixes = [f for f in sim.fixes if isinstance(f, (NVE, NVELimit))]
    langevin_fixes = [f for f in sim.fixes if isinstance(f, Langevin)]
    # GJF validation (fix_langevin.cpp:97-145 gjfflag)
    gjf_list = [f for f in langevin_fixes if f.gjf != "no"]
    if len(gjf_list) > 1:
        raise ValueError("at most one fix langevin may use gjf")
    gjf_fix = gjf_list[0] if gjf_list else None
    if gjf_fix is not None:
        if gjf_fix.gjf not in ("vfull", "vhalf"):
            raise ValueError("fix langevin gjf must be no/vfull/vhalf, got "
                             f"{gjf_fix.gjf!r}")
        if len(nve_fixes) != 1 or not (
                type(nve_fixes[0]) is NVE and nve_fixes[0].group is None):
            raise ValueError(
                "fix langevin gjf requires exactly one group-all fix nve "
                "(the GJF noise is folded into the Verlet kicks)")
    gjf_lid = langevin_fixes.index(gjf_fix) if gjf_fix is not None else -1
    if sum(1 for f in langevin_fixes if f.tally) > 1:
        # State.therm_e is one accumulator: two tallying fixes would each
        # report the shared sum (fix_langevin.cpp compute_scalar)
        raise ValueError(
            "at most one fix langevin may use tally yes (per-fix "
            "thermostat energy is tracked by a single accumulator)")
    event_fixes = [f for f in sim.fixes
                   if isinstance(f, (Extrusion, ExLoad, ExUnload))]
    from ..fixes.registry import custom_hooks, style_of

    for f in sim.fixes:
        if not isinstance(f, (NVE, NVELimit, Langevin, Extrusion, ExLoad,
                              ExUnload)) and style_of(f) is None:
            raise ValueError(
                f"fix {type(f).__name__} is neither built-in nor a "
                "registered fix style (fixes.registry.register_fix_style)")
    cust_post_int = [b(system, f)
                     for f, b in custom_hooks(sim.fixes, "post_integrate")]
    cust_post_force = [b(system, f)
                       for f, b in custom_hooks(sim.fixes, "post_force")]
    cust_eos = [b(system, f)
                for f, b in custom_hooks(sim.fixes, "end_of_step")]
    if event_fixes:
        s12, s13, s14 = system.special_lj
        if s13 != 1.0 or s14 != 1.0:
            # an extruder bond across 2-3 chain hops would have both the
            # chain tier's and the extruder's corrections subtracted
            # (the reference respecials the pair into the 1-2 tier,
            # fix_extrusion.cpp:743-771)
            raise ValueError(
                "extruder fixes require special_bonds with 1-3/1-4 lj "
                f"weights of 1.0 (got {s13}, {s14}); use 'special_bonds "
                "fene' (0,1,1)")
    makers = {Extrusion: make_extrusion_update, ExLoad: make_ex_load_update,
              ExUnload: make_ex_unload_update}
    event_updates = [(f, fid, makers[type(f)](system, f, device))
                     for fid, f in enumerate(event_fixes)]
    nve_masks = [group_mask(f.group) for f in nve_fixes]
    lan_masks = [group_mask(f.group) for f in langevin_fixes]
    np_dtype = NP_DTYPE[getattr(torch, system.dtype)]
    if gjf_fix is not None:
        # Gronbech-Jensen/Farago (Mol. Phys. 111, 2013): with c = dt /
        # (2 damp), a = (1 - c)/(1 + c) damps, b = 1/(1 + c) scales the
        # drift; the noise is a gaussian velocity impulse of variance
        # 2 kT dt / (damp m) entering both kicks
        gjf_c = dt / (2.0 * gjf_fix.damp)
        gjf_a = (1.0 - gjf_c) / (1.0 + gjf_c)
        gjf_b = 1.0 / (1.0 + gjf_c)
        gjf_gm = lan_masks[gjf_lid]
    vhalf = gjf_fix is not None and gjf_fix.gjf == "vhalf"

    def t_target(lf, step_no, run_begin, run_end):
        """The t_start -> t_stop ramp over the run (fix_langevin.cpp:
        97-145), in the state's precision, on the host."""
        if run_begin is None or lf.t_stop == lf.t_start:
            return np_dtype(lf.t_start)
        span = max(np_dtype(run_end - run_begin), np_dtype(1.0))
        frac = np.clip(np_dtype(step_no - run_begin) / span, np_dtype(0.0),
                       np_dtype(1.0))
        return np_dtype(lf.t_start) + frac * (np_dtype(lf.t_stop)
                                              - np_dtype(lf.t_start))

    def step(state: State, step_no: int, key_words, run_begin=None,
             run_end=None) -> State:
        dtype = state.x.dtype
        dev = state.x.device
        m = _masses(state, system)

        if gjf_fix is not None:
            kT = units.boltz * t_target(gjf_fix, step_no, run_begin, run_end)
            sigma = torch.sqrt(float(2.0 * dt * kT)
                               / (gjf_fix.damp * m * units.mvv2e))

            def gjf_noise(at_step):
                key = _fold3(key_words, at_step, (_GJF_KIND << 20) + gjf_lid,
                             gjf_fix.seed)
                dv = sigma * rng.normal(key, tuple(state.v.shape), dev,
                                        dtype)
                if gjf_fix.zero:
                    # the random force sums to zero over the group each
                    # step (fix_langevin.cpp Tp_ZERO): centring each noise
                    # stream gives the same zero total impulse
                    dv = _group_mean(dv, gjf_gm, dtype)
                return dv

        # --- initial integrate: half kick + drift (fix_nve.cpp:64-103) ---
        v = state.v
        x = state.x
        if vhalf:
            # 2GJ leapfrog (Gronbech Jensen & Gronbech-Jensen, Mol. Phys.
            # 117, 2019): v holds the half-step velocity scaled by
            # 1/sqrt(b); group beads do their whole step here and skip the
            # final kick
            sqb = gjf_b ** 0.5
            dv_prev = gjf_noise(step_no - 1)
            dv_cur = gjf_noise(step_no)
            kick = dt * units.ftm2v * state.f / m
            u_new = gjf_a * v + sqb * kick + 0.5 * sqb * (dv_prev + dv_cur)
            vh_plain = v + dtf * state.f / m
            if gjf_fix.tally:
                # the thermostat's velocity increment against the plain
                # leapfrog kick, for the tally below
                gjf_dvt = u_new - (v + kick)
                if gjf_gm is not None:
                    gjf_dvt = torch.where(gjf_gm, gjf_dvt, 0.0)
            if gjf_gm is None:
                v = u_new
                x = x + dt * sqb * u_new
            else:
                v = torch.where(gjf_gm, u_new, vh_plain)
                x = x + dt * torch.where(gjf_gm, sqb * u_new, vh_plain)
        elif gjf_fix is not None:  # vfull: the on-site velocity
            dv_cur = gjf_noise(step_no)
            vh = v + dtf * state.f / m
            v_drift = gjf_b * (vh + 0.5 * dv_cur)
            v_store = gjf_a * vh + gjf_b * dv_cur
            if gjf_fix.tally:
                gjf_dvt = v_store - vh
                if gjf_gm is not None:
                    gjf_dvt = torch.where(gjf_gm, gjf_dvt, 0.0)
            if gjf_gm is None:
                v = v_store
                x = x + dt * v_drift
            else:
                v = torch.where(gjf_gm, v_store, vh)
                x = x + dt * torch.where(gjf_gm, v_drift, vh)
        else:
            for f, gm in zip(nve_fixes, nve_masks):
                vh = v + dtf * state.f / m
                if isinstance(f, NVELimit):
                    # cap the per-step displacement (fix_nve_limit.cpp)
                    vsq = torch.sum(vh * vh, dim=-1, keepdim=True)
                    vmax = f.xmax / dt
                    vh = vh * torch.where(vsq > vmax * vmax,
                                          vmax / torch.sqrt(vsq), 1.0)
                dx = dt * vh
                if gm is None:
                    v = vh
                    x = x + dx
                else:
                    v = torch.where(gm, vh, v)
                    x = torch.where(gm, x + dx, x)
        state = state.replace(x=x, v=v, step=state.step + 1)

        # --- post integrate: the LE fixes at their phases ---
        for f, fid, update in event_updates:
            if step_no % f.nevery != f.phase:
                continue
            key = _fold3(key_words, step_no, (_KIND[type(f)] << 20) + fid,
                         f.seed)
            last = state.last_event.clone()
            if isinstance(f, ExUnload):
                left, right, nb = update(state.x, state.ex_left,
                                         state.ex_right, key)
                last[2] = nb
                state = state.replace(n_unloads=state.n_unloads + nb)
            else:
                occ = extruder_occupancy(state, system.n)
                out = update(state.x, state.type, state.ex_left,
                             state.ex_right, occ, key)
                if isinstance(f, Extrusion):
                    left, right, nm, nrel = out
                    last[0] = nm
                    state = state.replace(n_moves=state.n_moves + nm,
                                          n_unloads=state.n_unloads + nrel)
                else:
                    left, right, types, nc, fl = out
                    last[1] = nc
                    state = state.replace(type=types,
                                          n_loads=state.n_loads + nc,
                                          flags=state.flags | fl)
            state = state.replace(ex_left=left, ex_right=right,
                                  last_event=last)
        for hook in cust_post_int:
            state = hook(state, step_no)

        state = _maybe_rebuild(state, system, step_no)

        # --- forces (energies on the thermo cadence) ---
        fr = _force_pass(state, sim, step_no % sim.energy_every == 0)
        f_total = fr.f

        # --- post force: langevin drag + uniform noise
        #     (fix_langevin.cpp:654-674) ---
        tally_terms = []
        for lid, (lf, gm) in enumerate(zip(langevin_fixes, lan_masks)):
            if lf is gjf_fix:
                continue  # GJF's drag and noise live in the kicks
            key = _fold3(key_words, step_no, (_LANGEVIN_KIND << 20) + lid,
                         lf.seed)
            gamma1 = -m / lf.damp / units.ftm2v
            gamma2 = (torch.sqrt(m) * math.sqrt(
                24.0 * units.boltz / (lf.damp * dt) / units.mvv2e)
                / units.ftm2v) * float(np.sqrt(
                    t_target(lf, step_no, run_begin, run_end)))
            noise = rng.uniform(key, tuple(state.v.shape), dev, dtype) - 0.5
            fr_rand = gamma2 * noise
            if lf.zero:
                fr_rand = _group_mean(fr_rand, gm, dtype)
            fl = gamma1 * state.v + fr_rand
            fl = fl if gm is None else torch.where(gm, fl, 0.0)
            f_total = f_total + fl
            if lf.tally:
                tally_terms.append(fl)
        for hook in cust_post_force:
            f_total = hook(state, f_total, step_no)

        # --- final integrate: half kick (fix_nve.cpp:108-140) ---
        v = state.v
        for f, gm in zip(nve_fixes, nve_masks):
            vn = v + dtf * f_total / m
            if isinstance(f, NVELimit):
                vsq = torch.sum(vn * vn, dim=-1, keepdim=True)
                vmax = f.xmax / dt
                vn = vn * torch.where(vsq > vmax * vmax,
                                      vmax / torch.sqrt(vsq), 1.0)
            if vhalf:
                # the half-step-velocity beads finished their step above
                vn = v if gjf_gm is None else torch.where(gjf_gm, v, vn)
            v = vn if gm is None else torch.where(gm, vn, v)

        # ``tally yes``: cumulative thermostat energy, the reference's
        # sign (FixLangevin::compute_scalar; end_of_step sums
        # flangevin . v at the post-kick velocities)
        therm_e = state.therm_e
        for fl in tally_terms:
            therm_e = therm_e - dt * torch.sum(fl * v)
        if gjf_fix is not None and gjf_fix.tally:
            # the exact kinetic-energy increment the GJF thermostat made
            # this step (verlet.py:513-530)
            vm = v - gjf_dvt
            therm_e = therm_e - 0.5 * units.mvv2e * torch.sum(
                m * (v * v - vm * vm))

        finite = torch.isfinite(fr.epair) & torch.isfinite(fr.ebond)
        state = state.replace(
            v=v, f=f_total, epair=fr.epair, ebond=fr.ebond, therm_e=therm_e,
            flags=state.flags | fr.flags
            | (~finite).to(torch.int64) * FLAG_NON_FINITE)

        # --- end of step: registered hooks (modify.cpp:481) ---
        for hook in cust_eos:
            state = hook(state, step_no)
        return state

    return step


def setup(sim: Simulation, state: State) -> State:
    """Wrap, the first neighbour build and force evaluation
    (Verlet::setup, verlet.cpp:87-156), on the state's device."""
    system = sim.system
    x, img = cells.wrap_positions(state.x, system, state.img)
    state = state.replace(x=x, img=img, nbr=None)
    if system.neighbor.use_cells:
        nbr, fl = _build_nbr(state.x, system)
        state = state.replace(nbr=nbr, flags=state.flags | fl)
    fr = _force_pass(state, sim)
    return state.replace(f=fr.f, epair=fr.epair, ebond=fr.ebond,
                         flags=state.flags | fr.flags)


def host_row(row: ThermoSample) -> ThermoSample:
    """A thermo row's values on the host (one read of the card)."""
    vals = torch.stack([t.to(torch.float64) for t in row]).tolist()
    return ThermoSample(int(vals[0]), *vals[1:6], int(vals[6]))


def run(sim: Simulation, state: State, nsteps: int,
        groups: Optional[dict] = None, thermo_every: int = 0,
        thermo_callback=None, max_segment: int = 500,
        boundary_every: int = 0, boundary_callback=None):
    """Drive ``nsteps`` on the state's device, returning (State, thermo
    rows) (verlet.py:631): setup, then the steps; a row (values on the
    host) after setup, at every absolute multiple of ``thermo_every`` and
    at the run's end (thermo.cpp:324), each also passed with the State to
    ``thermo_callback``; ``boundary_callback(State)`` at absolute
    multiples of ``boundary_every`` (the dump cadence).  The run reads the
    card for the start step and key once, for rows, and once a
    ``max_segment`` steps issued since its last read (the reference's
    bound on the steps of one device call, verlet.py:687-694): no step
    waits on the card otherwise, and the results do not depend on it."""
    if max_segment < 1:
        raise ValueError(f"run: max_segment {max_segment} < 1")
    system = sim.system
    step = make_step(sim, groups, device=state.x.device)
    state = setup(sim, state)
    begin = int(state.step)
    key_words = tuple(state.key.tolist())
    rows = []
    issued = 0

    def emit(state):
        row = host_row(thermo_row(state, system))
        rows.append(row)
        if thermo_callback:
            thermo_callback(row, state)

    if thermo_every > 0:
        emit(state)
    if boundary_callback and boundary_every > 0 \
            and begin % boundary_every == 0:
        boundary_callback(state)
    for k in range(1, nsteps + 1):
        step_abs = begin + k
        state = step(state, step_abs, key_words, begin, begin + nsteps)
        issued += 1
        if thermo_every > 0 and (step_abs % thermo_every == 0
                                 or k == nsteps):
            emit(state)
            issued = 0
        elif issued == max_segment and k < nsteps:
            int(state.step)
            issued = 0
        if boundary_callback and boundary_every > 0 \
                and step_abs % boundary_every == 0:
            boundary_callback(state)
    return state, rows
