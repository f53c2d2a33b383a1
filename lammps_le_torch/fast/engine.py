"""Grid-resident fast engine: the production path of LE runs
(``lammps_le_tpu/fast/engine.py``, reactive XLA-chain step semantics).

The dynamic state stays in the cell-grid layout between rebuilds: (3, cap,
P) position/velocity/force planes plus (cap, P) bead-id, has-next-link and
extruder-partner planes.  A step is, in the reference's order:

* rebuild first when due (static cadence, LE-event step, or the skin
  trigger the previous step armed) — engine.py:1358;
* half kick + drift + halo refresh (``kick_drift_halo``);
* LE events (extrusion / ex_load / ex_unload) in bead layout, then the
  post-event rebuild;
* forces: the 27-offset LJ + FENE + exclusion stencil
  (``stencil_forces``) and the extruder springs (``extruder_springs``),
  energies on ``energy_every`` steps;
* Langevin with the t ramp, the final kick, and the skin monitor whose
  per-bead look-ahead arms the next step's rebuild
  (``langevin_kick_monitor``).

The four kernels are ``fast/kernels.py``; placement, events and thermo are
plain PyTorch.  The host drives the step loop: it reads the armed skin
trigger once per step (one device sync), everything else stays queued.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import rng
from ..fixes.config import NVE, ExLoad, ExUnload, Extrusion, Langevin
from ..fixes.ex_load import make_ex_load_update
from ..fixes.ex_unload import make_ex_unload_update
from ..fixes.extrusion import make_extrusion_update
from ..state import FLAG_NON_FINITE, State, extruder_partner
from ..system import BOND_FENE, BOND_HARMONIC, System
from . import kernels as K
from .consts import SpringConsts, StencilConsts
from .maps import FastMaps, fast_maps
from .place import GridConsts, ex_slots, halo_refresh_int, place


@dataclasses.dataclass
class FastState:
    """Grid-resident state of one run (engine.py:152).  ``step`` and
    ``n_rebuilds`` are host ints: the host drives the step loop."""

    gx: torch.Tensor         # (3, cap, P) positions (halo = shifted copies)
    gv: torch.Tensor         # (3, cap, P) velocities (interior valid)
    gf: torch.Tensor         # (3, cap, P) forces of the last evaluation
    gx_ref: torch.Tensor     # (3, cap, P) positions at the last rebuild
    bid: torch.Tensor        # (cap, P) int32 bead id, N = empty
    hn: torch.Tensor         # (cap, P) bool has-chain-next
    pid: torch.Tensor        # (cap, P) int32 extruder partner, -1
    slot_of: torch.Tensor    # (N,) int64 flat slot of bead (r*P + col)
    exl_slot: torch.Tensor   # (E,) int32 slot of left anchors
    exr_slot: torch.Tensor   # (E,) int32
    types: torch.Tensor      # (N,) int64
    img: torch.Tensor        # (N, 3) int64 (updated at rebuild)
    ex_left: torch.Tensor    # (E,) int64 bead ids
    ex_right: torch.Tensor   # (E,) int64
    key_words: tuple         # (k0, k1) raw key words as host ints
    step: int
    flags: torch.Tensor      # () int64 sticky bits
    epair: torch.Tensor
    ebond: torch.Tensor
    n_moves: torch.Tensor
    n_loads: torch.Tensor
    n_unloads: torch.Tensor
    n_clamps: torch.Tensor   # FENE clamp events (warning class)
    last_event: torch.Tensor  # (3,) counts at the latest events
    skin_pend: torch.Tensor  # () int64: next step rebuilds first
    n_rebuilds: int = 0


class ThermoSample(NamedTuple):
    step: int
    temp: torch.Tensor
    epair: torch.Tensor
    ebond: torch.Tensor
    ke: torch.Tensor
    etotal: torch.Tensor
    n_extruders: torch.Tensor


# ---------------------------------------------------------------------------
# support check


def fast_block_reason(sim) -> None:
    """Raise NotImplementedError naming what this engine does not cover
    (the reference's fast_block_reason checks, engine.py:240, plus the
    options this port does not have yet); return None when covered.  A
    Simulation is never quietly run on something else."""
    system = sim.system
    reason = None
    bts = np.asarray(system.backbone_type)
    used = bts[bts >= 0]
    if not system.neighbor.use_cells or system.neighbor.mode != "grid":
        reason = "neighbor mode is not the dense cell grid"
    elif system.pair is None or not all(
            bool(np.all(np.asarray(a) == np.asarray(a).flat[0]))
            for a in (system.pair.epsilon, system.pair.sigma,
                      system.pair.cutoff)):
        reason = "per-type pair coefficients differ (uniform-LJ fast path)"
    elif not bool(np.all(system.masses == system.masses.flat[0])):
        reason = "per-type masses differ"
    elif tuple(system.special_lj) != (0.0, 1.0, 1.0):
        reason = f"special_bonds {system.special_lj} (fast path is 0/1/1)"
    elif system.bonds is None:
        reason = "no bond styles defined"
    elif system.angles is not None:
        reason = "angle styles present (chain-bending is general-engine)"
    elif used.size and (np.any(used != used[0]) or int(
            system.bonds.style[used[0]]) != BOND_FENE):
        reason = "backbone bonds are not a single FENE type"
    elif sim.ex_btype > 0 and int(system.bonds.style[sim.ex_btype - 1]) \
            not in (BOND_FENE, BOND_HARMONIC):
        reason = "extruder bond style is neither FENE nor harmonic"
    n_nve = n_lan = 0
    for f in sim.fixes:
        if reason:
            break
        if type(f) is NVE:
            if f.group is not None:
                reason = "fix nve with a group (fast path integrates all)"
            n_nve += 1
        elif type(f) is Langevin:
            if f.tally or f.gjf != "no" or f.zero or f.group is not None:
                reason = ("fix langevin tally/gjf/zero/group is not "
                          "ported yet")
            n_lan += 1
        elif type(f) not in (Extrusion, ExLoad, ExUnload):
            reason = f"fix {type(f).__name__} is not ported"
        elif f.group is not None:
            reason = f"fix {type(f).__name__} with a group"
    if not reason and n_nve != 1:
        reason = f"{n_nve} fix nve (fast path needs exactly one)"
    if not reason and n_lan > 1:
        reason = f"{n_lan} fix langevin (fast path supports at most one)"
    if reason:
        raise NotImplementedError(f"lammps_le_torch fast engine: {reason}")
    return None


# ---------------------------------------------------------------------------
# static context


@dataclasses.dataclass
class _Ctx:
    system: System
    maps: FastMaps
    g: GridConsts
    C: StencilConsts
    S: object            # SpringConsts or None


def _ctx(sim, device) -> _Ctx:
    fast_block_reason(sim)
    system = sim.system
    maps = fast_maps(system)
    np_dtype = np.float32 if system.dtype == "float32" else np.float64
    return _Ctx(
        system=system, maps=maps,
        g=GridConsts.build(system, maps, device),
        C=StencilConsts(system, np_dtype),
        S=SpringConsts(system, sim.ex_btype) if sim.ex_btype > 0 else None,
    )


def _forces(ctx: _Ctx, gx, bid, hn, pid, exl, exr, active, energy: bool):
    """Stencil + extruder springs.  Returns (gf, energies (2,), ints (2,)
    = [flag bits, clamps])."""
    system, maps = ctx.system, ctx.maps
    gf, en, ints = K.stencil_forces(gx, bid, hn, pid, ctx.g.interior, ctx.C,
                                    system.n, maps.strides, energy)
    if ctx.S is not None:
        eb = K.extruder_springs(gx, gf, exl, exr, active, ctx.S)
        if energy:
            en = en + torch.stack([torch.zeros_like(en[0]), eb.sum()])
    return gf, en, ints


def extract_beads(fs: FastState, maps: FastMaps):
    """(x, v, f) in bead layout (engine._extract_beads)."""
    capP = maps.cap * maps.P
    slot = torch.clamp(fs.slot_of, 0, capP - 1)
    return tuple(p.reshape(3, capP)[:, slot].T
                 for p in (fs.gx, fs.gv, fs.gf))


# ---------------------------------------------------------------------------
# conversion


def to_fast(state: State, sim) -> FastState:
    """Bead-layout State -> grid residency, with initial forces and
    energies (engine.to_fast, the Verlet::setup analog)."""
    ctx = _ctx(sim, state.x.device)
    system = ctx.system
    (gx, gv, _, bid, hn, pid, slot_of, exl, exr, _, img, overflow) = place(
        system, ctx.maps, ctx.g, state.x, state.v, state.f, state.ex_left,
        state.ex_right, state.img)
    gf, en, ints = _forces(ctx, gx, bid, hn, pid, exl, exr,
                           state.ex_left >= 0, True)
    return FastState(
        gx=gx, gv=gv, gf=gf, gx_ref=gx, bid=bid, hn=hn, pid=pid,
        slot_of=slot_of, exl_slot=exl, exr_slot=exr, types=state.type,
        img=img, ex_left=state.ex_left, ex_right=state.ex_right,
        key_words=tuple(state.key.tolist()),
        step=int(state.step), flags=state.flags | overflow
        | ints[0], epair=en[0], ebond=en[1], n_moves=state.n_moves,
        n_loads=state.n_loads, n_unloads=state.n_unloads, n_clamps=ints[1],
        last_event=state.last_event,
        skin_pend=torch.zeros((), dtype=torch.int64, device=gx.device),
    )


def from_fast(fs: FastState, system: System) -> State:
    """Back to the bead-layout State (engine.from_fast)."""
    x, v, f = extract_beads(fs, fast_maps(system))
    return State(
        x=x, v=v, f=f, img=fs.img, type=fs.types, ex_left=fs.ex_left,
        ex_right=fs.ex_right,
        key=torch.tensor(fs.key_words, dtype=torch.int64, device=x.device),
        step=torch.tensor(fs.step, dtype=torch.int64, device=x.device),
        flags=fs.flags, epair=fs.epair, ebond=fs.ebond,
        n_moves=fs.n_moves, n_loads=fs.n_loads, n_unloads=fs.n_unloads,
        last_event=fs.last_event, therm_e=torch.zeros_like(fs.epair),
    )


def thermo_row_fast(fs: FastState, system: System) -> ThermoSample:
    """Thermo straight from the planes (engine.thermo_row_fast)."""
    maps = fast_maps(system)
    mass = float(np.asarray(system.masses).flat[0])
    interior = torch.as_tensor(maps.interior, device=fs.gv.device)
    valid = (fs.bid < system.n) & interior[None, :]
    vv = torch.sum(fs.gv * fs.gv, dim=0)
    ke2 = mass * torch.sum(torch.where(valid, vv, torch.zeros_like(vv)))
    temp = ke2 / ((3.0 * system.n - 3.0) * system.units.boltz)
    ke = 0.5 * ke2
    return ThermoSample(
        step=fs.step, temp=temp, epair=fs.epair, ebond=fs.ebond, ke=ke,
        etotal=ke + fs.epair + fs.ebond,
        n_extruders=torch.sum(fs.ex_left >= 0))


# ---------------------------------------------------------------------------
# the step


def make_fast_segment(sim, device):
    """Build ``segment(fs, step0, length, run_begin, run_end) -> fs``
    advancing ``length`` steps in place (the reactive XLA-chain semantics
    of engine.make_fast_segment, engine.py:1102-1455)."""
    ctx = _ctx(sim, device)
    system, maps, g = ctx.system, ctx.maps, ctx.g
    n = system.n
    cap, P = maps.cap, maps.P
    capP = cap * P
    dt = sim.dt
    units = system.units
    mass = float(np.asarray(system.masses).flat[0])
    kick = 0.5 * dt * units.ftm2v / mass
    K_every = max(int(system.neighbor.rebuild_every), 1)
    energy_every = max(int(sim.energy_every), 1)
    np_dtype = np.float32 if system.dtype == "float32" else np.float64

    lan = [f for f in sim.fixes if isinstance(f, Langevin)]
    lf = lan[0] if lan else None
    if lf is not None:
        g2base = float(np.sqrt(mass) * np.sqrt(
            24.0 * units.boltz / (lf.damp * dt) / units.mvv2e) / units.ftm2v)

        @functools.lru_cache(maxsize=4)
        def lan_words(key_words):
            # run-constant noise key: the step enters through the
            # threefry counter, not the key (engine.py:1393-1403)
            return rng.fold_in(rng.fold_in(key_words, 4 << 20), lf.seed)

    event_fixes = [f for f in sim.fixes
                   if isinstance(f, (Extrusion, ExLoad, ExUnload))]
    makers = {Extrusion: make_extrusion_update, ExLoad: make_ex_load_update,
              ExUnload: make_ex_unload_update}
    kinds = {Extrusion: 1, ExLoad: 2, ExUnload: 3}
    event_updates = [(f, fid, makers[type(f)](system, f, device))
                     for fid, f in enumerate(event_fixes)]
    event_phases = [(f.nevery, f.phase) for f in event_fixes]

    # half-skin from the real cell margin (engine.py:1154-1162)
    min_edge = min(b / d for b, d in zip(
        system.box_size,
        (system.neighbor.nx, system.neighbor.ny, system.neighbor.nz)))
    max_cut = float(np.max(np.asarray(system.pair.cutoff)))
    halfskin = 0.5 * max(min_edge - max_cut, 1e-6)
    bad_cut = 2.0 * halfskin     # pairwise coverage bound (skin_check)
    trig_cut = 0.85 * halfskin   # per-bead look-ahead trigger

    def rebuild(fs: FastState):
        x, v, f = extract_beads(fs, maps)
        (fs.gx, fs.gv, fs.gf, fs.bid, fs.hn, fs.pid, fs.slot_of,
         fs.exl_slot, fs.exr_slot, _, fs.img, overflow) = place(
            system, maps, g, x, v, f, fs.ex_left, fs.ex_right, fs.img)
        fs.gx_ref = fs.gx
        fs.flags = fs.flags | overflow
        fs.skin_pend = torch.zeros_like(fs.skin_pend)
        fs.n_rebuilds += 1

    def retable(fs: FastState, left, right):
        """Partner plane + anchor slots after an extruder-table edit."""
        fs.ex_left, fs.ex_right = left, right
        partner = extruder_partner(left, right, n)
        pid = torch.full((capP + n,), -1, dtype=torch.int32, device=device)
        pid[fs.slot_of] = partner.to(torch.int32)
        fs.pid = halo_refresh_int(pid[:capP].reshape(1, cap, P), g)[0]
        fs.exl_slot, fs.exr_slot = ex_slots(fs.slot_of, left, right)

    def apply_events(fs: FastState, sstep: int):
        """LE fixes in bead layout (engine.py:1205-1245)."""
        for f, fid, update in event_updates:
            if sstep % f.nevery != f.phase:
                continue
            key = rng.fold_in(rng.fold_in(rng.fold_in(fs.key_words, sstep),
                                          (kinds[type(f)] << 20) + fid),
                              f.seed)
            x = extract_beads(fs, maps)[0]
            occ = extruder_partner(fs.ex_left, fs.ex_right, n) >= 0
            last = fs.last_event.clone()
            if isinstance(f, Extrusion):
                l, r, nm, nrel = update(x, fs.types, fs.ex_left,
                                        fs.ex_right, occ, key)
                fs.n_moves = fs.n_moves + nm
                fs.n_unloads = fs.n_unloads + nrel
                last[0] = nm
            elif isinstance(f, ExLoad):
                l, r, t, nc, fl = update(x, fs.types, fs.ex_left,
                                         fs.ex_right, occ, key)
                fs.types = t
                fs.n_loads = fs.n_loads + nc
                fs.flags = fs.flags | fl
                last[1] = nc
            else:
                l, r, nb = update(x, fs.ex_left, fs.ex_right, key)
                fs.n_unloads = fs.n_unloads + nb
                last[2] = nb
            fs.last_event = last
            retable(fs, l, r)

    def step(fs: FastState, sstep: int, run_begin: int, run_end: int):
        # rebuilds due by cadence, LE-event phase or the armed skin
        # trigger are served BEFORE the drift (engine.py:1349-1360)
        event = any(sstep % nev == ph for nev, ph in event_phases)
        if sstep % K_every == 0 or event or bool(fs.skin_pend):
            rebuild(fs)
        fs.gx, fs.gv = K.kick_drift_halo(
            fs.gx, fs.gv, fs.gf, fs.bid, g.interior, g.halo_cols,
            g.halo_src, g.halo_shift, n, kick, dt)
        fs.step = sstep
        if event:
            apply_events(fs, sstep)
            rebuild(fs)

        energy = sstep % energy_every == 0
        gf, en, ints = _forces(ctx, fs.gx, fs.bid, fs.hn, fs.pid,
                               fs.exl_slot, fs.exr_slot, fs.ex_left >= 0,
                               energy)
        fs.flags = fs.flags | ints[0]
        fs.n_clamps = fs.n_clamps + ints[1]
        if energy:
            fs.epair, fs.ebond = en[0], en[1]
            fs.flags = fs.flags | (~torch.all(torch.isfinite(en))).to(
                torch.int64) * FLAG_NON_FINITE

        gamma1 = gamma2 = 0.0
        lan_key = (0, 0)
        if lf is not None:
            gamma1 = -mass / lf.damp / units.ftm2v
            lan_key = lan_words(fs.key_words)
            # t_start -> t_stop ramp (fix_langevin.cpp:97-145), in the
            # run's float type as the reference computes it
            span = max(np_dtype(run_end - run_begin), np_dtype(1.0))
            frac = np.clip(np_dtype(sstep - run_begin) / span,
                           np_dtype(0.0), np_dtype(1.0))
            t0 = np_dtype(lf.t_start)
            t_target = t0 + frac * (np_dtype(lf.t_stop) - t0)
            gamma2 = float(np_dtype(g2base) * np.sqrt(t_target))
        fs.gf, fs.gv, mon = K.langevin_kick_monitor(
            fs.gx, fs.gx_ref, fs.gv, gf, fs.bid, g.interior, lan_key, sstep,
            gamma1, gamma2, kick, dt, bad_cut,
            trig_cut, n, lf is not None)
        fs.flags = fs.flags | mon[0]
        fs.skin_pend = mon[1]
        return fs

    def segment(fs: FastState, step0: int, length: int, run_begin: int,
                run_end: int):
        for i in range(length):
            step(fs, step0 + i + 1, run_begin, run_end)
        return fs

    return segment


def run_fast(sim, state: State, nsteps: int) -> State:
    """Drive ``nsteps`` on the fast engine as one run (engine.run_fast,
    without its thermo rows: ``thermo_row_fast`` reads them from a
    FastState)."""
    segment = make_fast_segment(sim, state.x.device)
    fs = to_fast(state, sim)
    begin = fs.step
    segment(fs, begin, nsteps, begin, begin + nsteps)
    return from_fast(fs, sim.system)
