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
* forces: the LJ + FENE + exclusion stencil that ``select_kernel``
  picks — the full 27-offset ``stencil_forces`` up to the reference's
  whole-plane gate, the Newton-half ``newton_half_forces``
  (``blocked_kernel.py``) past it — and the extruder springs
  (``extruder_springs``), energies on ``energy_every`` steps;
* Langevin with the t ramp (over the fix's group, with ``zero`` its
  random force summing to zero over the group), the final kick, and the
  skin monitor whose per-bead look-ahead arms the next step's rebuild
  (``langevin_kick_monitor``).

The kernels are ``fast/kernels.py``; placement, events and thermo are
plain PyTorch.  Two modes run these steps (``make_fast_segment``'s
``pallas``): the chain, which issues each step's kernels from the host and
reads the armed skin trigger once a step (one device sync), and K2's step
loop (``pallas_step.py``), which runs up to LAUNCH_MAX steps a launch on
the card, stopped by the in-launch trigger, with one read a launch; the
boundary work of a launch's first step (rebuild, LE events) stays on the
host.  Within the whole-plane gate the card takes the step loop.

``reactive=False`` replaces the skin trigger by a static schedule
(engine.py:1175-1200): the cadence, each LE event step and every step of
each extrusion fix's post-event hot window rebuild, after the drift and
the events, and nothing is read from the card a step.  On that chain a
FastState may hold R replicas stacked on a leading axis
(``run_fast_replicas``, the reference's ``jax.vmap``): every gate keys on
the shared step, each kernel is one launch for all R, placement one sort
for all, and only the LE events loop over the replicas.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import rng
from ..fixes.config import NVE, ExLoad, ExUnload, Extrusion, Langevin
from ..fixes.ex_load import make_ex_load_update
from ..fixes.ex_unload import make_ex_unload_update
from ..fixes.extrusion import make_extrusion_update
from ..state import (FLAG_BOND_REACH, FLAG_FENE_CLAMP, FLAG_NON_FINITE,
                     FLAG_SKIN_VIOLATION, State, _partner_table)
from ..system import BOND_FENE, BOND_HARMONIC, System
from . import kernels as K
from . import kernels_ref as R
from .blocked_kernel import make_blocked_kernel
from .consts import SpringConsts, StencilConsts
from .maps import FastMaps, fast_maps
from .pallas_step import LAUNCH_MAX, make_step_kernel, skin_cuts
from .place import (GridConsts, ex_slots, halo_refresh_int, place,
                    place_replicas)


@dataclasses.dataclass
class FastState:
    """Grid-resident state of one run (engine.py:152).  ``step``,
    ``skin_pend``, ``n_rebuilds`` and ``n_launches`` are host ints: the
    host drives the step loop.

    R replicas (``stack_fast``): every tensor field gains a leading R axis
    (planes (R, 3, cap, P) and (R, cap, P), scalars (R,)) and
    ``key_words`` is a tuple of R word pairs; the host ints stay shared
    ints, as every replica steps on the same schedule."""

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
    skin_pend: int           # 1: the next step rebuilds first
    n_rebuilds: int = 0
    n_launches: int = 0      # step-loop launches (engine.py:200-207)
    # (cap, P) 0/1 Langevin-group membership plane in the run's float
    # type, re-placed at every rebuild; None when the thermostat covers
    # all beads (fix langevin <group>, engine.py:262-265)
    lgm: torch.Tensor = None

    @property
    def replicas(self):
        """R for a replica-batched state, None for one run's."""
        return self.bid.shape[0] if self.bid.dim() == 3 else None


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


def fast_block_reason(sim):
    """None when this engine covers ``sim``, else a one-line reason, the
    reference's text in the reference's order of checks (engine.py:240):
    the deck runner names it on its ``Engine:`` line.  The LE fixes' group
    is read by neither engine, so it blocks nothing."""
    system = sim.system
    if not system.neighbor.use_cells or system.neighbor.mode != "grid":
        return "neighbor mode is not the dense cell grid"
    pp = system.pair
    if pp is None or not all(
            bool(np.all(np.asarray(a) == np.asarray(a).flat[0]))
            for a in (pp.epsilon, pp.sigma, pp.cutoff)):
        return "per-type pair coefficients differ (uniform-LJ fast path)"
    if not bool(np.all(system.masses == system.masses.flat[0])):
        return "per-type masses differ"
    s12, s13, s14 = system.special_lj
    if s12 != 0.0 or s13 != 1.0 or s14 != 1.0:
        return f"special_bonds {s12}/{s13}/{s14} (fast path is 0/1/1)"
    if system.bonds is None:
        return "no bond styles defined"
    if system.angles is not None:
        return "angle styles present (chain-bending is general-engine)"
    bts = np.asarray(system.backbone_type)
    used = bts[bts >= 0]
    if used.size and (np.any(used != used[0]) or int(
            system.bonds.style[used[0]]) != BOND_FENE):
        return "backbone bonds are not a single FENE type"
    n_nve = n_lan = 0
    for f in sim.fixes:
        if type(f) is NVE:
            if f.group is not None:
                return "fix nve with a group (fast path integrates all)"
            n_nve += 1
        elif isinstance(f, Langevin):
            if f.tally or f.gjf != "no":
                # tally and gjf are general-engine options; zero and
                # group ride the fast path
                opt = "tally" if f.tally else f"gjf {f.gjf}"
                return f"fix langevin {opt} (general-engine option)"
            n_lan += 1
        elif not isinstance(f, (Extrusion, ExLoad, ExUnload)):
            return f"fix {type(f).__name__} is not fast-path capable"
    if sim.ex_btype > 0 and int(system.bonds.style[sim.ex_btype - 1]) \
            not in (BOND_FENE, BOND_HARMONIC):
        return "extruder bond style is neither FENE nor harmonic"
    if n_nve != 1:
        return f"{n_nve} fix nve (fast path needs exactly one)"
    if n_lan > 1:
        return f"{n_lan} fix langevin (fast path supports at most one)"
    return None


def fast_supported(sim) -> bool:
    """True when the Simulation can run on the grid-resident fast path
    (engine.py:298)."""
    return fast_block_reason(sim) is None


# ---------------------------------------------------------------------------
# the force stencil


def make_kernel(system: System, maps: FastMaps, ex_btype: int):
    """The full 27-offset stencil as ``kernel(g, gx, bid, hn, pid, energy)
    -> (gf, energies (2,), ints (2,))`` (engine.make_kernel, engine.py:618;
    ``ex_btype`` as there).  ``g`` is the run's GridConsts: the closure
    holds no tensor, so one closure serves runs on any device."""
    np_dtype = np.float32 if system.dtype == "float32" else np.float64
    C = StencilConsts(system, np_dtype)

    def kernel(g: GridConsts, gx, bid, hn, pid, energy: bool):
        return K.stencil_forces(gx, bid, hn, pid, g.interior, C, system.n,
                                maps.strides, energy)

    return kernel


def whole_planes_fit(maps: FastMaps) -> bool:
    """The reference's whole-plane gate (engine.py:789): the 100k-bead
    bench grid, cap 9 x P 33,664, is the largest whose planes its fused
    whole-step kernel holds in a TPU's VMEM."""
    return maps.cap * maps.P <= 9 * 33664


def select_kernel(system: System, maps: FastMaps, ex_btype: int):
    """The stencil of a run (engine.select_kernel, engine.py:803): the
    Newton-half kernel past the whole-plane gate in f32, else the full
    27-offset stencil.  The reference's LLE_FAST_PALLAS / LLE_BLOCKED
    switches are not ported: the port adds no switch."""
    if system.dtype == "float32" and not whole_planes_fit(maps):
        return make_blocked_kernel(system, maps, ex_btype)
    return make_kernel(system, maps, ex_btype)


# ---------------------------------------------------------------------------
# static context


@dataclasses.dataclass
class _Ctx:
    system: System
    maps: FastMaps
    g: GridConsts
    kernel: object       # the stencil (select_kernel's contract)
    S: object            # SpringConsts or None


def _ctx(sim, device, kernel_fn=None) -> _Ctx:
    reason = fast_block_reason(sim)
    if reason:
        # never a quiet run on something else: the caller picks the
        # general path (lammps_le_torch.integrate.run)
        raise NotImplementedError(
            f"lammps_le_torch fast engine: {reason}; run it on the general "
            "path (lammps_le_torch.integrate.run)")
    system = sim.system
    maps = fast_maps(system)
    return _Ctx(
        system=system, maps=maps,
        g=GridConsts.build(system, maps, device),
        kernel=kernel_fn or select_kernel(system, maps, sim.ex_btype),
        S=SpringConsts(system, sim.ex_btype) if sim.ex_btype > 0 else None,
    )


def _forces(ctx: _Ctx, gx, bid, hn, pid, exl, exr, active, energy: bool):
    """Stencil + extruder springs.  Returns (gf, energies (2,), ints (2,)
    = [flag bits, clamps]); (R, 2) each for R replicas' planes."""
    gf, en, ints = ctx.kernel(ctx.g, gx, bid, hn, pid, energy)
    if ctx.S is not None:
        eb = K.extruder_springs(gx, gf, exl, exr, active, ctx.S)
        if energy:
            en = en + torch.stack([torch.zeros_like(en[..., 0]),
                                   eb.sum(-1)], dim=-1)
    return gf, en, ints


def _beads(planes, slot):
    """(N, 3) values of (3, cap, P) planes at the flat slots (N,) (in
    range); (R, N, 3) of R replicas' at their (R, N) slots."""
    if slot.dim() == 1:
        return planes.reshape(3, -1)[:, slot].T
    flat = planes.reshape(planes.shape[:2] + (-1,))
    return torch.gather(flat, 2, slot[:, None, :].expand(
        -1, 3, -1)).transpose(1, 2)


def extract_beads(fs: FastState, maps: FastMaps):
    """(x, v, f) in bead layout (engine._extract_beads); (R, N, 3) each
    for R replicas."""
    slot = torch.clamp(fs.slot_of, 0, maps.cap * maps.P - 1)
    return tuple(_beads(p, slot) for p in (fs.gx, fs.gv, fs.gf))


# ---------------------------------------------------------------------------
# conversion


def _lan_member(sim, groups):
    """(N,) bool Langevin-group membership, or None for group-all
    (engine._lan_member, engine.py:955).

    ``groups``: the deck's name -> (N,) bool dict; required when the
    Simulation's Langevin fix names a group (fix_langevin.cpp groupbit)."""
    for f in sim.fixes:
        if isinstance(f, Langevin) and f.group is not None:
            if not groups or f.group not in groups:
                raise ValueError(
                    f"fix langevin group {f.group!r} needs the deck's "
                    "group masks (pass groups= to run_fast/to_fast)")
            return np.asarray(groups[f.group], bool)
    return None


def _lgm_plane(member, slot_of, maps: FastMaps, dtype):
    """Scatter (..., N) membership to (..., cap, P) 0/1 planes
    (engine._lgm_plane, engine.py:971; rebuild time only)."""
    capP = maps.cap * maps.P
    slot = torch.clamp(slot_of, 0, capP - 1)
    lead = tuple(slot.shape[:-1])
    flat = torch.zeros(lead + (capP,), dtype=dtype, device=slot_of.device)
    flat.scatter_(-1, slot, torch.as_tensor(
        member, device=slot_of.device).to(dtype).expand(slot.shape))
    return flat.reshape(lead + (maps.cap, maps.P))


def to_fast(state: State, sim, groups=None, *,
            kernel_fn=None) -> FastState:
    """Bead-layout State -> grid residency, with initial forces and
    energies (engine.to_fast, the Verlet::setup analog).  ``groups``: the
    deck's name -> (N,) bool masks, needed when the Langevin fix names a
    group; ``kernel_fn``: the stencil, as make_fast_segment's."""
    ctx = _ctx(sim, state.x.device, kernel_fn)
    system = ctx.system
    (gx, gv, _, bid, hn, pid, slot_of, exl, exr, _, img, overflow) = place(
        system, ctx.maps, ctx.g, state.x, state.v, state.f, state.ex_left,
        state.ex_right, state.img)
    member = _lan_member(sim, groups)
    lgm = (None if member is None else
           _lgm_plane(member, slot_of, ctx.maps, gx.dtype))
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
        skin_pend=0, lgm=lgm,
    )


def stack_fast(states) -> FastState:
    """R runs' FastStates as one replica-batched state: each tensor
    stacked on a leading axis (copies), the key words a tuple of their
    pairs.  The runs must agree on every other host int (the step, the
    rebuild and launch counts, a pending rebuild): the batched state
    holds one of each."""
    if any(fs.replicas for fs in states):
        raise ValueError("stack_fast: one run's states")
    kw = {}
    for field in dataclasses.fields(FastState):
        vals = [getattr(fs, field.name) for fs in states]
        if isinstance(vals[0], torch.Tensor):
            kw[field.name] = torch.stack(vals)
        elif field.name == "key_words":
            kw[field.name] = tuple(tuple(k) for k in vals)
        elif len(set(vals)) == 1:
            kw[field.name] = vals[0]
        else:
            raise ValueError(f"stack_fast: runs that differ in "
                             f"{field.name}: {vals}")
    return FastState(**kw)


def replica(fs: FastState, r: int) -> FastState:
    """Replica ``r`` of a replica-batched state as one run's FastState (its
    tensors are views of the batched state's)."""
    if not fs.replicas:
        raise ValueError("replica: the state holds one run")
    kw = {}
    for field in dataclasses.fields(FastState):
        val = getattr(fs, field.name)
        if isinstance(val, torch.Tensor) or field.name == "key_words":
            val = val[r]
        kw[field.name] = val
    return FastState(**kw)


def from_fast(fs: FastState, system: System, replica_index=None) -> State:
    """Back to the bead-layout State (engine.from_fast); of replica
    ``replica_index`` for a replica-batched state."""
    if fs.replicas:
        if replica_index is None:
            raise ValueError("from_fast: name the replica of a "
                             "replica-batched state")
        fs = replica(fs, replica_index)
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
    """Thermo straight from the planes (engine.thermo_row_fast); for R
    replicas each value (R,), as ``jax.vmap(thermo_row_fast)`` gives."""
    maps = fast_maps(system)
    mass = float(np.asarray(system.masses).flat[0])
    interior = torch.as_tensor(maps.interior, device=fs.gv.device)
    valid = (fs.bid < system.n) & interior
    vv = torch.sum(fs.gv * fs.gv, dim=-3)
    ke2 = mass * torch.sum(torch.where(valid, vv, torch.zeros_like(vv)),
                           dim=(-2, -1))
    temp = ke2 / ((3.0 * system.n - 3.0) * system.units.boltz)
    ke = 0.5 * ke2
    return ThermoSample(
        step=fs.step, temp=temp, epair=fs.epair, ebond=fs.ebond, ke=ke,
        etotal=ke + fs.epair + fs.ebond,
        n_extruders=torch.sum(fs.ex_left >= 0, dim=-1))


# ---------------------------------------------------------------------------
# the step


def _pallas_step_mode(system: System, pallas, device):
    """The step backend (engine._pallas_step_mode, engine.py:1079):
    ``"real"`` (K2's step loop on the card, kernels.StepLoop), ``"interpret"``
    (the same loop's plain version, on any device) or None (the chain).
    ``pallas`` None is auto: "real" for f32 planes on a CUDA device within
    the whole-plane gate, the chain past it (its stencil then the
    Newton-half one) and elsewhere; False is the chain.  The reference's
    LLE_PALLAS_STEP switch is not ported."""
    if pallas is None:
        pallas = ("real" if system.dtype == "float32"
                  and torch.device(device).type == "cuda"
                  and whole_planes_fit(fast_maps(system)) else None)
    mode = pallas or None
    if mode not in (None, "real", "interpret"):
        raise ValueError(f"pallas={pallas!r}: want None, False, 'real' or "
                         f"'interpret'")
    if mode == "real" and (torch.device(device).type != "cuda"
                           or system.dtype != "float32"):
        raise ValueError(f"pallas='real' runs f32 kernels on the card, not "
                         f"{system.dtype} on {device} ('interpret' runs the "
                         f"plain loop)")
    return mode


def rebuild_schedule(sim, reactive: bool = True, hot_window: int = None):
    """The steps a segment rebuilds on whatever the state, as ``due(sstep)
    -> bool`` (engine.py:1175-1200): the cadence ``rebuild_every``, each
    LE event phase and, without the skin trigger (``reactive=False``),
    each extrusion fix's post-event hot window ``((sstep - phase) %
    nevery) < w``, ``w`` = ``hot_window`` or min(150, max(nevery // 4,
    1)): a window after each extrusion event, whose springs snap shut,
    rebuilds every step, as the trigger would."""
    K_every = max(int(sim.system.neighbor.rebuild_every), 1)
    phases = [(f.nevery, f.phase) for f in sim.fixes
              if isinstance(f, (Extrusion, ExLoad, ExUnload))]
    hot = [] if reactive else [
        (f.nevery, f.phase, hot_window if hot_window is not None
         else min(150, max(f.nevery // 4, 1)))
        for f in sim.fixes if isinstance(f, Extrusion)]

    def due(sstep: int) -> bool:
        return (sstep % K_every == 0
                or any(sstep % nev == ph for nev, ph in phases)
                or any((sstep - ph) % nev < w for nev, ph, w in hot))

    return due


@dataclasses.dataclass(frozen=True)
class ChainParts:
    """The parts a step of the chain is made of (``chain_parts``): its
    stencil context and constants, the run's cadences and its boundary
    work, shared by make_fast_segment's steps and the step over the same
    state held in slabs (parallel/slab_step.py), whose boundary work runs
    on a FastState gathered from the slabs."""
    ctx: _Ctx
    kick: float
    dt: float
    energy_every: int           # the energy cadence (thermo's gcd)
    K_every: int                # the rebuild backstop
    event_phases: list          # (nevery, phase) of each LE event fix
    bad_cut: float              # the skin monitor's cuts (skin_cuts)
    trig_cut: float
    langevin: Optional[Langevin]
    zero: bool                  # fix langevin ... zero yes
    placement: Callable         # (fs, gx, gv, gf) -> a new grid
    commit: Callable            # (fs, placement) -> None
    rebuild: Callable           # (fs) -> None
    is_event: Callable          # (sstep) -> bool
    rebuild_due: Callable       # (fs, sstep) -> bool
    apply_events: Callable      # (fs, sstep) -> None
    tally: Callable             # (fs, energies, ints, energy) -> None
    langevin_args: Callable     # (fs, sstep, run_begin, run_end)
    ramp: Callable              # (sstep, run_begin, run_end)
    lan_words: Optional[Callable]  # run key words -> noise key words


def chain_parts(sim, thermo_every: int = 0, reactive: bool = True,
                hot_window: int = None, kernel_fn=None, *,
                device) -> ChainParts:
    """The chain's parts for ``make_fast_segment``'s arguments of the same
    names, on ``device``: ``kernel_fn`` the stencil (select_kernel's when
    None)."""
    ctx = _ctx(sim, device, kernel_fn)
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
    if thermo_every and thermo_every % energy_every:
        energy_every = int(np.gcd(thermo_every, energy_every))
    np_dtype = np.float32 if system.dtype == "float32" else np.float64

    lan = [f for f in sim.fixes if isinstance(f, Langevin)]
    lf = lan[0] if lan else None
    lan_zero = lf is not None and lf.zero
    if lf is not None:
        g2base = float(np.sqrt(mass) * np.sqrt(
            24.0 * units.boltz / (lf.damp * dt) / units.mvv2e) / units.ftm2v)

        @functools.lru_cache(maxsize=4)
        def lan_words(key_words):
            # run-constant noise key: the step enters through the
            # threefry counter, not the key (engine.py:1393-1403)
            return rng.fold_in(rng.fold_in(key_words, 4 << 20), lf.seed)

    @functools.lru_cache(maxsize=4)
    def lan_keys(key_words):
        """The replicas' noise keys as the kernel takes them: (R, 2) int32
        words on the run's device (zeros without a thermostat)."""
        words = np.array([lan_words(k) if lf is not None else (0, 0)
                          for k in key_words], np.uint32)
        return torch.as_tensor(words.view(np.int32), device=device)

    def ramp(sstep, run_begin, run_end):
        """t_start -> t_stop target at ``sstep`` and its slope a step
        (fix_langevin.cpp:97-145), in the run's float type as the
        reference computes them (engine.py:1619-1629)."""
        span = max(np_dtype(run_end - run_begin), np_dtype(1.0))
        frac = np.clip(np_dtype(sstep - run_begin) / span, np_dtype(0.0),
                       np_dtype(1.0))
        t0 = np_dtype(lf.t_start)
        dT = np_dtype(lf.t_stop) - t0
        return t0 + frac * dT, dT / span

    event_fixes = [f for f in sim.fixes
                   if isinstance(f, (Extrusion, ExLoad, ExUnload))]
    makers = {Extrusion: make_extrusion_update, ExLoad: make_ex_load_update,
              ExUnload: make_ex_unload_update}
    kinds = {Extrusion: 1, ExLoad: 2, ExUnload: 3}
    event_updates = [(f, fid, makers[type(f)](system, f, device))
                     for fid, f in enumerate(event_fixes)]
    event_phases = [(f.nevery, f.phase) for f in event_fixes]
    scheduled = rebuild_schedule(sim, reactive, hot_window)
    bad_cut, trig_cut = skin_cuts(system)

    def placement(fs: FastState, gx, gv, gf):
        """A rebuild's new grid from planes (gx, gv, gf) of ``fs``, not
        yet the state's: place()'s outputs but the wrapped positions, and
        the group plane."""
        slot = torch.clamp(fs.slot_of, 0, capP - 1)
        x, v, f = (_beads(p, slot) for p in (gx, gv, gf))
        out = (place_replicas if fs.replicas else place)(
            system, maps, g, x, v, f, fs.ex_left, fs.ex_right, fs.img)
        lgm = None
        if fs.lgm is not None:
            # membership is per bead: gathered through the old slots,
            # scattered to the new ones (engine.py:1283-1288)
            member = torch.gather(fs.lgm.reshape(slot.shape[:-1] + (-1,)),
                                  -1, slot)
            lgm = _lgm_plane(member, out[6], maps, gx.dtype)
        return out[:9] + out[10:] + (lgm,)

    def commit(fs: FastState, placed):
        (fs.gx, fs.gv, fs.gf, fs.bid, fs.hn, fs.pid, fs.slot_of,
         fs.exl_slot, fs.exr_slot, fs.img, overflow, lgm) = placed
        if lgm is not None:
            fs.lgm = lgm
        fs.gx_ref = fs.gx
        fs.flags = fs.flags | overflow
        fs.skin_pend = 0
        fs.n_rebuilds += 1

    def rebuild(fs: FastState):
        commit(fs, placement(fs, fs.gx, fs.gv, fs.gf))

    def is_event(sstep: int):
        return any(sstep % nev == ph for nev, ph in event_phases)

    def rebuild_due(fs: FastState, sstep: int):
        # the schedule, or (reactive) the armed skin trigger
        # (engine.py:1193-1200)
        return scheduled(sstep) or (reactive and bool(fs.skin_pend))

    def retable(fs: FastState, left, right):
        """Partner plane + anchor slots after an extruder-table edit."""
        fs.ex_left, fs.ex_right = left, right
        partner = _partner_table(left, right, n)
        pid = torch.full((capP + n,), -1, dtype=torch.int32, device=device)
        pid[fs.slot_of] = partner.to(torch.int32)
        fs.pid = halo_refresh_int(pid[:capP].reshape(1, cap, P), g)[0]
        fs.exl_slot, fs.exr_slot = ex_slots(fs.slot_of, left, right)

    # the fields LE events write (apply_events, retable)
    event_fields = ("ex_left", "ex_right", "types", "pid", "exl_slot",
                    "exr_slot", "flags", "n_moves", "n_loads", "n_unloads",
                    "last_event")

    def apply_events(fs: FastState, sstep: int):
        """LE fixes in bead layout (engine.py:1205-1245); for R replicas
        on each replica in turn, each with its own key."""
        if fs.replicas:
            views = [replica(fs, r) for r in range(fs.replicas)]
            for view in views:
                apply_events(view, sstep)
            for name in event_fields:
                setattr(fs, name, torch.stack([getattr(view, name)
                                               for view in views]))
            return
        for f, fid, update in event_updates:
            if sstep % f.nevery != f.phase:
                continue
            key = rng.fold_in(rng.fold_in(rng.fold_in(fs.key_words, sstep),
                                          (kinds[type(f)] << 20) + fid),
                              f.seed)
            x = extract_beads(fs, maps)[0]
            occ = _partner_table(fs.ex_left, fs.ex_right, n) >= 0
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

    def tally(fs, en, ints, energy: bool):
        """The stencil's flag bits and clamps, and on energy steps its
        energies, into the state."""
        fs.flags = fs.flags | ints[..., 0]
        fs.n_clamps = fs.n_clamps + ints[..., 1]
        if energy:
            fs.epair, fs.ebond = en[..., 0], en[..., 1]
            fs.flags = fs.flags | (~torch.all(torch.isfinite(en), dim=-1)).to(
                torch.int64) * FLAG_NON_FINITE

    def langevin_args(fs, sstep: int, run_begin: int, run_end: int):
        """(key words, gamma1, gamma2) of the step's Langevin pass: the
        noise key (an (R, 2) tensor for R replicas), the friction and the
        noise scale at the ramp's target (engine.py:1393-1420)."""
        gamma1 = gamma2 = 0.0
        lan_key = lan_keys(fs.key_words) if fs.replicas else (0, 0)
        if lf is not None:
            gamma1 = -mass / lf.damp / units.ftm2v
            if not fs.replicas:
                lan_key = lan_words(fs.key_words)
            t_target, _ = ramp(sstep, run_begin, run_end)
            gamma2 = float(np_dtype(g2base) * np.sqrt(t_target))
        return lan_key, gamma1, gamma2

    return ChainParts(
        ctx=ctx, kick=kick, dt=dt, energy_every=energy_every,
        K_every=K_every, event_phases=event_phases, bad_cut=bad_cut,
        trig_cut=trig_cut, langevin=lf, zero=lan_zero, placement=placement,
        commit=commit, rebuild=rebuild, is_event=is_event,
        rebuild_due=rebuild_due, apply_events=apply_events, tally=tally,
        langevin_args=langevin_args, ramp=ramp,
        lan_words=lan_words if lf is not None else None)


def make_fast_segment(sim, thermo_every: int = 0, pallas=None,
                      reactive: bool = True, hot_window: int = None,
                      kernel_fn=None, *, device="cuda"):
    """Build ``(segment, step_core)`` (engine.make_fast_segment,
    engine.py:1102-1746): ``segment(fs, step0, length, run_begin, run_end)
    -> fs`` advances ``length`` steps in place, ``step_core(fs, sstep,
    run_begin, run_end) -> fs`` one step.

    ``pallas`` (``_pallas_step_mode``): None = auto, False = the chain,
    "real" / "interpret" = K2's step loop on the card / in plain PyTorch.
    The chain runs the step of the reference's XLA chain
    (engine.py:1348-1455), one host-driven step at a time.  Reactive, it
    rebuilds before the drift where the cadence, an LE event or the skin
    trigger armed by the previous step asks, and reads that trigger once
    a step.  With ``reactive=False`` the schedule is static
    (engine.py:1175-1200): the cadence, each LE event phase, and each
    extrusion fix's hot window ``((sstep - phase) % nevery) < w`` (``w`` =
    ``hot_window``, default min(150, max(nevery // 4, 1))), served after
    the drift and the events; no trigger is armed or read, so a step
    reads nothing from the card, and the segment takes a replica-batched
    FastState (``stack_fast``) as the reference's ``jax.vmap`` of it does.

    The step loop's reactive ``segment`` batches up to LAUNCH_MAX steps a
    launch (engine.py:1692-1739), stopping at the next cadence step (LE
    event phases, the rebuild backstop, energy steps) or where the
    in-launch trigger fires; the host reads one stats block a launch and
    counts ``fs.n_launches``.  Non-reactive, it runs one-step launches
    (engine.py:1740-1746) with the static schedule served before each
    launch's drift, as the reference's ``launch_pallas`` serves it.  The
    step loop and the reactive chain take one run's state: a
    replica-batched one raises ValueError.  ``kernel_fn``: a caller's
    stencil with select_kernel's contract for the chain (engine.py:1130-
    1132; one run's planes), else select_kernel's; the step loop carries
    its own stencil and ignores it (engine.py:1458).  ``thermo_every``
    raises the energy cadence to its gcd with the thermo cadence
    (engine.py:1127-1129).  A Langevin group is the FastState's ``lgm``
    plane (to_fast's ``groups``); ``zero`` subtracts the random force's
    mean over the group each step (engine.py:1422-1435).  ``device``: the
    run's, the card by default (it raises without one)."""
    if isinstance(thermo_every, bool) or not isinstance(
            thermo_every, (int, np.integer)):
        raise TypeError(f"thermo_every={thermo_every!r} is a step count "
                        f"(the device is keyword-only)")
    mode = _pallas_step_mode(sim.system, pallas, device)
    c = chain_parts(sim, thermo_every, reactive, hot_window,
                    None if mode else kernel_fn, device=device)
    ctx, kick, dt, lf = c.ctx, c.kick, c.dt, c.langevin
    system, maps, g, n = ctx.system, ctx.maps, ctx.g, ctx.system.n

    def one_run(fs: FastState, what: str):
        if fs.replicas:
            raise ValueError(f"{what} takes one run's FastState, not "
                             f"{fs.replicas} replicas (the non-reactive "
                             f"chain takes them)")

    def step(fs: FastState, sstep: int, run_begin: int, run_end: int):
        if reactive or kernel_fn is not None:
            one_run(fs, "the reactive chain" if reactive
                    else "a caller's stencil (kernel_fn)")
        event = c.is_event(sstep)
        if reactive and c.rebuild_due(fs, sstep):
            # served BEFORE the drift (engine.py:1349-1360)
            c.rebuild(fs)
        fs.gx, fs.gv = K.kick_drift_halo(
            fs.gx, fs.gv, fs.gf, fs.bid, g.interior, g.halo_cols,
            g.halo_src, g.halo_shift, n, kick, dt, g.images)
        fs.step = sstep
        if event:
            c.apply_events(fs, sstep)
        # reactive: the post-event rebuild; static: every due step, after
        # the drift and the events (engine.py:1374-1382)
        if event if reactive else c.rebuild_due(fs, sstep):
            c.rebuild(fs)

        energy = sstep % c.energy_every == 0
        gf, en, ints = _forces(ctx, fs.gx, fs.bid, fs.hn, fs.pid,
                               fs.exl_slot, fs.exr_slot, fs.ex_left >= 0,
                               energy)
        c.tally(fs, en, ints, energy)
        lan_key, gamma1, gamma2 = c.langevin_args(fs, sstep, run_begin,
                                                  run_end)
        fs.gf, fs.gv, mon = K.langevin_kick_monitor(
            fs.gx, fs.gx_ref, fs.gv, gf, fs.bid, g.interior, lan_key, sstep,
            gamma1, gamma2, kick, dt, c.bad_cut,
            c.trig_cut, n, lf is not None, fs.lgm, c.zero)
        fs.flags = fs.flags | mon[..., 0]
        if reactive:
            # the one host read of the step: the armed trigger
            fs.skin_pend = int(mon[1])
        return fs

    if not mode:
        def segment(fs: FastState, step0: int, length: int, run_begin: int,
                    run_end: int):
            for i in range(length):
                step(fs, step0 + i + 1, run_begin, run_end)
            return fs

        return segment, step

    core = make_step_kernel(system, maps, sim.ex_btype, dt=dt, langevin=lf,
                            g=g, interpret=mode == "interpret")
    # the boundary's kick + drift: the plain version in interpret mode
    drift = R.kick_drift_halo if mode == "interpret" else K.kick_drift_halo

    def launch_pallas(fs: FastState, sstep: int, limit: int, run_begin: int,
                      run_end: int, placed=None, ahead=False):
        """One launch of steps sstep..sstep+d-1, d <= limit
        (engine.py:1548-1690).  Its first step's boundary work runs on the
        host: the rebuild when due and, on an LE event step, kick + drift,
        the events and their rebuild, the launch then starting with its
        drift off; the caller keeps every later step of the launch off the
        cadences.  Energy steps are single-step launches (stats hold the
        last step's energies).

        With ``ahead`` the next launch's rebuild is issued on this launch's
        output planes before its stats are read, so that on the card the
        host's issue of the placement overlaps the launch; the next launch
        commits it (``placed``) only where its rebuild is due, so the run
        is the chain's.  Returns (d, that placement or None)."""
        one_run(fs, "K2's step loop")
        event = c.is_event(sstep)
        if c.rebuild_due(fs, sstep):
            if placed is None:
                c.rebuild(fs)
            else:
                c.commit(fs, placed)
        fs.step = sstep
        if event:
            fs.gx, fs.gv = drift(fs.gx, fs.gv, fs.gf, fs.bid, g.interior,
                                 g.halo_cols, g.halo_src, g.halo_shift, n,
                                 kick, dt, g.images)
            c.apply_events(fs, sstep)
            c.rebuild(fs)
        energy = sstep % c.energy_every == 0
        key_words, t_target, t_slope = (0, 0), 1.0, 0.0
        if lf is not None:
            key_words = c.lan_words(fs.key_words)
            t_target, t_slope = c.ramp(sstep, run_begin, run_end)
        nxt = []
        fs.gx, fs.gv, fs.gf, stats = core(
            fs.gx, fs.gv, fs.gf, fs.gx_ref, fs.bid, fs.hn, fs.pid,
            fs.exl_slot, fs.exr_slot, fs.ex_left >= 0, fs.lgm, sstep,
            not event, key_words, float(t_target), float(t_slope),
            1 if energy else limit, energy,
            (lambda *planes: nxt.append(c.placement(fs, *planes)))
            if ahead else None)
        st = stats.tolist()
        d = int(st[7])
        clamps = int(0.5 * st[3])
        fl = ((FLAG_BOND_REACH if st[2] > 0 else 0)
              | (FLAG_FENE_CLAMP if clamps > 0 else 0)
              | (FLAG_SKIN_VIOLATION if st[5] > 0 else 0))
        fs.n_clamps = fs.n_clamps + clamps
        fs.step = sstep + d - 1
        if reactive:
            # the in-launch monitor re-arms the trigger (stats row 6); the
            # next launch serves it (engine.py:1658-1661)
            fs.skin_pend = int(st[6] > 0)
        if energy:
            el, eb = 0.5 * st[0], 0.5 * st[1]
            en = torch.tensor([el, eb], dtype=fs.gx.dtype).to(
                fs.gx.device, non_blocking=True)
            fs.epair, fs.ebond = en[0], en[1]
            if not (np.isfinite(el) and np.isfinite(eb)):
                fl |= FLAG_NON_FINITE
        if fl:
            fs.flags = fs.flags | fl
        return d, (nxt[0] if nxt else None)

    def step_pallas(fs: FastState, sstep: int, run_begin: int, run_end: int):
        launch_pallas(fs, sstep, 1, run_begin, run_end)
        return fs

    if not reactive:
        # one-step launches on the static schedule (engine.py:1740-1746)
        def segment(fs: FastState, step0: int, length: int, run_begin: int,
                    run_end: int):
            for i in range(length):
                step_pallas(fs, step0 + i + 1, run_begin, run_end)
            return fs

        segment.loop = getattr(core, "loop", None)
        return segment, step_pallas

    # the next step of each cadence bounds a launch (engine.py:1706-1711)
    cadences = c.event_phases + [(c.K_every, 0), (c.energy_every, 0)]

    def segment(fs: FastState, step0: int, length: int, run_begin: int,
                run_end: int):
        done, placed = 0, None
        while done < length:
            sstep = step0 + done + 1
            lim = min(LAUNCH_MAX, length - done)
            for nev, ph in cadences:
                # the distance to the next step of the cadence; sstep
                # itself is the launch's own first step
                lim = min(lim, (ph - sstep) % nev or nev)
            # place ahead unless this launch may end the segment
            d, placed = launch_pallas(fs, sstep, lim, run_begin, run_end,
                                      placed, done + lim < length)
            done += d
            fs.n_launches += 1
        return fs

    segment.loop = getattr(core, "loop", None)
    return segment, step_pallas


def _host_row(row: ThermoSample) -> ThermoSample:
    """A thermo row's values on the host (jax.device_get's place)."""
    return ThermoSample(*(v.item() if isinstance(v, torch.Tensor) else v
                          for v in row))


def run_fast(sim, state: State, nsteps: int, thermo_every: int = 0,
             thermo_callback=None, max_segment: int = 2000,
             boundary_every: int = 0, boundary_callback=None, groups=None,
             kernel_fn=None):
    """Drive ``nsteps`` on the fast engine as one run (engine.run_fast,
    engine.py:1749-1808), on the state's device.  Returns (State, thermo
    rows): a row (``thermo_row_fast``, its values on the host) at the run's
    start and at every absolute multiple of ``thermo_every``, and one at
    the end, each also passed with the State to ``thermo_callback``;
    ``boundary_callback(State)`` fires at absolute multiples of
    ``boundary_every`` (the dump cadence, output.cpp:284).  Segments stop
    there and are at most ``max_segment`` steps.  ``groups`` as to_fast's,
    ``kernel_fn`` as make_fast_segment's."""
    system = sim.system
    segment, _ = make_fast_segment(sim, thermo_every, kernel_fn=kernel_fn,
                                   device=state.x.device)
    fs = to_fast(state, sim, groups, kernel_fn=kernel_fn)
    rows = []

    def emit(fs):
        row = _host_row(thermo_row_fast(fs, system))
        rows.append(row)
        if thermo_callback:
            thermo_callback(row, from_fast(fs, system))

    begin = fs.step
    if thermo_every > 0:
        emit(fs)
    if boundary_callback and boundary_every > 0 \
            and begin % boundary_every == 0:
        boundary_callback(from_fast(fs, system))
    seg = thermo_every if thermo_every > 0 else 0
    if boundary_every > 0:
        seg = int(np.gcd(seg, boundary_every)) if seg else boundary_every
    if seg == 0:
        seg = min(nsteps, max_segment)
    done = 0
    while done < nsteps:
        # stop at the next ABSOLUTE multiple of seg (phase on step 0, not
        # the run begin: staged decks enter runs at unaligned steps)
        cur = begin + done
        this = min(int(seg - cur % seg), nsteps - done)
        left = this
        while left > 0:
            chunk = min(left, max_segment)
            segment(fs, begin + done + (this - left), chunk, begin,
                    begin + nsteps)
            left -= chunk
        done += this
        step_abs = begin + done
        if thermo_every > 0 and (step_abs % thermo_every == 0
                                 or done == nsteps):
            emit(fs)
        if boundary_callback and boundary_every > 0 \
                and step_abs % boundary_every == 0:
            boundary_callback(from_fast(fs, system))
    return from_fast(fs, system), rows


def run_fast_replicas(sim, state: State, n_replicas: int, nsteps: int,
                      seed: int = 1234, max_segment: int = 2000):
    """A replica ensemble on the fast engine (engine.run_fast_replicas,
    engine.py:1810-1843): ``n_replicas`` trajectories from the same
    State, replica i's key folded with ``seed + i`` (the reference's
    multi-partition Universe, each partition the same deck with another
    seed), ``nsteps`` steps of the non-reactive chain
    (``make_fast_segment(pallas=False, reactive=False)``) in segments of
    at most ``max_segment``, on the state's device.  Every gate keys on
    the shared step and each kernel is one launch for all replicas.
    Returns the replica-batched FastState."""
    segment, _ = make_fast_segment(sim, pallas=False, reactive=False,
                                   device=state.x.device)
    fs = to_fast(state, sim)
    fs = stack_fast([dataclasses.replace(
        fs, key_words=rng.fold_in(fs.key_words, seed + i))
        for i in range(n_replicas)])
    begin = fs.step
    done = 0
    while done < nsteps:
        chunk = min(max_segment, nsteps - done)
        segment(fs, begin + done, chunk, begin, begin + nsteps)
        done += chunk
    return fs
