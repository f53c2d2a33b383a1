"""The deployment as the program takes it, and as the reference takes it,
from one configuration file and one scene.

``program_*`` build the program's objects (its System, Simulation and
State) through its public API; ``reference_params`` gives the reference
the same deployment from the same configuration and scene, without the
program."""

from __future__ import annotations

import numpy as np
import torch


def program_system(cfg: dict, scene, **neighbor):
    """The program's System of the configuration: a chain of FENE bonds,
    shifted LJ, harmonic extruder springs (bond type 2), the cell grid's
    skin, cap and cadence (``neighbor`` overrides them)."""
    from lammps_le_torch.system import (BOND_FENE, BOND_HARMONIC,
                                        BondParams, PairLJCut, build_system,
                                        chain_topology)

    nt = cfg["scene"]["n_atom_types"]
    p = cfg["pair"]
    ones = np.ones((nt, nt))
    pair = PairLJCut(epsilon=p["epsilon"] * ones, sigma=p["sigma"] * ones,
                     cutoff=p["cutoff"] * ones, shift=p["shift"])
    bonds = BondParams(
        style=np.array([BOND_FENE, BOND_HARMONIC]),
        coeffs=np.array([cfg["fene"], list(cfg["spring"]) + [0.0, 0.0]]))
    nxt, prv, mol, btype = chain_topology([scene.n], bond_type=1)
    nb = dict(cfg["neighbor"], **neighbor)
    return build_system(
        n=scene.n, n_types=nt, box_lo=scene.box_lo, box_hi=scene.box_hi,
        next_bead=nxt, prev_bead=prv, molecule=mol, backbone_type=btype,
        masses=np.ones(nt), pair=pair, bonds=bonds, special_lj=(0.0, 1.0, 1.0),
        skin=nb["skin"], cell_cap=nb["cell_cap"],
        rebuild_every=nb["rebuild_every"],
        max_extruders=cfg["extruders"]["table"], dtype=cfg["dtype"])


def program_fixes(cfg: dict):
    """NVE, the production Langevin fix and the LE fixes, in the
    configuration's order."""
    from lammps_le_torch.fixes import (NVE, ExLoad, ExUnload, Extrusion,
                                       Langevin)

    kinds = {"extrusion": Extrusion, "ex_load": ExLoad,
             "ex_unload": ExUnload}
    lan = cfg["langevin"]
    fixes = [NVE(), Langevin(t_start=lan["t_start"], t_stop=lan["t_stop"],
                             damp=lan["damp"], seed=lan["seed"])]
    for kind, fix in cfg["events"]:
        fixes.append(kinds[kind](**{k: v for k, v in fix.items()}))
    return tuple(fixes)


def program_sim(cfg: dict, system, dt=None, fixes=None):
    from lammps_le_torch.integrate import Simulation

    return Simulation(system=system, dt=dt or cfg["dt"],
                      energy_every=cfg["energy_every"],
                      fixes=fixes or program_fixes(cfg), ex_btype=2)


def program_state(cfg: dict, scene, system, device):
    from lammps_le_torch.state import init_state

    return init_state(system, scene.x, v=scene.v, types=scene.types,
                      seed=scene.run_seed, device=device)


def seed_extruders(state, scene):
    """The configuration's seeded extruders at (i, i + 2), the flags
    cleared (bench.py:454-465)."""
    e = state.ex_left.shape[0]
    left = torch.full((e,), -1, dtype=torch.int64)
    right = torch.full((e,), -1, dtype=torch.int64)
    k = scene.extruders.shape[0]
    left[:k] = torch.as_tensor(scene.extruders[:, 0])
    right[:k] = torch.as_tensor(scene.extruders[:, 1])
    dev = state.x.device
    return state.replace(ex_left=left.to(dev), ex_right=right.to(dev),
                         flags=torch.zeros_like(state.flags))


def settle(cfg: dict, scene, system, device):
    """The configuration's set-up on the fast engine: thermalize (NVE +
    Langevin at its own damping), seed the extruders, settle with the
    production fixes at the short step.  Returns the settled State."""
    from lammps_le_torch.fast import run_fast
    from lammps_le_torch.fixes import NVE, Langevin

    su = cfg["setup"]
    th = su["thermalize"]
    lan = cfg["langevin"]
    state = program_state(cfg, scene, system, device)
    warm = program_sim(cfg, system, dt=th["dt"], fixes=(
        NVE(), Langevin(t_start=lan["t_start"], t_stop=lan["t_stop"],
                        damp=th["damp"], seed=th["seed"])))
    state, _ = run_fast(warm, state, th["steps"])
    state = seed_extruders(state, scene)
    if th["reset_step"]:
        state = state.replace(step=torch.zeros_like(state.step))
    sim = program_sim(cfg, system)
    short = program_sim(cfg, system, dt=su["settle"]["dt"], fixes=sim.fixes)
    state, _ = run_fast(short, state, su["settle"]["steps"])
    return state.replace(flags=torch.zeros_like(state.flags))


def reference_params(cfg: dict, scene, device,
                     dtype=torch.float64) -> dict:
    """The deployment as the reference takes it (``reference.step``):
    from the configuration and the scene only."""
    t = dict(dtype=dtype, device=device)
    nxt = torch.as_tensor(scene.next_bead, device=device)
    prv = torch.full_like(nxt, -1)
    prv[nxt[nxt >= 0]] = torch.nonzero(nxt >= 0).flatten()
    lo = torch.tensor(scene.box_lo, **t)
    box = torch.tensor(scene.box_hi, **t) - lo
    p = cfg["pair"]
    return {
        "lo": lo, "box": box, "chain": (prv, nxt),
        "forces": {"epsilon": p["epsilon"], "sigma": p["sigma"],
                   "cutoff": p["cutoff"], "fene": tuple(cfg["fene"]),
                   "spring": tuple(cfg["spring"])},
        "dt": cfg["dt"], "mass": 1.0, "kT": cfg["langevin"]["t_start"],
        "damp": cfg["langevin"]["damp"],
        "langevin_seed": cfg["langevin"]["seed"],
        "fixes": [(kind, fix, i) for i, (kind, fix) in
                  enumerate(cfg["events"])],
    }

