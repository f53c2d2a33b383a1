"""Dynamic simulation state in bead layout (``lammps_le_tpu.state``).

A dataclass of tensors with the reference's fields and ``FLAG_*`` bits, so
sticky flags of the two engines compare directly.  Integer fields are
int64 (the reference's uint32 key words and flags fit without sign
trouble); the PRNG key is the raw word pair ``[k0, k1]`` that
``jax.random.PRNGKey`` would hold.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import rng
from .system import System

# Bits in State.flags (values of lammps_le_tpu/state.py:24-30).
FLAG_CELL_OVERFLOW = 1       # a cell held more beads than cell_cap
FLAG_NEIGHBOR_OVERFLOW = 2   # a bead had more candidates than max_neighbors
FLAG_SKIN_VIOLATION = 4      # displacement since rebuild exceeded skin/2
FLAG_FENE_CLAMP = 8          # FENE rlogarg clamped (bond_fene.cpp:87-92)
FLAG_EXTRUDER_OVERFLOW = 16  # ex_load wanted more extruders than table slots
FLAG_NON_FINITE = 32         # non-finite energy observed (blown-up dynamics)
FLAG_BOND_REACH = 64         # a backbone bond exceeded the cell-stencil reach


@dataclasses.dataclass
class NeighborList:
    """Compact verlet list (state.py:35): full (symmetric) neighbour
    candidates per bead found within ``cutoff + skin`` at the last
    rebuild, padded with N; ``x_ref`` the positions then (skin check)."""

    idx: torch.Tensor            # (N, K) int64, padded with N
    x_ref: torch.Tensor          # (N, 3)

    def replace(self, **kw) -> "NeighborList":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class State:
    x: torch.Tensor              # (N, 3) wrapped positions
    v: torch.Tensor              # (N, 3) velocities
    f: torch.Tensor              # (N, 3) forces from the last evaluation
    img: torch.Tensor            # (N, 3) int64 periodic image counters
    type: torch.Tensor           # (N,) int64 0-based atom type
    ex_left: torch.Tensor        # (E,) int64 left anchor bead, -1 = inactive
    ex_right: torch.Tensor       # (E,) int64 right anchor bead
    key: torch.Tensor            # (2,) int64 raw threefry key words
    step: torch.Tensor           # () int64 current timestep
    flags: torch.Tensor          # () int64 sticky error bits
    epair: torch.Tensor          # () pair energy at the last force evaluation
    ebond: torch.Tensor          # () bond energy at the last force evaluation
    n_moves: torch.Tensor        # () int64 total extruder shifts
    n_loads: torch.Tensor        # () int64 total extruders loaded
    n_unloads: torch.Tensor      # () int64 total extruders unloaded
    last_event: torch.Tensor     # (3,) int64 counts at the latest events
    therm_e: torch.Tensor        # () thermostat energy (tally: general path)
    # the general path's neighbour structure: a NeighborList or an
    # ops.grid.CellGrid (built at each rebuild), None before setup
    nbr: object = None

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


def host(a) -> np.ndarray:
    """A State field as a host numpy array: a tensor on any device is
    copied off it (the reference's ``np.asarray`` of a device array),
    anything else goes through ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _dtype(system: System) -> torch.dtype:
    return getattr(torch, system.dtype)


def init_state(system: System, x, v=None, types=None, seed: int = 0,
               img=None, device="cuda") -> State:
    """Build an initial State from host arrays (``lammps_le_tpu.state
    .init_state``) on ``device``: the card unless the caller asks for the
    CPU."""
    dtype = _dtype(system)
    n = system.n
    x = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    if x.shape != (n, 3):
        raise ValueError(f"positions of shape {tuple(x.shape)}, want "
                         f"({n}, 3)")
    z3 = torch.zeros((n, 3), dtype=dtype, device=device)
    v = z3.clone() if v is None else torch.as_tensor(
        np.asarray(v), dtype=dtype, device=device)
    types = (torch.zeros(n, dtype=torch.int64, device=device) if types is None
             else torch.as_tensor(np.asarray(types), dtype=torch.int64,
                                  device=device))
    img = (torch.zeros((n, 3), dtype=torch.int64, device=device)
           if img is None else torch.as_tensor(
               np.asarray(img), dtype=torch.int64, device=device))
    e = max(system.max_extruders, 1)
    zi = torch.zeros((), dtype=torch.int64, device=device)
    zf = torch.zeros((), dtype=dtype, device=device)
    return State(
        x=x, v=v, f=z3, img=img, type=types,
        ex_left=torch.full((e,), -1, dtype=torch.int64, device=device),
        ex_right=torch.full((e,), -1, dtype=torch.int64, device=device),
        key=torch.tensor(rng.prng_key(seed), dtype=torch.int64,
                         device=device),
        step=zi, flags=zi.clone(), epair=zf, ebond=zf.clone(),
        n_moves=zi.clone(), n_loads=zi.clone(), n_unloads=zi.clone(),
        last_event=torch.zeros(3, dtype=torch.int64, device=device),
        therm_e=zf.clone(),
    )


def _partner_table(ex_left: torch.Tensor, ex_right: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Per-bead extruder partner index, or -1, from the extruder tables:
    one scatter per side into an (N+1,) buffer whose last entry takes the
    inactive slots' writes and is dropped.  Any leading (replica) axes."""
    active = ex_left >= 0
    safe_l = torch.where(active, ex_left, n)
    safe_r = torch.where(active, ex_right, n)
    none = torch.full_like(ex_left, -1)
    partner = torch.full(ex_left.shape[:-1] + (n + 1,), -1,
                         dtype=ex_left.dtype, device=ex_left.device)
    partner.scatter_(-1, safe_l, torch.where(active, ex_right, none))
    partner.scatter_(-1, safe_r, torch.where(active, ex_left, none))
    return partner[..., :n]


def extruder_partner(state: State, n: int) -> torch.Tensor:
    """(N,) per-bead extruder partner index, or -1 (state.py:127): with at
    most one anchor a bead, one table answers "is this bead occupied" and
    "who is it bonded to"."""
    return _partner_table(state.ex_left, state.ex_right, n)


def extruder_occupancy(state: State, n: int) -> torch.Tensor:
    """(N,) bool: the bead carries an extruder anchor (state.py:146)."""
    return extruder_partner(state, n) >= 0


def nbr_from_arrays(d: dict, device="cuda"):
    """A reference ``NeighborList`` or ``CellGrid`` given as a dict of
    numpy arrays (``idx`` / ``slot_bead`` + ``scatter_bead``, and
    ``x_ref``) as the port's."""
    def ints(name):
        return torch.as_tensor(np.asarray(d[name]).astype(np.int64),
                               device=device)

    x_ref = torch.as_tensor(np.array(d["x_ref"]), device=device)
    if "slot_bead" in d:
        from .ops.grid import CellGrid

        return CellGrid(slot_bead=ints("slot_bead"),
                        scatter_bead=ints("scatter_bead"), x_ref=x_ref)
    return NeighborList(idx=ints("idx"), x_ref=x_ref)


def state_from_arrays(d: dict, device="cuda") -> State:
    """A port State from a dict of numpy arrays holding a reference State's
    fields (``key`` as its raw uint32 words; ``therm_e`` and ``nbr``, a
    dict as ``nbr_from_arrays`` takes, optional) — starts both engines
    from the same point."""
    def f(name):
        return torch.as_tensor(np.array(d[name]), device=device)

    def i(name):
        return torch.as_tensor(np.asarray(d[name]).astype(np.int64),
                               device=device)

    x = f("x")
    return State(
        x=x, v=f("v"), f=f("f"), img=i("img"), type=i("type"),
        ex_left=i("ex_left"), ex_right=i("ex_right"),
        key=i("key").reshape(2), step=i("step"), flags=i("flags"),
        epair=f("epair"), ebond=f("ebond"),
        n_moves=i("n_moves"), n_loads=i("n_loads"),
        n_unloads=i("n_unloads"), last_event=i("last_event"),
        therm_e=(f("therm_e") if "therm_e" in d else
                 torch.zeros((), dtype=x.dtype, device=device)),
        nbr=(None if d.get("nbr") is None
             else nbr_from_arrays(d["nbr"], device)),
    )
