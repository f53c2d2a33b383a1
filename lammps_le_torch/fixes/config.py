"""Fix parameter sets — the declarative replacements for the reference's
fix command lines (reference: README.md:22-40, SURVEY.md §5.6).

A copy of ``lammps_le_tpu/fixes/config.py`` with the same field names and
defaults, so that the port imports nothing of the JAX package.

Atom/bond types are stored 1-based exactly as they appear in input decks;
kernels convert to 0-based.  ``group`` is an optional bead mask name resolved
by the deck layer; ``None`` means all beads (every LE deck uses ``all``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class NVE:
    """``fix nve`` — velocity Verlet (reference: src/fix_nve.cpp:64-140)."""

    group: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class NVELimit:
    """``fix nve/limit`` — velocity Verlet with a per-step displacement cap
    (reference: src/fix_nve_limit.cpp).  Used to push off overlapping
    random-walk initial states."""

    xmax: float
    group: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Langevin:
    """``fix langevin`` — drag + uniform noise POST_FORCE thermostat
    (reference: src/fix_langevin.cpp:654-674; non-GJF default with
    sqrt(24) * (uniform-0.5) noise)."""

    t_start: float
    t_stop: float
    damp: float
    seed: int = 12345
    group: Optional[str] = None
    # ``zero yes`` (fix_langevin.cpp zeroflag): subtract the group mean
    # from the random force each step so it sums to zero — kills the
    # thermostat's COM random walk.  Rides the fast path (one in-kernel
    # mean subtract per component per step) and the general path.
    zero: bool = False
    # ``tally yes`` (fix_langevin.cpp tallyflag): accumulate the cumulative
    # energy the thermostat exchanged with the group into State.therm_e;
    # ``f_ID`` thermo reports it with the reference's sign convention
    # (compute_scalar returns -energy, fix_langevin.cpp).  General path.
    tally: bool = False
    # ``gjf vfull|vhalf`` (fix_langevin.cpp:97-145 gjfflag): the
    # Gronbech-Jensen/Farago discretization — gaussian noise folded into
    # the Verlet kicks so configurational sampling is exact at any stable
    # dt.  "vfull" stores the on-site velocity, "vhalf" the 2GJ half-step
    # velocity (exact kinetic temperature).  General path only.
    gjf: str = "no"


@dataclasses.dataclass(frozen=True)
class Extrusion:
    """``fix extrusion`` (reference: src/USER-LE/fix_extrusion.cpp).

    Fires on steps where ``step % nevery == phase`` (reference gates on
    ``ntimestep % nevery - 1``, fix_extrusion.cpp:265; load/unload use
    offsets 3/2 so the three never rewire on the same step,
    fix_ex_load.cpp:233-235).
    """

    nevery: int
    neutral_type: int
    ctcf_left: int
    ctcf_right: int
    through_prob: float
    btype: int
    ctcf_left_right: int = -1   # optional bidirectional barrier type
    seed: int = 12345           # reference hard-codes 12345 (fix_extrusion.cpp:98)
    phase: int = 1
    group: Optional[str] = None
    # Opt-in DOCUMENTED DEVIATION (off at 0.0): forcibly unload any
    # extruder whose spring has stretched past ``release_r`` at event time.
    # A stalled extruder the unload fix never reaches (stall-until-unload)
    # winds its spring until FENE clamps — the reference simply hard-aborts
    # when a bond hits r >= 2*r0 (src/MOLECULE/bond_fene.cpp:87-92); this
    # knob bounds the failure mode instead (VALIDATION.md defect 2).
    release_r: float = 0.0


@dataclasses.dataclass(frozen=True)
class ExLoad:
    """``fix ex_load`` (reference: src/USER-LE/fix_ex_load.cpp).

    Creates an extruder bond between beads i and i+2 when all of i, i+1,
    i+2 have exactly two bonds (chain-interior, unoccupied), distance is
    inside ``cutoff``, with probability ``fraction``."""

    nevery: int
    iatomtype: int
    jatomtype: int
    cutoff: float
    btype: int
    fraction: float = 1.0
    seed: int = 12345
    imaxbond: int = 0
    inewtype: int = -1
    jmaxbond: int = 0
    jnewtype: int = -1
    phase: int = 3
    group: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ExUnload:
    """``fix ex_unload`` (reference: src/USER-LE/fix_ex_unload.cpp).

    Breaks extruder bonds *longer* than ``cutoff`` (note the inverted test
    vs load, fix_ex_unload.cpp:236) with probability ``fraction``."""

    nevery: int
    btype: int
    cutoff: float
    fraction: float = 1.0
    seed: int = 12345
    phase: int = 2
    group: Optional[str] = None
