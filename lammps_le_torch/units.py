"""Unit systems (a copy of ``lammps_le_tpu/units.py``).

The reference engine supports several unit styles (``units lj`` etc.,
reference: src/update.cpp:141-230 ``Update::set_units``).  The loop-extrusion
workload runs exclusively in reduced Lennard-Jones units, where every
conversion factor is 1.  We keep the factors explicit so other styles can be
added without touching kernel code.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Units:
    """Conversion factors used by the integrator and thermostat.

    Mirrors the subset of ``Force`` constants the hot path reads
    (reference: src/force.h — boltz, ftm2v, mvv2e).
    """

    name: str
    boltz: float = 1.0     # Boltzmann constant in these units
    ftm2v: float = 1.0     # force/mass -> velocity/time
    mvv2e: float = 1.0     # mass*velocity^2 -> energy
    dt_default: float = 0.005


LJ = Units(name="lj", boltz=1.0, ftm2v=1.0, mvv2e=1.0, dt_default=0.005)

_REGISTRY = {"lj": LJ}


def get_units(name: str) -> Units:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unsupported units style {name!r}; supported: {sorted(_REGISTRY)}"
        ) from None
