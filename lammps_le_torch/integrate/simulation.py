"""The static run description (``lammps_le_tpu.integrate.verlet
.Simulation``): system + dt + fixes.  One class, which ``integrate``,
``integrate.verlet`` and the fast engine share."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..fixes.config import ExLoad, ExUnload, Extrusion
from ..system import System


@dataclasses.dataclass(frozen=True)
class Simulation:
    """Static run description: system + dt + fixes (the 'input deck')."""

    system: System
    dt: float
    fixes: Tuple = ()
    ex_btype: int = -1  # 1-based bond type of extruder bonds; -1 = none
    # compute energies only every N steps (thermo cadence); 1 = every step
    energy_every: int = 1

    def __post_init__(self):
        if self.ex_btype < 0:
            bt = -1
            for f in self.fixes:
                if isinstance(f, (Extrusion, ExLoad, ExUnload)):
                    bt = f.btype
                    break
            object.__setattr__(self, "ex_btype", bt)
