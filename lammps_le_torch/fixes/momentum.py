"""fix momentum (``lammps_le_tpu.fixes.momentum``; fix_momentum.cpp):
every ``nevery`` steps the end_of_step hook subtracts the mass-weighted
centre-of-mass velocity, in the components ``linear`` selects."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..ops.cells import const, system_const
from .registry import FIX_STYLES, register_fix_style


@dataclasses.dataclass(frozen=True)
class Momentum:
    nevery: int
    linear: Tuple[int, int, int] = (1, 1, 1)
    group: Optional[str] = None  # group handling: 'all' only (see parse)


def _momentum_end_of_step(system, fix):
    def hook(state, step_no):
        if step_no % fix.nevery:
            return state
        v = state.v
        masses = system_const(system, "masses", lambda: system.masses,
                              v.dtype, v.device)
        m = masses[state.type][:, None]
        vcm = (m * v).sum(dim=0) / m.sum()
        vcm = vcm * const(tuple(float(c) for c in fix.linear), v.dtype,
                          v.device)
        return state.replace(v=v - vcm)

    return hook


def _parse(group, args):
    if group is not None:
        raise ValueError("fix momentum: only group 'all' is supported")
    nevery = int(args[0])
    linear = (1, 1, 1)
    rest = list(args[1:])
    while rest:
        k = rest.pop(0)
        if k == "linear" and len(rest) >= 3:
            linear = tuple(int(rest.pop(0)) for _ in range(3))
        elif k in ("angular", "rescale"):
            raise ValueError(f"fix momentum {k} is unsupported")
        else:
            raise ValueError(f"fix momentum keyword {k!r}")
    return Momentum(nevery=nevery, linear=linear)


if "momentum" not in FIX_STYLES:
    register_fix_style("momentum", Momentum, parse=_parse,
                       end_of_step=_momentum_end_of_step)
