"""fix viscous (``lammps_le_tpu.fixes.viscous``; fix_viscous.cpp): the
post_force hook adds F -= gamma v."""

from __future__ import annotations

import dataclasses
from typing import Optional

from .registry import FIX_STYLES, register_fix_style


@dataclasses.dataclass(frozen=True)
class Viscous:
    gamma: float
    group: Optional[str] = None


def _viscous_post_force(system, fix):
    def hook(state, f, step_no):
        return f - fix.gamma * state.v

    return hook


def _parse(group, args):
    if group is not None:
        raise ValueError("fix viscous: only group 'all' is supported")
    return Viscous(gamma=float(args[0]))


if "viscous" not in FIX_STYLES:
    register_fix_style("viscous", Viscous, parse=_parse,
                       post_force=_viscous_post_force)
