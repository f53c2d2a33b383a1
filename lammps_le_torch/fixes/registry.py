"""The fix-style registry (``lammps_le_tpu.fixes.registry``): Modify's
plugin mechanism (modify.cpp:789 add_fix, the per-hook fix lists of
fix.h:248-264) for the general path.

A style registers a frozen config dataclass and hook builders; the general
path's step calls the registered hooks at the same lifecycle points:

    post_integrate(system, fix) -> (state, step_no) -> state
        after drift + the LE fixes (fix_extrusion.cpp:256's slot)
    post_force(system, fix) -> (state, f_total, step_no) -> f_total
        after pair/bond forces + Langevin (fix_langevin.cpp:438's slot)
    end_of_step(system, fix) -> (state, step_no) -> state
        after the final half-kick (modify.cpp:481's slot)

``step_no`` is the step being made, a host int.  A hook issues tensor
operations only (no host read of a device value), so a step needs no sync.
Stochastic hooks fold their keys from the run key's words
(``rng.fold_in``) with a style-unique salt, as the built-ins do.
The fast engine refuses Simulations that hold such fixes
(``fast.engine.fast_block_reason``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from .config import NVE, ExLoad, ExUnload, Extrusion, Langevin, NVELimit


@dataclasses.dataclass(frozen=True)
class FixStyle:
    name: str
    config_cls: type
    # deck-layer parser: (group: Optional[str], args: [str]) -> config;
    # None for built-ins
    parse: Optional[Callable] = None
    post_integrate: Optional[Callable] = None
    post_force: Optional[Callable] = None
    end_of_step: Optional[Callable] = None
    builtin: bool = False


FIX_STYLES: Dict[str, FixStyle] = {}
_BY_TYPE: Dict[type, FixStyle] = {}


def register_fix_style(name: str, config_cls: type,
                       parse: Optional[Callable] = None, *,
                       post_integrate: Optional[Callable] = None,
                       post_force: Optional[Callable] = None,
                       end_of_step: Optional[Callable] = None,
                       builtin: bool = False) -> FixStyle:
    """Register a fix style (modify.cpp:789 add_fix)."""
    if name in FIX_STYLES and not builtin:
        raise ValueError(f"fix style {name!r} already registered")
    style = FixStyle(name=name, config_cls=config_cls, parse=parse,
                     post_integrate=post_integrate, post_force=post_force,
                     end_of_step=end_of_step, builtin=builtin)
    FIX_STYLES[name] = style
    _BY_TYPE[config_cls] = style
    return style


def style_of(fix) -> Optional[FixStyle]:
    """The registered style of a fix config instance (None if unknown)."""
    return _BY_TYPE.get(type(fix))


def custom_hooks(fixes, hook: str):
    """(fix, builder) pairs of the non-builtin fixes carrying ``hook``."""
    out = []
    for f in fixes:
        st = _BY_TYPE.get(type(f))
        if st is not None and not st.builtin:
            b = getattr(st, hook)
            if b is not None:
                out.append((f, b))
    return out


# built-ins: the general path's own code runs them; registered so that
# style_of() is total
for _name, _cls in [("nve", NVE), ("nve/limit", NVELimit),
                    ("langevin", Langevin), ("extrusion", Extrusion),
                    ("ex_load", ExLoad), ("ex_unload", ExUnload)]:
    register_fix_style(_name, _cls, builtin=True)
