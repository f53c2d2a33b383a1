"""Extruder unloading (``lammps_le_tpu/fixes/ex_unload.py``, the port of
``FixExUnload::post_integrate``, fix_ex_unload.cpp:172-372): extruder
bonds LONGER than ``cutoff`` break, each with probability ``fraction``."""

from __future__ import annotations

import torch

from .. import rng
from ..system import System
from .config import ExUnload
from .extrusion import _rsq


def make_ex_unload_update(system: System, fix: ExUnload, device):
    """update(x, ex_left, ex_right, key) -> (left, right, n_broken)."""
    cutsq = fix.cutoff * fix.cutoff
    box = system.box_size

    def update(x, ex_left, ex_right, key):
        e = ex_left.shape[0]
        active = ex_left >= 0
        li = torch.where(active, ex_left, 0)
        ri = torch.where(active, ex_right, 0)
        candidate = active & (_rsq(x, li, ri, box) > cutsq)
        if fix.fraction < 1.0:
            candidate = candidate & (rng.uniform(key, e, device)
                                     < fix.fraction)
        return (torch.where(candidate, -1, ex_left),
                torch.where(candidate, -1, ex_right), candidate.sum())

    return update
