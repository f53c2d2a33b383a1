"""Periodic wrapping and cell assignment (``lammps_le_tpu.ops.cells``)."""

from __future__ import annotations

import torch

from ..system import System


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def minimum_image(d: torch.Tensor, box_size) -> torch.Tensor:
    """Wrap displacements to the nearest image (domain.cpp:980); rounds
    half to even like ``jnp.round``."""
    box = _vec(box_size, d)
    return d - box * torch.round(d / box)


def wrap_positions(x: torch.Tensor, system: System, img: torch.Tensor):
    """Remap positions into [lo, hi), updating image counters
    (domain.cpp:528).  In f32 ``x - shift*box`` can round onto ``hi`` (or
    a hair below ``lo``); the corrections below land every coordinate
    exactly in [lo, hi), counting each full-box move (cells.py:47)."""
    lo = _vec(system.box_lo, x)
    box = _vec(system.box_size, x)
    hi = lo + box
    shift = torch.floor((x - lo) / box).to(torch.int64)
    x = x - shift.to(x.dtype) * box
    over = x >= hi
    x = torch.where(over, x - box, x)
    shift = shift + over.to(torch.int64)
    under = x < lo
    x = torch.where(under, x + box, x)
    shift = shift - under.to(torch.int64)
    pin = x >= hi
    x = torch.where(pin, lo.expand_as(x), x)
    shift = shift + pin.to(torch.int64)
    return x, img + shift


def cell_coords(x: torch.Tensor, system: System) -> torch.Tensor:
    """(N, 3) integer cell coordinates of wrapped positions.  Clips rather
    than re-wrapping, so a coordinate within an ulp of ``hi`` keeps a cell
    consistent with it (cells.py:80)."""
    cfg = system.neighbor
    lo = _vec(system.box_lo, x)
    box = _vec(system.box_size, x)
    dims = torch.tensor([cfg.nx, cfg.ny, cfg.nz], dtype=torch.int64,
                        device=x.device)
    s = (x - lo) / box
    c = torch.floor(s * dims.to(x.dtype)).to(torch.int64)
    return torch.minimum(torch.clamp(c, min=0), dims - 1)
