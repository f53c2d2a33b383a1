"""The force stencil past the whole-plane gate: the counterpart of
``lammps_le_tpu/fast/blocked_kernel.py`` (K3).

The reference runs the Newton-half stencil (make_offset_loop) over lane
chunks of the flat cell axis, each with a [M | CL | M] window, because a
TPU's VMEM cannot hold a million-bead grid's planes; it folds the margin
reactions and then the ghost faces in XLA.  On the card the stencil runs
over the whole grid in one kernel (``kernels.newton_half_forces``,
``csrc/blocked.cu``), so ``pick_cl``, ``BLOCK_LANES``/``LLE_BLOCK_LANES``
and the VMEM envelope are TPU-only and are not ported; the function is
the same: ``kernel(g, gx, bid, hn, pid, energy) -> (gf, energies (2,),
ints (2,) = [flag bits, clamps])``, ``engine.make_kernel``'s contract
(``g`` the run's GridConsts), with halo-refreshed ``gx`` in and the ghost
columns of ``gf`` folded onto their owners.
"""

from __future__ import annotations

import numpy as np

from ..system import System
from . import kernels as K
from .consts import StencilConsts
from .maps import FastMaps
from .place import GridConsts


def make_blocked_kernel(system: System, maps: FastMaps, ex_btype: int):
    """The Newton-half stencil with the ghost fold, as a closure over the
    system's constants (blocked_kernel.py:90; ``ex_btype`` as there)."""
    assert system.dtype == "float32", "blocked kernel is the f32 path"
    C = StencilConsts(system, np.float32)

    def kernel(g: GridConsts, gx, bid, hn, pid, energy: bool):
        return K.newton_half_forces(gx, bid, hn, pid, g.interior, g.faces, C,
                                    system.n, maps.strides, maps.fold_shifts,
                                    energy)

    return kernel
