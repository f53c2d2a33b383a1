"""The tiled full stencil: the counterpart of
``lammps_le_tpu/fast/pallas_kernel.py`` (K5).

The reference's K5 is a second full 27-offset stencil with
``engine.make_kernel``'s contract, in formulas of its own (see
``kernels_ref.tiled_stencil_forces``).  On the TPU, XLA first writes 27
pre-shifted copies of the planes to HBM for it; on the card each
offset's j columns of a block's column tile are one contiguous range
that the block stages in shared memory from the unshifted planes
(``kernels.tiled_stencil_forces``, ``csrc/tiled.cu``).  The reference
reaches it through ``select_kernel`` under LLE_FAST_PALLAS=1; the port
adds no switch, so a caller passes it as ``kernel_fn``.
"""

from __future__ import annotations

import numpy as np

from ..system import System
from . import kernels as K
from .consts import StencilConsts
from .maps import FastMaps
from .place import GridConsts


def make_pallas_kernel(system: System, maps: FastMaps, ex_btype: int):
    """K5 as ``kernel(g, gx, bid, hn, pid, energy) -> (gf, energies (2,),
    ints (2,) = [flag bits, clamps])`` (pallas_kernel.py:59; ``ex_btype``
    as there).  The reference's lane tile has no counterpart: the function
    does not depend on it, and the card's kernel tiles the columns its own
    way (``csrc/tiled.cu``)."""
    assert system.dtype == "float32", "the tiled stencil is the f32 path"
    C = StencilConsts(system, np.float32)

    def kernel(g: GridConsts, gx, bid, hn, pid, energy: bool):
        return K.tiled_stencil_forces(gx, bid, hn, pid, g.interior, C,
                                      system.n, maps.strides, energy)

    return kernel
