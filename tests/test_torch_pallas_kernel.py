"""The tiled full stencil of the port (kernels_ref.tiled_stencil_forces, the
plain version of csrc/tiled.cu; K5's function) against the reference's
engine.make_kernel, which tests/test_pallas_kernel.py:53-68 pins K5 to,
at that file's tolerances (forces 2e-4 * max|f|, energies 5e-2 + 1e-4 *
|e|, flags and clamps equal), in both energy modes, on melt32 with one
FENE bond past the clamp and one past the stencil's reach.  (K5 itself in
interpret mode costs ~7 s on one core: left out to keep the port's tests
inside their time.)  The engine run on it is pinned in
tests/test_torch_segment.py, the CUDA kernel in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lammps_le_torch.fast import kernels as K
from lammps_le_torch.fast import kernels_ref as R
from lammps_le_torch.fast.consts import StencilConsts
from lammps_le_torch.fast.pallas_kernel import make_pallas_kernel
from lammps_le_tpu.fast import engine as ref
from test_torch_blocked import _grid


def _check(got, want):
    gf, en, ints = got
    gf_w, el_w, eb_w, fl_w, cl_w = (np.asarray(o) for o in want)
    scale = max(float(np.abs(gf_w).max()), 1.0)
    assert float(np.abs(gf.numpy() - gf_w).max()) < 2e-4 * scale
    for got_e, want_e in ((en[0], el_w), (en[1], eb_w)):
        assert abs(float(got_e) - float(want_e)) < (
            5e-2 + 1e-4 * abs(float(want_e)))
    assert [int(ints[0]), int(ints[1])] == [int(fl_w), int(cl_w)]
    assert int(ints[0]) == 64 | 8 and int(ints[1]) >= 1


def _planes():
    system, maps, g, (bid, hn, pid), gx = _grid()
    return system, maps, g, (gx, bid, hn, pid)


@pytest.mark.parametrize("energy", [True, False])
def test_tiled_stencil_vs_make_kernel(energy):
    system, maps, g, planes = _planes()
    want = ref.make_kernel(system, ref.fast_maps(system), 2)(
        *(jnp.asarray(t.numpy()) for t in planes), energy)
    got = make_pallas_kernel(system, maps, 2)(g, *planes, energy)
    _check(got, want)
    if not energy:
        assert float(got[1].abs().max()) == 0.0


def test_tiled_wrapper_takes_plain_path_on_cpu():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; the engine's closure is the same function; a plane that is
    on neither the CPU nor a card is refused."""
    system, maps, g, planes = _planes()
    args = (*planes, g.interior, StencilConsts(system), system.n,
            maps.strides, True)
    K.reset_launches()
    a = K.tiled_stencil_forces(*args)
    b = R.tiled_stencil_forces(*args)
    c = make_pallas_kernel(system, maps, 2)(g, *planes, True)
    assert all(torch.equal(x, y) and torch.equal(x, z)
               for x, y, z in zip(a, b, c))
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)
    with pytest.raises(ValueError):
        K.tiled_stencil_forces(planes[0].to("meta"), *args[1:])
