"""The Newton-half stencil of the port (kernels_ref.newton_half_forces, the
plain version of csrc/blocked.cu) against the reference: the blocked
Pallas kernel K3 in interpret mode (two lane blocks, the last partial) at
its f32 tolerances (forces 3e-5 * max|f|, energies 5e-2 + 1e-4 * |e| as
tests/test_blocked_kernel.py:99-104, flags and clamps equal, ghost
columns exactly zero; each energy mode against the reference's own build
of it, compiled with LLVM's optimisations off), and engine.make_kernel in
f64 at 1e-10.  The
engine picks it past the reference's whole-plane gate in f32 only.  The
engine run on it is pinned in tests/test_torch_segment.py, the CUDA kernel
in tests/test_torch_cuda.py."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lammps_le_torch.fast import engine
from lammps_le_torch.fast import kernels as K
from lammps_le_torch.fast import kernels_ref as R
from lammps_le_torch.fast.consts import StencilConsts
from lammps_le_torch.fast.maps import fast_maps
from lammps_le_torch.fast.place import GridConsts, place
from lammps_le_tpu.fast import engine as ref
from lammps_le_tpu.fast.blocked_kernel import make_blocked_kernel
from torch_parity import make_system, melt_arrays

NP = {"float32": np.float32, "float64": np.float64}


@functools.lru_cache(maxsize=None)
def _grid(dtype="float32", fene_sigma=1.0, cap=8):
    """melt32 on the grid with one FENE bond past the clamp and one past
    the stencil's reach (both flags set); its fullest cell holds 6."""
    _, d = melt_arrays()
    system, _ = make_system(dtype=dtype, fene_sigma=fene_sigma, cap=cap)
    x = d["x"].astype(NP[dtype]).copy()
    x[100, 0] += 1.45
    x[300, 1] += 4.5
    maps = fast_maps(system)
    g = GridConsts.build(system, maps, "cpu")
    xv = torch.tensor(x)
    planes = place(system, maps, g, xv, torch.zeros_like(xv),
                   torch.zeros_like(xv), torch.tensor(d["ex_left"]),
                   torch.tensor(d["ex_right"]), torch.tensor(d["img"]))
    return system, maps, g, planes[3:6], planes[0]


def _port(dtype, energy, fene_sigma=1.0):
    system, maps, g, (bid, hn, pid), gx = _grid(dtype, fene_sigma)
    return R.newton_half_forces(
        gx, bid, hn, pid, g.interior, g.faces,
        StencilConsts(system, NP[dtype]), system.n, maps.strides,
        maps.fold_shifts, energy)


@functools.lru_cache(maxsize=None)
def _k3(energy):
    """The reference's K3 in interpret mode, 384-lane blocks over P = 512
    (two blocks, the second partial), built for ``energy``: compiled with
    LLVM's optimisations off, which halves its compile time (the forces
    within 1e-7 of max|f| of the optimised build's)."""
    system, maps, _, (bid, hn, pid), gx = _grid()
    jmaps = ref.fast_maps(system)
    kern = make_blocked_kernel(system, jmaps, 2, interpret=True, cl=384)
    assert kern.n_blocks == 2 and jmaps.P % kern.block_lanes != 0
    args = tuple(jnp.asarray(t.numpy()) for t in (gx, bid, hn, pid))
    out = jax.jit(kern, static_argnums=4).lower(*args, energy).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("energy", [True, False])
def test_newton_half_vs_blocked_kernel_interpret(energy):
    gf_w, el_w, eb_w, fl_w, cl_w = _k3(energy)
    gf, en, ints = _port("float32", energy)
    scale = max(float(np.abs(gf_w).max()), 1.0)
    assert float(np.abs(gf.numpy() - gf_w).max()) <= 3e-5 * scale
    if energy:
        for got, want in ((en[0], el_w), (en[1], eb_w)):
            assert abs(float(got) - float(want)) <= (
                5e-2 + 1e-4 * abs(float(want)))
    else:
        assert float(en.abs().max()) == 0.0
        assert float(el_w) == 0.0 and float(eb_w) == 0.0
    assert [int(ints[0]), int(ints[1])] == [int(fl_w), int(cl_w)]
    assert int(ints[0]) == 64 | 8 and int(ints[1]) >= 1


def test_newton_half_ghost_columns_zero():
    """Every reaction folds onto an owner: ghost columns of gf are exactly
    zero, in the port as in K3 (comm_brick.cpp:519 reverse_comm)."""
    _, maps, g, _, _ = _grid()
    ghost = ~maps.interior[:maps.p_raw]
    gf_w = _k3(False)[0]
    gf = _port("float32", False)[0].numpy()
    assert np.all(gf_w[:, :, :maps.p_raw][:, :, ghost] == 0.0)
    assert np.all(gf[:, :, :maps.p_raw][:, :, ghost] == 0.0)
    assert float(np.abs(gf).max()) > 0.0


@pytest.mark.parametrize("fene_sigma", [1.0, 0.9])
def test_newton_half_f64_vs_make_kernel(fene_sigma):
    """The math against the reference's full stencil in f64 (op by op, as
    tests/test_torch_stencil.py runs it): forces and energies to 1e-10."""
    system, _, _, (bid, hn, pid), gx = _grid("float64", fene_sigma)
    kern = ref.make_kernel(system, ref.fast_maps(system), 2)
    gf_w, el_w, eb_w, fl_w, cl_w = (np.asarray(o) for o in kern(
        *(jnp.asarray(t.numpy()) for t in (gx, bid, hn, pid)), True))
    gf, en, ints = _port("float64", True, fene_sigma)
    assert float(np.abs(gf.numpy() - gf_w).max()) <= 1e-10
    for got, want in ((en[0], el_w), (en[1], eb_w)):
        assert abs(float(got) - float(want)) <= 1e-10 * max(
            1.0, abs(float(want)))
    assert [int(ints[0]), int(ints[1])] == [int(fl_w), int(cl_w)]


@pytest.mark.parametrize("dtype,slots,newton", [
    ("float32", 9 * 33664, False),       # the 100k-bead bench grid
    ("float32", 9 * 33664 + 128, True),  # one lane block past the gate
    ("float32", 9 * 358144, True),       # config 6
    ("float64", 9 * 358144, False),      # the blocked kernel is f32 only
])
def test_select_kernel_follows_the_whole_plane_gate(dtype, slots, newton):
    system, maps = _grid(dtype)[:2]
    big = dataclasses.replace(maps, cap=9, P=slots // 9)
    assert engine.whole_planes_fit(big) == (slots <= 9 * 33664)
    kern = engine.select_kernel(system, big, 2)
    want = "make_blocked_kernel" if newton else "make_kernel"
    assert kern.__qualname__.split(".")[0] == want


def test_newton_half_wrapper_takes_plain_path_on_cpu():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; the engine's closure is the same function."""
    system, maps, g, (bid, hn, pid), gx = _grid()
    K.reset_launches()
    args = (gx, bid, hn, pid, g.interior, g.faces, StencilConsts(system),
            system.n, maps.strides, maps.fold_shifts, True)
    a = K.newton_half_forces(*args)
    b = R.newton_half_forces(*args)
    c = engine.make_blocked_kernel(system, maps, 2)(g, gx, bid, hn, pid,
                                                   True)
    assert all(torch.equal(x, y) and torch.equal(x, z)
               for x, y, z in zip(a, b, c))
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)
    with pytest.raises(ValueError):
        K.newton_half_forces(gx.to("meta"), *args[1:])
