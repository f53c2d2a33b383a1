"""The sharded slab stencil of the port (parallel/shard_step.py: the plain
version of csrc/blocked.cu's window kernel, the margin reactions and the
ghost fold on the assembled planes) against the reference's
make_sharded_kernel in interpret mode on a virtual CPU mesh, at sp=2 and
sp=4 on melt32 (P = 512, margin 73; sp=8 is refused), at the tolerances
of tests/test_shard_step.py:91-100.  The reference runs once, at sp=4
with energies, on a cap-6 grid (its interpret-mode compile, which unrolls
a pass per cell row, is most of this file's time), and both sp and both
energy modes of the port are held to it: the function depends on neither
sp nor the energy mode (which only adds the energy sums); the port's
energy=False call also to the reference's energy=False build.  ``shardable``
gives the reference's verdicts.  The engine run on it is pinned in
tests/test_torch_segment.py, the CUDA kernel in tests/test_torch_cuda.py.
"""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import lammps_le_torch.fixes as tf
from lammps_le_torch import rng
from lammps_le_torch.fast import kernels as K
from lammps_le_torch.fast import kernels_ref as R
from lammps_le_torch.fast import make_fast_segment, replica, stack_fast
from lammps_le_torch.fast.consts import StencilConsts
from lammps_le_torch.integrate import Simulation
from lammps_le_torch.parallel import shard_step as ss
from lammps_le_torch.parallel.spatial import (
    gather_fast_state, make_replicated_sharded_segment, make_sharded_segment,
    replica_blocks, shard_fast_state)
from lammps_le_tpu.fast import engine as ref
from lammps_le_tpu.parallel import shard_step as jss
from test_torch_blocked import _grid
from torch_parity import assert_same_run, fast_start, le_fixes, melt_arrays


def _mesh(sp):
    return Mesh(np.asarray(jax.devices()[:sp]), ("sp",))


@functools.lru_cache(maxsize=None)
def _ref(energy=True):
    """The reference's sharded kernel in interpret mode at sp=4, with
    energies: one call, shared by every case; jitted, since run eagerly
    the interpreter's op-by-op dispatch costs more than the compile.
    ``energy`` False: its build without energies (~8 s more)."""
    system, _, _, (bid, hn, pid), gx = _grid(cap=6)
    mesh = _mesh(4)
    with mesh:
        kern = jss.make_sharded_kernel(system, ref.fast_maps(system), 2, mesh,
                                       interpret=True)
        out = jax.jit(kern, static_argnums=4)(
            *(jnp.asarray(t.numpy()) for t in (gx, bid, hn, pid)), energy)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("sp,energy", [(2, True), (4, True), (2, False),
                                       (4, False)])
def test_sharded_kernel_vs_reference_interpret(sp, energy):
    gf_w, el_w, eb_w, fl_w, cl_w = _ref()
    system, maps, g, (bid, hn, pid), gx = _grid(cap=6)
    assert int(((bid < system.n) & g.interior).sum()) == system.n
    kern = ss.make_sharded_kernel(system, maps, 2, ["cpu"] * sp)
    assert (kern.margin, kern.chunk, kern.window) == (73, 512 // sp,
                                                      512 // sp + 146)
    gf, en, ints = kern(g, gx, bid, hn, pid, energy)
    scale = max(float(np.abs(gf_w).max()), 1.0)
    assert float(np.abs(gf.numpy() - gf_w).max()) < 2e-4 * scale
    if energy:
        for got, want in ((en[0], el_w), (en[1], eb_w)):
            assert abs(float(got) - float(want)) < (
                5e-2 + 1e-4 * abs(float(want)))
    else:
        assert float(en.abs().max()) == 0.0
    assert [int(ints[0]), int(ints[1])] == [int(fl_w), int(cl_w)]
    assert int(ints[0]) == 64 | 8 and int(ints[1]) >= 1
    ghost = ~maps.interior[:maps.p_raw]
    assert np.all(gf.numpy()[:, :, :maps.p_raw][:, :, ghost] == 0.0)


def test_sharded_kernel_energy_off_vs_reference_interpret():
    """The energy=False build of the reference's sharded kernel (K4
    without its energy sums) against the port's energy=False call at
    sp=4: the same forces, flags and clamps, no energies on either."""
    gf_w, el_w, eb_w, fl_w, cl_w = _ref(False)
    system, maps, g, (bid, hn, pid), gx = _grid(cap=6)
    kern = ss.make_sharded_kernel(system, maps, 2, ["cpu"] * 4)
    gf, en, ints = kern(g, gx, bid, hn, pid, False)
    scale = max(float(np.abs(gf_w).max()), 1.0)
    assert float(np.abs(gf.numpy() - gf_w).max()) < 2e-4 * scale
    assert float(el_w) == float(eb_w) == float(en.abs().max()) == 0.0
    assert [int(ints[0]), int(ints[1])] == [int(fl_w), int(cl_w)]
    assert int(ints[0]) == 64 | 8 and int(ints[1]) >= 1


def test_sharded_kernel_matches_newton_half_and_devices():
    """The slab stencil is the Newton-half stencil cut in windows: the
    same forces to f32 round-off as kernels_ref.newton_half_forces; slabs
    on two devices (one launch each) give the same forces, flags and
    clamps as slabs sharing one; the wrapper runs the plain version on
    CPU tensors and launches nothing."""
    system, maps, g, (bid, hn, pid), gx = _grid()
    C = StencilConsts(system)
    gf_n, en_n, in_n = R.newton_half_forces(
        gx, bid, hn, pid, g.interior, g.faces, C, system.n, maps.strides,
        maps.fold_shifts, True)
    one = ss.make_sharded_kernel(system, maps, 2, ["cpu"] * 2)
    two = ss.make_sharded_kernel(system, maps, 2,
                                 ["cpu", torch.device("cpu", 0)])
    K.reset_launches()
    gf1, en1, in1 = one(g, gx, bid, hn, pid, True)
    gf2, en2, in2 = two(g, gx, bid, hn, pid, True)
    scale = max(float(gf_n.abs().max()), 1.0)
    assert float((gf1 - gf_n).abs().max()) <= 3e-5 * scale
    assert torch.equal(gf1, gf2) and torch.equal(in1, in2)
    assert torch.equal(in1, in_n)
    assert torch.allclose(en1, en2, rtol=1e-5) and torch.allclose(
        en1, en_n, rtol=1e-5)
    assert [len(s) for s, _ in two.window_args(gx, bid, hn, pid, True)] \
        == [1, 1]
    (slabs, args), = one.window_args(gx, bid, hn, pid, False)
    assert slabs == [0, 1] and args[0].shape == (3, maps.cap, 2 * 402)
    assert all(torch.equal(a, b) for a, b in zip(K.window_forces(*args),
                                                  R.window_forces(*args)))
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)


@pytest.mark.parametrize("sp", [1, 2, 3, 4, 8])
def test_shardable_gives_the_reference_reasons(sp):
    """P divisible by sp, chunk >= margin, the window inside the VMEM
    envelope: the same verdict, word for word, as the reference."""
    system, maps = _grid()[:2]
    want = jss.shardable(system, ref.fast_maps(system), _mesh(sp))
    assert ss.shardable(system, maps, ["cpu"] * sp) == want
    assert (want is None) == (sp in (1, 2, 4))
    with mock.patch("lammps_le_tpu.fast.blocked_kernel._VMEM_BUDGET",
                    2 * 1024 * 1024), \
            mock.patch.object(ss, "_VMEM_BUDGET", 2 * 1024 * 1024):
        want = jss.shardable(system, ref.fast_maps(system), _mesh(sp))
        assert ss.shardable(system, maps, ["cpu"] * sp) == want
    if sp in (1, 2, 4):
        assert "VMEM envelope" in want


def test_sp_hint_known_reference_fault():
    """Known reference fault (shard_step.py:121), ported as it is: the
    sp-sizing hint divides by ``_VMEM_BUDGET / bpl - 2 * M``, which is
    <= 0 when the budget holds no more than the two margins.  Then the
    hint is negative (here "need sp >= -7") in the reference and in the
    port alike; a budget of exactly two margins raises ZeroDivisionError
    in both."""
    system, maps = _grid()[:2]
    M = sum(maps.strides)
    bpl = ss._BYTES_PER_LANE[maps.cap]
    for budget, want in ((bpl * M, "need sp >= -7"), (bpl * 1.5 * M,
                                                      "need sp >= -14")):
        with mock.patch("lammps_le_tpu.fast.blocked_kernel._VMEM_BUDGET",
                        budget), \
                mock.patch.object(ss, "_VMEM_BUDGET", budget):
            got = ss.shardable(system, maps, ["cpu"] * 2)
            assert got == jss.shardable(system, ref.fast_maps(system),
                                        _mesh(2))
            assert got.endswith(f"({want})")
    with mock.patch("lammps_le_tpu.fast.blocked_kernel._VMEM_BUDGET",
                    bpl * 2 * M), \
            mock.patch.object(ss, "_VMEM_BUDGET", bpl * 2 * M):
        with pytest.raises(ZeroDivisionError):
            jss.shardable(system, ref.fast_maps(system), _mesh(2))
        with pytest.raises(ZeroDivisionError):
            ss.shardable(system, maps, ["cpu"] * 2)


def _le_sim():
    system, _ = melt_arrays()
    return Simulation(system=system, dt=0.005, energy_every=4,
                      fixes=le_fixes(tf), ex_btype=2)


def _run(segment, fs, nsteps=3):
    b = fs.step
    return segment(fs, b, nsteps, b, b + nsteps)


def test_sharded_segment_refuses_what_it_does_not_cover():
    """Where the slab stencil is refused (melt32 at sp=8: its chunk is
    narrower than the margin) make_sharded_segment falls back to the
    unsharded chain with the static schedule, as the reference does
    (spatial.py:97-107): bit for bit make_fast_segment(pallas=False,
    reactive=False), its shard_reason the refusal; make_sharded_kernel
    itself still raises with the reason."""
    system, maps = _grid()[:2]
    sim = _le_sim()
    seg = make_sharded_segment(sim, ["cpu"] * 8)
    assert "margin 73" in seg.shard_reason and seg.kernel_fn is None
    want, _ = make_fast_segment(sim, pallas=False, reactive=False,
                                device="cpu")
    assert_same_run(_run(seg, fast_start(sim)), _run(want, fast_start(sim)))
    assert make_sharded_segment(sim, ["cpu"] * 2).shard_reason is None
    with pytest.raises(ValueError, match="margin 73"):
        ss.make_sharded_kernel(system, maps, 2, ["cpu"] * 8)
    with pytest.raises(ValueError, match="not divisible"):
        ss.make_sharded_kernel(system, maps, 2, ["cpu"] * 3)


@pytest.mark.parametrize("sp", [2, 8])
def test_replicated_sharded_segment(sp):
    """make_replicated_sharded_segment on two replicas over one row of sp
    devices: at sp=2 each replica (``shard_fast_state``'s one-run
    slab-resident states) runs the reactive slab segment, bit for bit
    make_sharded_segment on it alone; at sp=8 (refused) the row's block
    of both replicas (``replica_blocks``) runs the non-reactive chain,
    bit for bit make_fast_segment(pallas=False, reactive=False);
    shard_reason as the reference sets it (spatial.py:203, 226)."""
    sim = _le_sim()
    start = fast_start(sim)
    pair = [dataclasses.replace(start, key_words=rng.fold_in(
        start.key_words, i)) for i in range(2)]
    mesh = [["cpu"] * sp]
    seg = make_replicated_sharded_segment(sim, mesh)
    b = start.step
    if sp == 8:
        assert "margin 73" in seg.shard_reason
        got, = seg(replica_blocks(stack_fast(pair), mesh), b, 3, b, b + 3)
        want, _ = make_fast_segment(sim, pallas=False, reactive=False,
                                    device="cpu")
        assert_same_run(got, _run(want, stack_fast(pair)))
        assert not torch.equal(replica(got, 0).gx, replica(got, 1).gx)
        return
    assert seg.shard_reason is None
    got = [gather_fast_state(r) for r in seg(
        shard_fast_state(stack_fast(pair), mesh), b, 3, b, b + 3)]
    one = make_sharded_segment(sim, mesh[0])
    for run, p in zip(got, pair):
        assert_same_run(run, gather_fast_state(
            one(shard_fast_state(p, mesh[0]), b, 3, b, b + 3)))
    assert not torch.equal(got[0].gx, got[1].gx)
