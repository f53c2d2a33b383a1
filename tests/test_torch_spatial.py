"""The slab-resident layout of the port (parallel/spatial.py: the
counterparts of the reference's ``fast_state_specs`` and
``shard_fast_state``, their inverse ``gather_fast_state``, the dp x sp
segment) and the slab step's exchanges (shard_step.SlabPlan) and split
Langevin pass, on melt32 on CPU meshes (``["cpu"] * k``).

``fast_state_specs`` classifies every field as the reference's does (one
melt32 state with a Langevin group plane, sp and dp x sp);
``shard_fast_state`` then ``gather_fast_state`` is bit for bit the state
at sp = 2 and 4 and at dp = 2 x sp = 2; the slabs' ghost fold and halo
refresh (each slab's image map: its local images and its send buffer)
are the whole planes' bit for bit; the split Langevin pass
(``langevin_sums``, ``langevin_kick_parts``, ``merge_monitor``) is the
whole pass bit for bit on one slab, and its monitor is the whole pass's
over slabs; ``make_replicated_sharded_segment`` on a 2 x 2 mesh runs each
replica bit for bit as ``make_sharded_segment`` runs it alone, and on a
refused geometry runs each row's block on the reference's fallback.  The
segment itself is pinned in tests/test_torch_slab_step.py and
tests/test_torch_segment.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lammps_le_torch.fixes as tf
import lammps_le_tpu.fixes as jf
from lammps_le_torch import rng
from lammps_le_torch.fast import kernels_ref as R
from lammps_le_torch.fast import (make_fast_segment, replica, stack_fast,
                                  to_fast)
from lammps_le_torch.fast.maps import fast_maps
from lammps_le_torch.fast.place import GridConsts, halo_refresh
from lammps_le_torch.integrate import Simulation
from lammps_le_torch.parallel.shard_step import SlabPlan
from lammps_le_torch.parallel.slab_step import merge_monitor
from lammps_le_torch.parallel.spatial import (
    ShardedFastState, fast_state_specs, gather_fast_state,
    make_replicated_sharded_segment, make_sharded_segment, replica_blocks,
    shard_fast_state)
from lammps_le_tpu.fast import engine as ref
from lammps_le_tpu.integrate import Simulation as RefSimulation
from lammps_le_tpu.parallel import spatial as jspatial
from test_torch_slab_step import _groups, _sim
from torch_parity import jax_state, le_fixes, melt_arrays, start_state


def _group_fixes(mod):
    fixes = list(le_fixes(mod))
    fixes[1] = mod.Langevin(t_start=1.0, t_stop=1.0, damp=10.0,
                            seed=904297, group="chain")
    return tuple(fixes)


def _start(lan="group"):
    sim = _sim(lan)
    return sim, to_fast(start_state(), sim, groups=_groups(lan))


@pytest.mark.parametrize("dp", [False, True])
def test_fast_state_specs_are_the_reference(dp):
    """The reference's rule on its own FastState (shapes only:
    jax.eval_shape of its to_fast) and the port's on the port's, field for
    field: the planes (gx, gv, gf, gx_ref, bid, hn, pid, lgm) split their
    columns over sp, the rest is global-small; under dp the replica axis
    splits everywhere."""
    system, d = melt_arrays()
    rsim = RefSimulation(system=system, dt=0.005, energy_every=4,
                         fixes=_group_fixes(jf), ex_btype=2)
    groups = _groups("group")
    fj = jax.eval_shape(lambda s: ref.to_fast(s, rsim, groups=groups),
                        jax_state(d, jnp.float32))
    sim = Simulation(system=system, dt=0.005, energy_every=4,
                     fixes=_group_fixes(tf), ex_btype=2)
    fs = to_fast(start_state(), sim, groups=groups)
    if dp:
        fj = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct((2,) + a.shape, a.dtype), fj)
        fs = stack_fast([fs, fs])
    want = jspatial.fast_state_specs(fj, sp_axis="sp",
                                     dp_axis="dp" if dp else None)
    got = fast_state_specs(fs, dp=dp)
    lead = ("dp",) if dp else ()
    common = [f.name for f in dataclasses.fields(want) if f.name in got]
    assert len(common) == len(got) - 1  # all but the port's key_words
    for name in common:
        w = getattr(want, name)
        assert got[name] == (None if w is None else tuple(w)), name
    split = {k for k, v in got.items() if v and v[-1] == "sp"}
    assert split == {"gx", "gv", "gf", "gx_ref", "bid", "hn", "pid", "lgm"}
    assert got["img"] == got["key_words"] == got["step"] == lead


@pytest.mark.parametrize("layout", ["sp2", "sp4", "dp2xsp2"])
def test_shard_then_gather_is_bitwise(layout):
    """Slab s holds columns [s C, (s + 1) C) of every plane on mesh[s] (a
    row's devices for each replica under dp), the global-small fields stay
    whole; gathering gives the state back bit for bit, gx_ref again the
    same tensor as gx."""
    sim, fs = _start()
    if layout == "dp2xsp2":
        fs = stack_fast([dataclasses.replace(
            fs, key_words=rng.fold_in(fs.key_words, i)) for i in range(4)])
        mesh = [["cpu", "cpu"], ["cpu", torch.device("cpu", 0)]]
        runs = shard_fast_state(fs, mesh)
        assert [r.mesh for r in runs] == [tuple(torch.device(d)
                                                for d in mesh[r // 2])
                                          for r in range(4)]
        parts = [(replica(fs, r), run) for r, run in enumerate(runs)]
        back = gather_fast_state(runs)
        with pytest.raises(ValueError, match="dp x sp"):
            shard_fast_state(fs, mesh[0])
    else:
        sp = int(layout[2])
        run = shard_fast_state(fs, ["cpu"] * sp)
        parts = [(fs, run)]
        back = gather_fast_state(run)
    for one, run in parts:
        assert isinstance(run, ShardedFastState)
        C = one.bid.shape[-1] // len(run.mesh)
        for name in ("gx", "gf", "bid", "hn", "pid", "lgm"):
            for s, slab in enumerate(getattr(run, name)):
                assert torch.equal(slab, getattr(one, name)[
                    ..., s * C:(s + 1) * C]) and slab.is_contiguous(), name
        # gx_ref is gx after a rebuild: one set of slabs (a replica's
        # views of a batched state are two tensors)
        assert run.gx_ref is run.gx or layout == "dp2xsp2"
        assert torch.equal(run.slot_of, one.slot_of)
    assert back.gx_ref is back.gx or layout == "dp2xsp2"
    for field in dataclasses.fields(fs):
        a, b = getattr(back, field.name), getattr(fs, field.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), field.name
        else:
            assert a == b, field.name
    with pytest.raises(ValueError, match="not divisible"):
        shard_fast_state(replica(fs, 0) if fs.replicas else fs, ["cpu"] * 3)


def _split(plane, sp):
    C = plane.shape[-1] // sp
    return [plane[..., s * C:(s + 1) * C].contiguous() for s in range(sp)]


@pytest.mark.parametrize("sp", [2, 4])
def test_slab_exchanges_are_the_whole_planes(sp):
    """The slabs' ghost fold (each face's columns sent to the slab of the
    columns they image, past the margin) is kernels_ref.ghost_fold on the
    whole planes, and the halo refresh (each slab's image map: its local
    images in place, the others through its send buffer to the slabs
    they land in) the whole planes' gather, bit for bit, on random
    planes."""
    system, _ = melt_arrays()
    maps = fast_maps(system)
    plan = SlabPlan(system, maps, ["cpu"] * sp)
    g = GridConsts.build(system, maps, "cpu")
    f = torch.as_tensor(np.random.default_rng(sp).normal(
        size=(3, maps.cap, maps.P)).astype(np.float32))
    want = R.ghost_fold(f, g.faces, maps.fold_shifts)
    got = torch.cat([plan.plane(b) for b in plan._fold(_split(f, sp))], -1)
    assert torch.equal(got, want)
    want = halo_refresh(f.clone(), g)
    slabs = _split(f, sp)
    sends = [R.halo_images(x, im) for x, im in zip(slabs, plan.images)]
    plan.halo(slabs, sends)
    assert torch.equal(torch.cat(slabs, -1), want)
    assert sum(len(p) for p in plan.halo_pairs) > 0


@pytest.mark.parametrize("lan", ["all", "group", "zero"])
def test_split_langevin_is_the_whole_pass(lan):
    """langevin_sums then langevin_kick_parts given the means, merged by
    merge_monitor, is langevin_kick_monitor bit for bit on one slab (the
    whole plane); over two slabs, given the same means, the forces are
    the whole pass's and the monitor merges to its flag bits and
    trigger."""
    sim, fs = _start("zero" if lan == "zero" else lan)
    system, n = sim.system, sim.system.n
    g = GridConsts.build(system, fast_maps(system), "cpu")
    key, sstep = (7, 9), 33
    args = (fs.gx, fs.gx_ref + 0.02 * torch.sin(fs.gx), fs.gv, fs.gf,
            fs.bid, g.interior, key, sstep, -0.1, 0.7, 0.003, 0.012, 0.01,
            0.02, n, True, fs.lgm, lan == "zero")
    gf_w, gv_w, ints_w = R.langevin_kick_monitor(*args)
    means = None
    if lan == "zero":
        sums = R.langevin_sums(fs.gx, fs.bid, g.interior, fs.lgm, key,
                               sstep, n)
        means = sums[:3] * (1.0 / torch.clamp(sums[3], min=1.0))
    gf, gv, parts = R.langevin_kick_parts(*args[:12], n, True, fs.lgm,
                                          means)
    assert torch.equal(gf, gf_w) and torch.equal(gv, gv_w)
    assert torch.equal(merge_monitor(parts[None], 0.01, 0.02), ints_w)
    assert int(ints_w[0]) and int(ints_w[1])
    C = g.interior.shape[0] // 2
    halves = [R.langevin_kick_parts(
        *(_split(a, 2)[s] for a in args[:5]), g.interior[s * C:][:C],
        key, sstep, -0.1, 0.7, 0.003, 0.012, n, True,
        None if fs.lgm is None else _split(fs.lgm, 2)[s], means)
        for s in range(2)]
    assert torch.equal(merge_monitor(torch.stack([p for _, _, p in halves]),
                                       0.01, 0.02), ints_w)
    assert torch.equal(torch.cat([h[0] for h in halves], -1), gf_w)


def test_replicated_sharded_segment_on_a_2x2_mesh():
    """Two replicas on a dp = 2 x sp = 2 mesh, one a row, each with its
    own key, skin trigger and rebuild count: bit for bit
    make_sharded_segment on each alone, on its row's devices."""
    sim, start = _start("all")
    pair = [dataclasses.replace(start, key_words=rng.fold_in(
        start.key_words, i)) for i in range(2)]
    mesh = [["cpu", "cpu"], [torch.device("cpu", 0)] * 2]
    seg = make_replicated_sharded_segment(sim, mesh)
    assert seg.shard_reason is None
    b = start.step
    runs = seg(shard_fast_state(stack_fast(pair), mesh), b, 6, b, b + 6)
    one = make_sharded_segment(sim, mesh[0])
    for run, p, row in zip(runs, pair, mesh):
        alone = gather_fast_state(one(shard_fast_state(p, row), b, 6, b,
                                      b + 6))
        got = gather_fast_state(run)
        assert run.mesh == tuple(torch.device(d) for d in row)
        for field in dataclasses.fields(got):
            a, w = getattr(got, field.name), getattr(alone, field.name)
            assert (torch.equal(a, w) if isinstance(w, torch.Tensor)
                    else a == w), field.name
    assert not torch.equal(runs[0].gx[0], runs[1].gx[0])


def test_replicated_fallback_runs_each_rows_block():
    """melt32 at sp = 8 is refused (its chunk is narrower than the
    margin): each row's block of replicas (``replica_blocks``) runs the
    batched non-reactive chain on the row's first device, bit for bit
    make_fast_segment(pallas=False, reactive=False) on all replicas."""
    sim, start = _start("all")
    quad = stack_fast([dataclasses.replace(start, key_words=rng.fold_in(
        start.key_words, i)) for i in range(4)])
    mesh = [["cpu"] * 8] * 2
    seg = make_replicated_sharded_segment(sim, mesh)
    assert "margin 73" in seg.shard_reason and seg.kernel_fn is None
    b = start.step
    blocks = seg(replica_blocks(quad, mesh), b, 3, b, b + 3)
    assert [blk.replicas for blk in blocks] == [2, 2]
    want, _ = make_fast_segment(sim, pallas=False, reactive=False,
                                device="cpu")
    want = want(quad, b, 3, b, b + 3)
    got = gather_fast_state(blocks)
    for name in ("gx", "gv", "bid", "pid", "ex_left", "flags", "n_moves"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    with pytest.raises(TypeError, match="gather_fast_state"):
        make_sharded_segment(sim, mesh[0])(
            shard_fast_state(start, mesh[0]), b, 1, b, b + 1)
