"""K2a's halo map inverted (``maps.HaloImages``) and the last two public
functions of the reference that the port lacked.

The image map lists each halo column once, under its interior source
column with the reference's source and shift (engine.fast_maps); the
plain ``kick_drift_halo`` driven by it is the reference's kick + drift
(engine.py:1361-1366) then ``_halo_refresh`` (engine.py:562) bit for bit:
on one run, on R = 3 replicas, and on the slabs of sp = 2 and 4 (local
images in place, the others through the slabs' send buffers and
``SlabPlan.halo``), on melt32 and on a geometry with lane-padding
columns.  ``fast_supported`` gives the reference's verdicts on the
Simulations that tests/test_fastpath.py and
tests/test_langevin_options_fast.py gate, and ``extruder_occupancy`` is
the reference's bit for bit.  The CUDA kernel is held to the plain
version by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lammps_le_torch.fixes as tf
import lammps_le_tpu.fixes as jf
from lammps_le_torch.fast import fast_supported
from lammps_le_torch.fast import kernels as K
from lammps_le_torch.fast import kernels_ref as R
from lammps_le_torch.fast.maps import fast_maps
from lammps_le_torch.fast.place import GridConsts, place
from lammps_le_torch.integrate import Simulation
from lammps_le_torch.parallel.shard_step import SlabPlan
from lammps_le_torch.state import extruder_occupancy, state_from_arrays
from lammps_le_tpu import state as jstate
from lammps_le_tpu.fast import engine as ref
from lammps_le_tpu.integrate import Simulation as RefSimulation
from torch_parity import (arrays_of, jax_state, make_system, melt_arrays)

DT, KICK = 0.006, 0.003


def _system(geometry):
    """melt32's system (P = p_raw), or a 700-bead one whose planes end in
    lane-padding columns (P 768, p_raw 648)."""
    if geometry == "melt32":
        return melt_arrays()[0]
    return make_system(n=700)[0]


def _planes(system, R_=1):
    """R_ replicas' planes of the system's beads (each moved by its own
    noise, with random v and f), stacked when R_ > 1: (gx, gv, gf, bid)."""
    maps = fast_maps(system)
    g = GridConsts.build(system, maps, "cpu")
    if system.n == 500:
        x0 = melt_arrays()[1]["x"].astype(np.float64)
    else:
        x0 = make_system(n=system.n)[1].x
    runs = []
    for r in range(R_):
        rng = np.random.default_rng(20 + r)
        x = torch.tensor(x0 + rng.normal(scale=0.02, size=x0.shape),
                         dtype=torch.float32)
        v, f = (torch.tensor(rng.normal(size=x0.shape), dtype=torch.float32)
                for _ in range(2))
        e = system.max_extruders
        none = torch.full((e,), -1, dtype=torch.int64)
        p = place(system, maps, g, x, v, f, none, none,
                  torch.zeros(x.shape, dtype=torch.int64))
        assert int(p[-1]) == 0
        runs.append(p[:4])
    planes = runs[0] if R_ == 1 else tuple(
        torch.stack(t) for t in zip(*runs))
    return maps, g, planes


def _reference(system, gx, gv, gf, bid):
    """The reference's kick + drift then its six-roll halo refresh."""
    j = [jnp.asarray(t.numpy()) for t in (gx, gv, gf, bid)]
    valid = ((j[3] < system.n) & jnp.asarray(
        ref.fast_maps(system).interior)[None, :]).astype(jnp.float32)[None]
    gv_w = j[1] + KICK * j[2] * valid
    gx_w = ref._halo_refresh(j[0] + DT * gv_w * valid,
                             ref.fast_maps(system))
    return np.asarray(gx_w), np.asarray(gv_w)


@pytest.mark.parametrize("geometry", ["melt32", "padded"])
def test_images_cover_every_halo_column_once(geometry):
    """Every halo column (below p_raw, not interior) is the image of
    exactly one interior column, with the reference's source column and
    shift; no other column is an image, and only images skip their own
    x."""
    system = _system(geometry)
    maps, rm = fast_maps(system), ref.fast_maps(system)
    im = maps.images
    halo = np.nonzero(~rm.interior[:rm.p_raw])[0]
    assert im.ptr[-1] == im.src.size == halo.size and not im.sizes
    assert np.array_equal(np.sort(im.dst), halo)
    assert np.array_equal(im.src, rm.src_cols[im.dst])
    assert np.array_equal(im.shift, rm.shifts[im.dst])
    assert rm.interior[im.src].all()
    counts = np.diff(im.ptr)
    assert np.array_equal(np.repeat(np.arange(maps.P), counts), im.src)
    assert counts.max() <= 7 and counts[~rm.interior].max() == 0
    assert np.array_equal(im.own, np.isin(np.arange(maps.P), halo,
                                          invert=True))
    assert (maps.P > maps.p_raw) == (geometry == "padded")
    # the kernel's (base, w): a local image at its column, row stride P
    idx = GridConsts.build(system, maps, "cpu").images.idx.numpy()
    assert np.array_equal(idx, np.stack([im.dst, np.full_like(im.dst,
                                                              maps.P)], 1))


@pytest.mark.parametrize("geometry", ["melt32", "padded"])
def test_plain_by_images_is_the_reference(geometry):
    """One run: kernels_ref.kick_drift_halo driven by the image map is the
    reference's kick + drift + _halo_refresh bit for bit, as the halo
    lists' gather is; the wrapper on CPU tensors is the plain version and
    launches nothing."""
    system = _system(geometry)
    _, g, (gx, gv, gf, bid) = _planes(system)
    args = (gx, gv, gf, bid, g.interior, g.halo_cols, g.halo_src,
            g.halo_shift, system.n, KICK, DT)
    gx_w, gv_w = _reference(system, gx, gv, gf, bid)
    by_images = R.kick_drift_halo(*args, g.images)
    by_lists = R.kick_drift_halo(*args)
    K.reset_launches()
    wrapped = K.kick_drift_halo(*args, images=g.images)
    assert K.LAUNCHES["kick_drift_halo"] == 0
    for got in (by_images, by_lists, wrapped):
        assert len(got) == 2
        np.testing.assert_array_equal(got[0].numpy(), gx_w)
        np.testing.assert_array_equal(got[1].numpy(), gv_w)


def test_plain_by_images_on_replicas():
    """R = 3 replicas' stacked planes, one shared image map: each replica
    the reference's on its own planes, bit for bit."""
    system = _system("padded")
    _, g, planes = _planes(system, 3)
    gx, gv = R.kick_drift_halo(*planes, g.interior, g.halo_cols, g.halo_src,
                               g.halo_shift, system.n, KICK, DT, g.images)
    assert gx.shape == planes[0].shape
    for r in range(3):
        gx_w, gv_w = _reference(system, *(t[r] for t in planes))
        np.testing.assert_array_equal(gx[r].numpy(), gx_w)
        np.testing.assert_array_equal(gv[r].numpy(), gv_w)
    assert not torch.equal(gx[0], gx[1])


@pytest.mark.parametrize("geometry,sp", [("melt32", 2), ("melt32", 4),
                                         ("padded", 2), ("padded", 4)])
def test_slab_images_give_the_whole_halo(geometry, sp):
    """Per slab, the plain version with the slab's image map writes its
    local images and returns its send buffer; ``SlabPlan.halo`` from the
    send buffers then completes every slab's halo: the slabs side by side
    are the reference's whole planes bit for bit.  Every halo column is
    written once, locally or through exactly one send segment."""
    system = _system(geometry)
    maps, _, (gx, gv, gf, bid) = _planes(system)
    plan = SlabPlan(system, maps, ["cpu"] * sp)
    C = maps.P // sp
    xs, vs, sends = [], [], []
    for s in range(sp):
        cut = [t[..., s * C:(s + 1) * C].contiguous()
               for t in (gx, gv, gf, bid)]
        out = R.kick_drift_halo(*cut, plan.interior[s],
                                *plan.images[s].halo_lists, system.n, KICK,
                                DT, plan.images[s])
        im = plan.images[s]
        assert len(out) == (3 if im.sizes else 2)
        if im.sizes:
            assert out[2].shape == (3 * maps.cap * im.n_send,)
        xs.append(out[0])
        vs.append(out[1])
        sends.append(out[2] if im.sizes else None)
    plan.halo(xs, sends)
    gx_w, gv_w = _reference(system, gx, gv, gf, bid)
    np.testing.assert_array_equal(torch.cat(xs, -1).numpy(), gx_w)
    np.testing.assert_array_equal(torch.cat(vs, -1).numpy(), gv_w)
    # each halo column once: a slab's local images plus what it receives
    halo = np.nonzero(~maps.interior[:maps.p_raw])[0]
    landed = np.concatenate(
        [im.loc_dst.numpy() + s * C for s, im in enumerate(plan.images)]
        + [dst.numpy() + s * C for s, pairs in enumerate(plan.halo_pairs)
           for _, _, _, dst in pairs])
    assert np.array_equal(np.sort(landed), halo)
    assert sum(len(p) for p in plan.halo_pairs) > 0


def _fast_sims(mod, Sim, system):
    """The Simulations that tests/test_fastpath.py:70 and
    tests/test_langevin_options_fast.py:65 gate, in ``mod``'s fixes."""
    lan = mod.Langevin
    return [
        Sim(system=system, dt=0.006, fixes=(mod.NVE(),), ex_btype=2),
        Sim(system=system, dt=0.006, fixes=(mod.NVE(group="half"),),
            ex_btype=2),
        Sim(system=system, dt=0.005, ex_btype=0, fixes=(
            mod.NVE(), lan(1.0, 1.0, 10.0, seed=3, zero=True,
                           group="half"))),
        Sim(system=system, dt=0.005, ex_btype=0, fixes=(
            mod.NVE(), lan(1.0, 1.0, 10.0, seed=3, tally=True))),
        Sim(system=system, dt=0.005, ex_btype=0, fixes=(
            mod.NVE(), lan(1.0, 1.0, 10.0, seed=3, gjf="vhalf"))),
    ]


def test_fast_supported_is_the_reference():
    """The reference's fast_supported verdicts (True, False, True, False,
    False) on the gated Simulations, Simulation for Simulation."""
    system = _system("melt32")
    want = [ref.fast_supported(s)
            for s in _fast_sims(jf, RefSimulation, system)]
    got = [fast_supported(s) for s in _fast_sims(tf, Simulation, system)]
    assert got == want == [True, False, True, False, False]


def test_extruder_occupancy_is_the_reference():
    """melt32's state with six active extruders, one slot cleared between
    them and the rest inactive: the (N,) occupancy bit for bit."""
    system, d = melt_arrays()
    d = dict(d)
    d["ex_left"], d["ex_right"] = d["ex_left"].copy(), d["ex_right"].copy()
    d["ex_left"][2] = d["ex_right"][2] = -1
    js = jax_state(d, jnp.float32)
    want = np.asarray(jstate.extruder_occupancy(js, system.n))
    got = extruder_occupancy(state_from_arrays(arrays_of(js), "cpu"),
                             system.n)
    assert got.dtype == torch.bool and got.shape == (system.n,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(want.sum()) == 10
