"""The reactive chain step on a slab-resident state (``spatial
.ShardedFastState``): the reference's sharded segment
(``lammps_le_tpu/parallel/spatial.py:69-121``), its XLA chain around the
slab stencil K4, stepped one host-driven step at a time.

A step, in the chain's order (``fast/engine.py``'s ``step``):

* the rebuild when due (the schedule or the armed skin trigger) and, on
  an LE event step, the events and their rebuild, on ``mesh[0]`` from
  the slabs gathered there (rebuild's sort and scatter are global ops,
  spatial.py:17-19), then split again;
* kick + drift per slab (``kernels.kick_drift_halo`` with the slab's
  image map: the halo columns whose source the slab owns, and the send
  buffer of the others), then the remote halo columns from their
  sources' send buffers;
* the slab stencil (``window_forces``, one launch per device), the
  margins' reactions, the ghost fold, and the extruder springs on the
  anchors gathered onto ``mesh[0]`` (``shard_step.SlabPlan``);
* the Langevin pass per slab, split at ``zero``'s means
  (``kernels.langevin_sums`` per slab, summed on ``mesh[0]`` in slab
  order, then ``kernels.langevin_kick_parts`` given the means), the
  slabs' monitor values merged on ``mesh[0]`` (``merge_monitor``) into
  the flag bits and the trigger, the step's one host read.

Every value is the whole-state chain's on ``make_sharded_kernel`` (the
same operations on the same operands), but ``zero``'s group means,
whose sum over the slabs is taken in another order than the whole
plane's.
"""

from __future__ import annotations

import torch

from ..fast import kernels as K
from ..fast.engine import chain_parts
from ..fast.maps import fast_maps
from ..state import FLAG_SKIN_VIOLATION
from .shard_step import SlabPlan, make_sharded_kernel
from .spatial import ShardedFastState, gather_fast_state, shard_fast_state

# the planes a rebuild and LE events read: the beads' x, v, f from their
# slots, the group plane, and bid (a FastState's replica count)
_BOUNDARY = ("gx", "gv", "gf", "bid", "lgm")


def merge_monitor(parts, bad_cut: float, trig_cut: float):
    """The skin monitor of a whole run from its slabs' ``parts`` ((S, 3),
    ``kernels.langevin_kick_parts``' values in slab order): the largest
    squared displacement M over the slabs, the largest value below it (a
    slab's largest where that is not M, else the slab's second), and the
    largest look-ahead, merged as the whole-plane pass merges its blocks
    in its last one; returns ``langevin_kick_monitor``'s ints (2,) int64
    = [flag bits, trig]."""
    m1 = parts[:, 0]
    top = torch.max(m1)
    m2 = torch.max(torch.where(m1 == top, parts[:, 1], m1))
    bad = torch.sqrt(top) + torch.sqrt(m2) > bad_cut
    trig = torch.max(parts[:, 2]) > trig_cut
    return torch.stack([bad.to(torch.int64) * FLAG_SKIN_VIOLATION,
                        trig.to(torch.int64)])


def make_slab_segment(sim, mesh):
    """The reactive chain on slab-resident states of ``len(mesh)`` slabs:
    ``segment(sfs, step0, length, run_begin, run_end)`` advances a
    ShardedFastState in place; its ``kernel_fn`` is
    ``make_sharded_kernel``'s stencil on ``mesh`` (``to_fast``'s), its
    ``plan(sfs)`` the state's ``SlabPlan``.  A state whose slabs lie on
    another row of devices of the same length steps there."""
    system = sim.system
    maps = fast_maps(system)
    nsp = len(mesh)
    kernel_fn = make_sharded_kernel(system, maps, sim.ex_btype, mesh)
    n = system.n
    plans, parts = {}, {}

    def plan(sfs) -> SlabPlan:
        if sfs.mesh not in plans:
            plans[sfs.mesh] = SlabPlan(system, maps, sfs.mesh)
        return plans[sfs.mesh]

    def hooks(sfs):
        """The chain's parts (``engine.chain_parts``) on the state's
        ``mesh[0]``, where its global-small fields, rebuilds and LE events
        live."""
        home = sfs.mesh[0]
        if home not in parts:
            parts[home] = chain_parts(sim, kernel_fn=kernel_fn, device=home)
        return parts[home]

    def boundary(sfs, work):
        """``work`` on the FastState gathered on ``mesh[0]``, split
        again."""
        fs = gather_fast_state(sfs, _BOUNDARY)
        work(fs)
        new = shard_fast_state(fs, sfs.mesh)
        for name, v in vars(new).items():
            setattr(sfs, name, v)

    def events(h, sstep):
        def work(fs):
            h.apply_events(fs, sstep)
            h.rebuild(fs)

        return work

    def step(sfs, sstep: int, run_begin: int, run_end: int):
        p, h = plan(sfs), hooks(sfs)
        S = h.ctx.S
        if h.rebuild_due(sfs, sstep):
            # served BEFORE the drift (engine.py:1349-1360)
            boundary(sfs, h.rebuild)
        gx, gv, sends = [], [], []
        for s in range(nsp):
            # a slab whose columns image into no other returns no buffer
            x, v, *send = K.kick_drift_halo(
                sfs.gx[s], sfs.gv[s], sfs.gf[s], sfs.bid[s], p.interior[s],
                *p.images[s].halo_lists, n, h.kick, h.dt, p.images[s])
            gx.append(x)
            gv.append(v)
            sends.append(send[0] if send else None)
        p.halo(gx, sends)
        sfs.gx, sfs.gv = tuple(gx), tuple(gv)
        sfs.step = sstep
        if h.is_event(sstep):
            # the events and the post-event rebuild
            boundary(sfs, events(h, sstep))

        energy = sstep % h.energy_every == 0
        cache = sfs.cache
        if "wints" not in cache:
            cache["wints"] = p.window_ints(sfs.bid, sfs.hn, sfs.pid)
        bufs, en, ints = p.forces(list(sfs.gx), cache["wints"], energy)
        if S is not None and sfs.exl_slot.shape[-1]:
            active = sfs.ex_left >= 0
            if "anchors" not in cache:
                cache["anchors"] = p.anchors(sfs.exl_slot, sfs.exr_slot,
                                             active)
            eb = p.springs(sfs.gx, bufs, cache["anchors"], active, S)
            if energy:
                en = en + torch.stack([torch.zeros_like(en[0]), eb.sum()])
        h.tally(sfs, en, ints, energy)

        key, gamma1, gamma2 = h.langevin_args(sfs, sstep, run_begin,
                                              run_end)
        lgm = sfs.lgm or (None,) * nsp
        means = (None,) * nsp
        if h.zero:
            tot = None
            for s in range(nsp):
                part = p.recv(K.langevin_sums(
                    sfs.gx[s], sfs.bid[s], p.interior[s], lgm[s], key,
                    sstep, n), s, 0)
                tot = part if tot is None else tot + part
            inv = (1.0 / n if sfs.lgm is None
                   else 1.0 / torch.clamp(tot[3], min=1.0))
            mean = tot[:3] * inv
            means = [p.recv(mean, 0, s) for s in range(nsp)]
        gf, gv, parts = [], [], []
        for s in range(nsp):
            f, v, pt = K.langevin_kick_parts(
                sfs.gx[s], sfs.gx_ref[s], sfs.gv[s], p.plane(bufs[s]),
                sfs.bid[s], p.interior[s], key, sstep, gamma1, gamma2,
                h.kick, h.dt, n, h.langevin is not None, lgm[s], means[s])
            gf.append(f)
            gv.append(v)
            parts.append(p.recv(pt, s, 0))
        sfs.gf, sfs.gv = tuple(gf), tuple(gv)
        mon = merge_monitor(torch.stack(parts), h.bad_cut, h.trig_cut)
        sfs.flags = sfs.flags | mon[0]
        # the one host read of the step: the armed trigger
        sfs.skin_pend = int(mon[1])
        return sfs

    def segment(sfs, step0: int, length: int, run_begin: int, run_end: int):
        if not isinstance(sfs, ShardedFastState):
            raise TypeError("the sharded segment steps a slab-resident "
                            "state: shard_fast_state(fs, mesh) it first")
        if len(sfs.mesh) != nsp:
            raise ValueError(f"a state of {len(sfs.mesh)} slabs on a "
                             f"segment of {nsp}")
        for i in range(length):
            step(sfs, step0 + i + 1, run_begin, run_end)
        return sfs

    segment.kernel_fn = kernel_fn
    segment.plan = plan
    return segment
