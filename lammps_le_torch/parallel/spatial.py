"""Spatial (sp) decomposition of the fast engine's cell planes: the
counterpart of ``lammps_le_tpu/parallel/spatial.py``.

The flat cell order is x-major, so contiguous column ranges are x-slabs,
the geometry of the reference's bricks (comm_brick.cpp:150-700).  The
reference's ``Mesh`` with an ``sp`` axis is here ``mesh``: an ordered
sequence of ``torch.device``, one per slab, driven by one process as
JAX's single controller drives its mesh; slabs may share a device.  A dp
x sp mesh is a sequence of dp such rows.

``shard_fast_state`` lays a FastState out as the reference's
``fast_state_specs`` classifies it: slab s holds its own columns [s C,
(s + 1) C) of every (3, cap, P) and (cap, P) plane on ``mesh[s]``
(``ShardedFastState``); the global-small fields (bead-layout arrays,
extruder tables, counters, flags, energies, host ints) stay whole, once,
on ``mesh[0]``.  The reference replicates them on every shard, because
every SPMD shard computes them; here one controller computes them, so it
keeps one copy.  ``gather_fast_state`` is the inverse, bit for bit.

``make_sharded_segment`` steps a ShardedFastState with the reactive
chain's step on the slabs (``slab_step.py``): the stencil, the kick and
drift, the Langevin pass and the monitor per slab, and placement and LE
events, global ops in the reference too (spatial.py:17-19), on
``mesh[0]`` from the slabs gathered there.  Where ``shardable`` refuses
the geometry it keeps the reference's fallback, the non-reactive chain
on a whole FastState.  ``make_replicated_sharded_segment`` adds the dp
axis: contiguous replica blocks over the mesh's rows, each replica on
the slab step with its own trigger, or each row's block on the batched
non-reactive chain where the geometry is refused.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fast.engine import FastState, make_fast_segment, replica, stack_fast
from ..fast.maps import fast_maps
from .shard_step import send, shardable

# the plane fields (split on their column axis); every other field of a
# FastState is global-small
PLANES = ("gx", "gv", "gf", "gx_ref", "bid", "hn", "pid", "lgm")


@dataclasses.dataclass
class ShardedFastState:
    """A FastState of one run held in slabs: ``mesh`` the slabs' devices;
    each plane field a tuple of its slabs' (.., cap, C) column ranges, slab
    s on ``mesh[s]`` (``lgm`` None without a Langevin group); every other
    field as FastState's, its tensors on ``mesh[0]``.  ``cache`` holds what
    the slab step derives from the integer planes between rebuilds."""

    mesh: tuple
    gx: tuple
    gv: tuple
    gf: tuple
    gx_ref: tuple
    bid: tuple
    hn: tuple
    pid: tuple
    slot_of: torch.Tensor
    exl_slot: torch.Tensor
    exr_slot: torch.Tensor
    types: torch.Tensor
    img: torch.Tensor
    ex_left: torch.Tensor
    ex_right: torch.Tensor
    key_words: tuple
    step: int
    flags: torch.Tensor
    epair: torch.Tensor
    ebond: torch.Tensor
    n_moves: torch.Tensor
    n_loads: torch.Tensor
    n_unloads: torch.Tensor
    n_clamps: torch.Tensor
    last_event: torch.Tensor
    skin_pend: int
    n_rebuilds: int = 0
    n_launches: int = 0
    lgm: tuple = None
    cache: dict = dataclasses.field(default_factory=dict)

    # one run (the engine's parts ask)
    replicas = None


def fast_state_specs(fs: FastState, sp: bool = True, dp: bool = False):
    """{field: spec} of every FastState field, the reference's rule
    (spatial.py:38-55): a (3, cap, P) plane splits its column axis over
    ``sp``, a (cap, P) plane (its last axis the planes' P) too, and every
    other field is global-small; with ``dp`` a replica-batched state
    splits its leading replica axis over ``dp`` in every field.  A spec
    is a tuple of axis names ("dp", "sp") and None, one per axis, as the
    reference's PartitionSpec (None for an absent field)."""
    lead = ("dp",) if dp else ()
    axis = "sp" if sp else None
    P = fs.bid.shape[-1]
    out = {}
    for field in dataclasses.fields(FastState):
        v = getattr(fs, field.name)
        nd = v.dim() - len(lead) if isinstance(v, torch.Tensor) else None
        if v is None:
            out[field.name] = None
        elif nd == 3:
            out[field.name] = lead + (None, None, axis)
        elif nd == 2 and v.shape[-1] == P:
            out[field.name] = lead + (None, axis)
        else:
            out[field.name] = lead
    return out


def _rows(mesh):
    """A mesh as dp rows of devices: a flat sequence of devices is one
    row."""
    rows = [mesh] if isinstance(mesh[0], (str, torch.device)) else mesh
    rows = [tuple(torch.device(d) for d in row) for row in rows]
    if len({len(r) for r in rows}) != 1:
        raise ValueError("a dp x sp mesh's rows hold sp devices each")
    return rows


def _blocks(R: int, rows):
    """Replica r's row: R in contiguous blocks over the rows, as P(dp)
    splits a replica axis."""
    if R % len(rows):
        raise ValueError(f"{R} replicas over {len(rows)} rows: R must be "
                         f"divisible by dp")
    return [rows[r // (R // len(rows))] for r in range(R)]


def shard_fast_state(fs: FastState, mesh):
    """``fs`` laid out over ``mesh`` as ``fast_state_specs`` classifies
    it.  One run's state over a row of sp devices: a ShardedFastState
    (slab s's column ranges on ``mesh[s]``, the global-small fields on
    ``mesh[0]``).  R replicas' state over a dp x sp mesh: a list of R
    one-run ShardedFastStates, replica r on row r // (R / dp).  Raises
    ValueError where the planes' P or R do not divide."""
    if fs.replicas:
        rows = _rows(mesh)
        if not isinstance(mesh[0], (list, tuple)):
            raise ValueError("a replica-batched state shards over a dp x sp "
                             "mesh (a sequence of rows)")
        return [shard_fast_state(replica(fs, r), row)
                for r, row in enumerate(_blocks(fs.replicas, rows))]
    row = _rows(mesh)
    if len(row) != 1:
        raise ValueError("one run's state shards over one row of devices")
    row = row[0]
    P, nsp = fs.bid.shape[-1], len(row)
    if P % nsp:
        raise ValueError(f"P={P} not divisible by sp={nsp}")
    C = P // nsp
    split = {}
    kw = {}
    for name, spec in fast_state_specs(fs).items():
        v = getattr(fs, name)
        if spec and spec[-1] == "sp":
            # gx_ref is gx right after a rebuild: one set of slabs.  Slab
            # 0 lives with the global-small fields: its columns are not
            # sent between slabs
            if id(v) not in split:
                split[id(v)] = (v[..., :C].to(
                    row[0], copy=True,
                    memory_format=torch.contiguous_format),) + tuple(
                    send(v[..., s * C:(s + 1) * C].contiguous(), dev)
                    for s, dev in enumerate(row) if s)
            kw[name] = split[id(v)]
        elif isinstance(v, torch.Tensor):
            kw[name] = v.to(row[0], non_blocking=True)
        else:
            kw[name] = v
    return ShardedFastState(mesh=tuple(row), **kw)


def _cat(slabs, home):
    """Whole planes from their slabs, on ``home`` (slab 0's device)."""
    return torch.cat([p if s == 0 else send(p, home)
                      for s, p in enumerate(slabs)], dim=-1)


def gather_fast_state(sfs, planes=PLANES) -> FastState:
    """The FastState a ShardedFastState holds, on its ``mesh[0]``, bit for
    bit what ``shard_fast_state`` was given (``planes``: the plane fields
    to assemble, the others None).  A list of them (``shard_fast_state``'s
    replicas), or of replica-batched FastStates (``replica_blocks``), is
    gathered into one replica-batched FastState on the first one's
    device."""
    if isinstance(sfs, (list, tuple)):
        runs = []
        for x in sfs:
            if isinstance(x, ShardedFastState):
                runs.append(gather_fast_state(x))
            else:
                runs += [replica(x, r) for r in range(x.replicas)]
        dev = runs[0].gx.device
        return stack_fast([_on(fs, dev) for fs in runs])
    home = sfs.mesh[0]
    whole = {}
    kw = {}
    for field in dataclasses.fields(FastState):
        v = getattr(sfs, field.name)
        if field.name in PLANES and v is not None:
            if field.name not in planes:
                v = None
            else:
                # gx_ref and gx one set of slabs: one tensor again
                if id(v) not in whole:
                    whole[id(v)] = _cat(v, home)
                v = whole[id(v)]
        kw[field.name] = v
    return FastState(**kw)


def _on(fs: FastState, dev) -> FastState:
    """``fs`` with its tensors on ``dev``."""
    return dataclasses.replace(fs, **{
        f.name: getattr(fs, f.name).to(dev)
        for f in dataclasses.fields(FastState)
        if isinstance(getattr(fs, f.name), torch.Tensor)})


def replica_blocks(fs: FastState, mesh):
    """A replica-batched FastState as dp contiguous blocks, block b a
    replica-batched FastState on row b's first device: the state of
    ``make_replicated_sharded_segment`` where the geometry is refused."""
    if not fs.replicas:
        raise ValueError("replica_blocks: a replica-batched state")
    rows = _rows(mesh)
    per = _blocks(fs.replicas, rows)
    n = fs.replicas // len(rows)
    return [_on(stack_fast([replica(fs, r) for r in range(b * n,
                                                          (b + 1) * n)]),
                per[b * n][0]) for b in range(len(rows))]


def _shard_reason(sim, mesh):
    """None where the slab stencil runs on ``mesh``, else why not
    (spatial.py:92-98): the f32 rule, then ``shardable``."""
    system = sim.system
    if system.dtype != "float32":
        return "sharded stencil is the f32 path"
    return shardable(system, fast_maps(system), mesh)


def _fallback(sim, device):
    """The reference's fallback (spatial.py:105-107): the non-reactive
    chain, on whole FastStates on ``device``."""
    chain, _ = make_fast_segment(sim, pallas=False, reactive=False,
                                 device=device)

    def segment(fs, step0: int, length: int, run_begin: int, run_end: int):
        if isinstance(fs, ShardedFastState):
            raise TypeError("the refused geometry's fallback runs a whole "
                            "FastState (gather_fast_state)")
        return chain(fs, step0, length, run_begin, run_end)

    return segment


def make_sharded_segment(sim, mesh):
    """The reactive chain segment (``make_fast_segment(pallas=False)``,
    spatial.py:103-104) on the slab-resident state: ``segment(sfs, step0,
    length, run_begin, run_end)`` advances a ShardedFastState over a row
    of ``len(mesh)`` devices (``shard_fast_state``) in place; a whole
    FastState raises TypeError.  Where the geometry does not admit the
    slab stencil, the unsharded chain with the static rebuild schedule
    (``reactive=False``, spatial.py:105-107) on a whole FastState on
    ``mesh[0]``.  The segment's ``kernel_fn`` is the slab stencil on whole
    planes (``make_sharded_kernel``), for ``to_fast`` (None on the
    fallback: select_kernel's), and ``shard_reason`` None or why the slab
    stencil was refused.  The Langevin ``zero`` and ``group`` options ride
    along (the group plane comes from ``to_fast``'s ``groups``)."""
    from .slab_step import make_slab_segment

    reason = _shard_reason(sim, mesh)
    if reason:
        segment = _fallback(sim, torch.device(mesh[0]))
        segment.kernel_fn = None
    else:
        segment = make_slab_segment(sim, mesh)
    segment.shard_reason = reason
    return segment


def make_replicated_sharded_segment(sim, mesh):
    """Replicas x slabs (spatial.py:124-227) on a dp x sp ``mesh`` (a
    sequence of dp rows of sp devices; a flat sequence is one row):
    ``segment(runs, step0, length, run_begin, run_end)`` advances the
    replicas in place and returns them.

    Where the slab stencil is admitted, ``runs`` is ``shard_fast_state``'s
    list of one-run ShardedFastStates of a replica-batched state, each on
    its row's devices; each steps on the slab segment with its own skin
    trigger and rebuild count (the reference's ``jax.lax.map`` inside its
    dp shard_map, spatial.py:171-204), step i issued for every replica
    before step i + 1.  Elsewhere ``runs`` is ``replica_blocks``' list,
    each row's block a replica-batched FastState on the row's first
    device, on the batched non-reactive chain (spatial.py:206-227).
    ``shard_reason``: None, or why the slab stencil was refused
    (spatial.py:203, 226)."""
    rows = _rows(mesh)
    reason = _shard_reason(sim, rows[0])
    if reason:
        chains = [_fallback(sim, row[0]) for row in rows]

        def segment(runs, step0: int, length: int, run_begin: int,
                    run_end: int):
            if len(runs) != len(rows):
                raise ValueError(f"{len(runs)} replica blocks on {len(rows)} "
                                 f"rows (replica_blocks)")
            for chain, block in zip(chains, runs):
                chain(block, step0, length, run_begin, run_end)
            return runs

        segment.kernel_fn = None
    else:
        one = make_sharded_segment(sim, rows[0])

        def segment(runs, step0: int, length: int, run_begin: int,
                    run_end: int):
            for i in range(length):
                for sfs in runs:
                    one(sfs, step0 + i, 1, run_begin, run_end)
            return runs

        segment.kernel_fn = one.kernel_fn
    segment.shard_reason = reason
    return segment
