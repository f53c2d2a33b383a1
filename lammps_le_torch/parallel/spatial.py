"""Spatial (sp) decomposition of the fast engine's cell planes: the
counterpart of ``lammps_le_tpu/parallel/spatial.py``.

The flat cell order is x-major, so contiguous column ranges are x-slabs,
the geometry of the reference's bricks (comm_brick.cpp:150-700).  The
stencil runs per slab (``shard_step.make_sharded_kernel``); placement, LE
events and the per-bead arrays stay whole, as the reference replicates
them.  The reference's jax sharding layout (``fast_state_specs``,
``shard_fast_state``) has no counterpart here: the FastState stays whole
on one device, and so do the replicas of ``make_replicated_sharded_
segment`` (the reference's dp axis).
"""

from __future__ import annotations

from ..fast.engine import make_fast_segment
from ..fast.maps import fast_maps
from .shard_step import make_sharded_kernel, shardable


def _shard_reason(sim, mesh):
    """None where the slab stencil runs on ``mesh``, else why not
    (spatial.py:92-98): the f32 rule, then ``shardable``."""
    system = sim.system
    if system.dtype != "float32":
        return "sharded stencil is the f32 path"
    return shardable(system, fast_maps(system), mesh)


def _slab_segment(sim, mesh):
    """The reactive chain on the slab stencil of ``mesh``, and the
    stencil."""
    kernel_fn = make_sharded_kernel(sim.system, fast_maps(sim.system),
                                    sim.ex_btype, mesh)
    segment, _ = make_fast_segment(sim, pallas=False, kernel_fn=kernel_fn,
                                   device=mesh[0])
    return segment, kernel_fn


def make_sharded_segment(sim, mesh):
    """The reactive chain segment (``make_fast_segment(pallas=False)``,
    spatial.py:103-104) on the slab stencil of ``mesh`` (one
    ``torch.device`` per slab), with the FastState on ``mesh[0]``
    (spatial.py:69-121).  Where the geometry does not admit the slab
    stencil, the unsharded chain with the static rebuild schedule
    (``reactive=False``, spatial.py:105-107).  The segment's ``kernel_fn``
    is its stencil, for ``to_fast`` (None on the fallback: select_kernel's),
    and ``shard_reason`` None or why the slab stencil was refused.
    Everything else is ``make_fast_segment``'s, the Langevin ``zero`` and
    ``group`` options included (the group plane comes from ``to_fast``'s
    ``groups``)."""
    reason = _shard_reason(sim, mesh)
    if reason:
        segment, _ = make_fast_segment(sim, pallas=False, reactive=False,
                                       device=mesh[0])
        kernel_fn = None
    else:
        segment, kernel_fn = _slab_segment(sim, mesh)
    segment.kernel_fn = kernel_fn
    segment.shard_reason = reason
    return segment


def make_replicated_sharded_segment(sim, mesh):
    """Replicas x slabs (spatial.py:124-227), every replica and slab of
    ``mesh`` on ``mesh[0]``'s card: ``segment(runs, step0, length,
    run_begin, run_end)`` advances the replicas in place and returns them.

    Where the slab stencil is admitted, ``runs`` is a sequence of one
    run's FastStates, each stepped in turn on the reactive slab segment
    (the reference's ``jax.lax.map`` over the replicas, its stencil one
    run at a time), each with its own skin trigger and rebuild count:
    ``stack_fast`` them where they agree.  Elsewhere ``runs`` is one
    replica-batched FastState (``stack_fast``) on the non-reactive chain
    (the reference's vmapped fallback).  ``shard_reason``: None, or why
    the slab stencil was refused (spatial.py:203, 226)."""
    reason = _shard_reason(sim, mesh)
    if reason:
        segment, _ = make_fast_segment(sim, pallas=False, reactive=False,
                                       device=mesh[0])
        segment.shard_reason = reason
        return segment
    one, kernel_fn = _slab_segment(sim, mesh)

    def segment(runs, step0: int, length: int, run_begin: int,
                run_end: int):
        for fs in runs:
            one(fs, step0, length, run_begin, run_end)
        return runs

    segment.kernel_fn = kernel_fn
    segment.shard_reason = None
    return segment
