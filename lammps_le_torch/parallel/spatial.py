"""Spatial (sp) decomposition of the fast engine's cell planes: the
counterpart of ``lammps_le_tpu/parallel/spatial.py``.

The flat cell order is x-major, so contiguous column ranges are x-slabs,
the geometry of the reference's bricks (comm_brick.cpp:150-700).  The
stencil runs per slab (``shard_step.make_sharded_kernel``); placement, LE
events and the per-bead arrays stay whole, as the reference replicates
them.  The reference's jax sharding layout (``fast_state_specs``,
``shard_fast_state``) has no counterpart here: the FastState stays whole
on one device.
"""

from __future__ import annotations

from ..fast.engine import make_fast_segment
from ..fast.maps import fast_maps
from .shard_step import make_sharded_kernel, shardable


def make_sharded_segment(sim, mesh):
    """The reactive segment (``make_fast_segment``) on the slab stencil of
    ``mesh`` (one ``torch.device`` per slab), with the FastState on
    ``mesh[0]`` (spatial.py:69-121).  The segment's
    ``kernel_fn`` is its stencil, for ``to_fast``.

    Where the geometry does not admit the slab stencil the reference falls
    back to the unsharded chain with static cadence (``reactive=False``),
    which the port does not have: it raises ValueError with the reason."""
    system = sim.system
    maps = fast_maps(system)
    reason = (None if system.dtype == "float32"
              else "sharded stencil is the f32 path")
    reason = reason or shardable(system, maps, mesh)
    if reason:
        raise ValueError(f"sharded stencil unavailable: {reason} (the "
                         f"reference's reactive=False fallback is not "
                         f"ported)")
    kernel_fn = make_sharded_kernel(system, maps, sim.ex_btype, mesh)
    segment = make_fast_segment(sim, mesh[0], kernel_fn)
    segment.kernel_fn = kernel_fn
    return segment
