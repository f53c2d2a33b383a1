"""Parallel paths (``lammps_le_tpu/parallel``): the fast engine's sharded
slab stencil and its segment, and the general path's replica
ensembles."""
from .replica import (  # noqa: F401
    gather_replica_state,
    make_replica_runner,
    replicate_state,
    sharded_replica_state,
)
