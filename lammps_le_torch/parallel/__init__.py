"""Spatial decomposition of the fast engine's cell planes
(``lammps_le_tpu/parallel``): the sharded slab stencil and its segment."""
