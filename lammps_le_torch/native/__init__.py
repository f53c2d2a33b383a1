"""Native (C++) host runtime components, loaded via ctypes
(``lammps_le_tpu/native``): bulk data-file parsing.  Everything degrades
to numpy when the shared library cannot be built."""

from .build import load_fastio  # noqa: F401
