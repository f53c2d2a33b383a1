"""Observers (``lammps_le_tpu/observe``), plain PyTorch on the state's
device unless a line says otherwise: the pressure of a State, per-atom
pe/stress/coordination (``peratom``), the host pair enumeration of
``compute pair/local`` and ``group/group`` (``pairs``, numpy), g(r)
(``rdf``), contact maps (``contact_map``) and the section timing report
(``profile``)."""

from . import pairs  # noqa: F401
from .pressure import make_pressure_fn  # noqa: F401
from .contact_map import contact_map_accumulate, make_contact_fn  # noqa: F401
from .peratom import (make_coord_atom_fn, make_peratom_pe_fn,  # noqa: F401
                      make_stress_atom_fn)
from .profile import profile  # noqa: F401
from .rdf import make_rdf_fn, normalize_rdf  # noqa: F401
