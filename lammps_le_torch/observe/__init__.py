"""Observers (``lammps_le_tpu/observe``): the pressure of a State.  The
reference's other observers (pairs, peratom, rdf, contact_map, profile)
are not ported yet (ROADMAP Queue 1)."""
