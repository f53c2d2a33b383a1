"""Scene generation: the serpentine chromosome chain of bench.py's
production configuration.

A copy of ``serpentine`` from ``lammps_le_tpu/scene.py`` (same arguments,
same draws from the same seed), so that the port imports nothing of the
JAX package.  The random-walk generators (``fene_melt``, ``chromosome``)
are not ported yet.
"""

from __future__ import annotations

import numpy as np

from .io.data import DataFile


def serpentine(
    n_beads: int,
    spacing: float = 0.97,
    row_gap: float = 1.2,
    seed: int = 0,
    jitter: float = 0.02,
    n_atom_types: int = 4,
    n_bond_types: int = 2,
    barrier_fraction: float = 0.0,
    barrier_types=(2, 3, 4),
) -> DataFile:
    """Overlap-free single chain folded as a boustrophedon space-filling path.

    Minimum non-bonded distance is ``row_gap`` > sigma, so forces are finite
    from step 0 — used where the random-walk generator would need push-off
    (compile checks, micro benches).
    """
    rng = np.random.default_rng(seed)
    per_row = max(int(np.ceil(n_beads ** (1 / 3))), 2)
    rows = max(int(np.ceil(np.sqrt(n_beads / per_row))), 2)
    x = np.zeros((n_beads, 3))
    for b in range(n_beads):
        i = b % per_row
        g = b // per_row          # global row index -> x direction
        r = g % rows
        p = b // (per_row * rows)
        xi = i if g % 2 == 0 else per_row - 1 - i
        yi = r if p % 2 == 0 else rows - 1 - r
        x[b] = (xi * spacing, yi * row_gap, p * row_gap)
    x += rng.normal(scale=jitter, size=x.shape)
    planes = int(np.ceil(n_beads / (per_row * rows)))
    box_hi = (
        per_row * spacing + row_gap,
        rows * row_gap + row_gap,
        max(planes, 2) * row_gap + row_gap,
    )
    x += 0.5 * row_gap

    bonds = np.zeros((n_beads - 1, 3), np.int64)
    for i in range(n_beads - 1):
        bonds[i] = (0, i, i + 1)
    types = np.zeros(n_beads, np.int32)
    if barrier_fraction > 0:
        nbar = int(n_beads * barrier_fraction)
        ids = rng.choice(n_beads, size=nbar, replace=False)
        types[ids] = rng.choice(np.asarray(barrier_types) - 1, size=nbar)
    return DataFile(
        n_atoms=n_beads,
        n_bonds=n_beads - 1,
        n_atom_types=n_atom_types,
        n_bond_types=n_bond_types,
        box_lo=(0.0, 0.0, 0.0),
        box_hi=box_hi,
        masses=np.ones(n_atom_types),
        x=x,
        v=None,
        types=types,
        molecule=np.zeros(n_beads, np.int32),
        image=np.zeros((n_beads, 3), np.int32),
        bonds=bonds,
    )
