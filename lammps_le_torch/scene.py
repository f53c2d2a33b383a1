"""Scene generation: FENE bead-spring melts and chromosome chains.

A copy of ``lammps_le_tpu/scene.py`` (``fene_melt``, ``serpentine``,
``chromosome``: same arguments, same draws from the same seed), so that
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from .io.data import DataFile


def fene_melt(
    n_chains: int,
    chain_len: int,
    density: float = 0.8442,
    bond_len: float = 0.97,
    seed: int = 12345,
    n_atom_types: int = 1,
    n_bond_types: int = 1,
    atom_type: int = 1,
    bond_type: int = 1,
) -> DataFile:
    """Random-walk FENE chains in a cubic box at the given reduced density."""
    n = n_chains * chain_len
    rng = np.random.default_rng(seed)
    box_l = (n / density) ** (1.0 / 3.0)
    x = np.zeros((n, 3))
    molecule = np.zeros(n, np.int32)
    off = 0
    for c in range(n_chains):
        molecule[off : off + chain_len] = c
        x[off] = rng.uniform(0.0, box_l, 3)
        steps = rng.normal(size=(chain_len - 1, 3))
        steps *= bond_len / np.linalg.norm(steps, axis=1, keepdims=True)
        x[off + 1 : off + chain_len] = x[off] + np.cumsum(steps, axis=0)
        off += chain_len
    image = np.floor(x / box_l).astype(np.int32)
    x = x - image * box_l

    bonds = np.zeros((n - n_chains, 3), np.int64)
    k = 0
    off = 0
    for c in range(n_chains):
        for i in range(chain_len - 1):
            bonds[k] = (bond_type - 1, off + i, off + i + 1)
            k += 1
        off += chain_len
    return DataFile(
        n_atoms=n,
        n_bonds=len(bonds),
        n_atom_types=n_atom_types,
        n_bond_types=n_bond_types,
        box_lo=(0.0, 0.0, 0.0),
        box_hi=(box_l, box_l, box_l),
        masses=np.ones(n_atom_types),
        x=x,
        v=None,
        types=np.full(n, atom_type - 1, np.int32),
        molecule=molecule,
        image=np.zeros((n, 3), np.int32),
        bonds=bonds,
    )


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


def chromosome(
    n_beads: int,
    density: float = 0.1,
    bond_len: float = 0.97,
    seed: int = 12345,
    n_atom_types: int = 4,
    n_bond_types: int = 2,
    barrier_fraction: float = 0.0,
    barrier_types=(2, 3, 4),
    barrier_seed: int = 777,
) -> DataFile:
    """Single self-avoiding-ish random-walk chain (the LE substrate).

    Optionally sprinkles CTCF barrier bead types (left/right/bidirectional)
    at the given fraction, mimicking the README deck's barrier setup.
    """
    data = fene_melt(
        1,
        n_beads,
        density=density,
        bond_len=bond_len,
        seed=seed,
        n_atom_types=n_atom_types,
        n_bond_types=n_bond_types,
    )
    if barrier_fraction > 0:
        rng = np.random.default_rng(barrier_seed)
        nbar = int(n_beads * barrier_fraction)
        ids = rng.choice(n_beads, size=nbar, replace=False)
        kinds = rng.choice(np.asarray(barrier_types) - 1, size=nbar)
        data.types[ids] = kinds
    return data
