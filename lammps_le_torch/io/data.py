"""The data-file description of a system and its conversion to a System.

A copy of the in-memory part of ``lammps_le_tpu/io/data.py``
(``DataFile``, ``split_topology``, ``system_from_data``), so that the port
imports nothing of the JAX package.  Reading and writing LAMMPS data files
is not ported yet.

The chain layout invariant of the engine — backbone bonds connect
consecutively numbered beads within a molecule — is validated here; bonds of
the extruder type can be seeded from the file into the extruder table.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..system import build_system


@dataclasses.dataclass
class DataFile:
    n_atoms: int
    n_bonds: int
    n_atom_types: int
    n_bond_types: int
    box_lo: Tuple[float, float, float]
    box_hi: Tuple[float, float, float]
    masses: np.ndarray          # (n_atom_types,)
    x: np.ndarray               # (N, 3) sorted by atom id
    v: Optional[np.ndarray]     # (N, 3) or None
    types: np.ndarray           # (N,) 0-based
    molecule: np.ndarray        # (N,) 0-based
    image: np.ndarray           # (N, 3) int
    bonds: np.ndarray           # (B, 3): type(0-based), i, j (0-based ids)
    n_angles: int = 0
    n_angle_types: int = 0
    angles: Optional[np.ndarray] = None  # (A, 4): type, i, j, k (0-based)


def split_topology(data: DataFile, ex_btype: int = -1):
    """Separate backbone chain bonds from extruder-type bonds.

    Returns (next_bead, prev_bead, backbone_type, extruder_pairs).
    Backbone bonds must connect consecutive beads (j == i + 1) — the chain
    layout invariant; anything else must be of the extruder type.
    """
    n = data.n_atoms
    next_bead = np.full(n, -1, np.int32)
    prev_bead = np.full(n, -1, np.int32)
    backbone_type = np.full(n, -1, np.int32)
    ex_pairs = []
    for bt, bi, bj in data.bonds:
        i, j = (bi, bj) if bi < bj else (bj, bi)
        if ex_btype > 0 and bt == ex_btype - 1:
            ex_pairs.append((i, j))
            continue
        if j != i + 1:
            raise ValueError(
                f"bond ({i + 1},{j + 1}) type {bt + 1} is not a consecutive "
                "backbone bond; only extruder-type bonds may be non-local"
            )
        if data.molecule[i] != data.molecule[j]:
            raise ValueError(f"backbone bond ({i + 1},{j + 1}) crosses molecules")
        next_bead[i] = j
        prev_bead[j] = i
        backbone_type[i] = bt
    return next_bead, prev_bead, backbone_type, np.asarray(ex_pairs, np.int32)


def system_from_data(
    data: DataFile,
    *,
    pair=None,
    bonds=None,
    special_lj=(0.0, 1.0, 1.0),
    units: str = "lj",
    ex_btype: int = -1,
    max_extruders: int = 0,
    dtype: str = "float32",
    **neighbor_kw,
):
    """Build a System (+ optional seed extruder pairs) from a data file."""
    next_bead, prev_bead, backbone_type, ex_pairs = split_topology(data, ex_btype)
    angle_center = None
    if data.angles is not None and data.n_angles:
        # validate the chain-triplet invariant and encode at the center
        # bead (System.angle_center_type); arbitrary non-chain triplets
        # are out of the engine's implicit-topology scope
        a = np.asarray(data.angles, np.int64)
        if not (np.all(a[:, 2] - a[:, 1] == 1)
                and np.all(a[:, 3] - a[:, 2] == 1)):
            raise ValueError(
                "Angles must be consecutive chain triplets (i-1, i, i+1)")
        # both arms must be real backbone bonds — an angle spanning a
        # chain break would otherwise be silently zeroed by the force
        # pass's prev/next mask (reference LAMMPS computes such an angle,
        # so accepting it silently would be a parity hole)
        if not (np.all(next_bead[a[:, 1]] == a[:, 2])
                and np.all(next_bead[a[:, 2]] == a[:, 3])):
            raise ValueError(
                "Angles must span existing backbone bonds (a triplet "
                "crosses a chain break)")
        angle_center = np.full(data.n_atoms, -1, np.int32)
        angle_center[a[:, 2]] = a[:, 0].astype(np.int32)
    system = build_system(
        n=data.n_atoms,
        n_types=data.n_atom_types,
        box_lo=data.box_lo,
        box_hi=data.box_hi,
        next_bead=next_bead,
        prev_bead=prev_bead,
        molecule=data.molecule,
        backbone_type=backbone_type,
        masses=data.masses,
        pair=pair,
        bonds=bonds,
        angle_center_type=angle_center,
        special_lj=special_lj,
        units=units,
        max_extruders=max(max_extruders, len(ex_pairs)),
        dtype=dtype,
        **neighbor_kw,
    )
    return system, ex_pairs
