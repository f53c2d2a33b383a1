"""LAMMPS data-file reader/writer and the conversion to a System.

A copy of ``lammps_le_tpu/io/data.py``, so that the port imports nothing
of the JAX package.  It parses the subset of the format the LE workflow
uses (reference: src/read_data.cpp:511-580,917-938 — header keywords plus
Masses / Atoms / Velocities / Bonds / Angles sections, ``atom_style
bond``: id mol type x y z [ix iy iz]); sections of at least 20,000 rows go
through the native parser (``native/``) when it builds, else numpy.

The chain layout invariant of the engine — backbone bonds connect
consecutively numbered beads within a molecule — is validated here; bonds of
the extruder type can be seeded from the file into the extruder table.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..system import build_system

_HEADER_KEYS = {
    "atoms": "n_atoms",
    "bonds": "n_bonds",
    "angles": "n_angles",
    "dihedrals": "n_dihedrals",
    "impropers": "n_impropers",
    "atom types": "n_atom_types",
    "bond types": "n_bond_types",
    "angle types": "n_angle_types",
    "dihedral types": "n_dihedral_types",
    "improper types": "n_improper_types",
}

_SECTIONS = {
    "Masses",
    "Atoms",
    "Velocities",
    "Bonds",
    "Angles",
    "Dihedrals",
    "Impropers",
    "Pair Coeffs",
    "PairIJ Coeffs",
    "Bond Coeffs",
    "Angle Coeffs",
}


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


def _strip(line: str) -> str:
    i = line.find("#")
    if i >= 0:
        line = line[:i]
    return line.strip()


def read_data(path: str) -> DataFile:
    with open(path) as fh:
        lines = fh.readlines()

    hdr: Dict[str, int] = {k: 0 for k in _HEADER_KEYS.values()}
    box_lo = [0.0, 0.0, 0.0]
    box_hi = [1.0, 1.0, 1.0]

    # header: everything until the first recognized section keyword
    i = 1  # skip title line
    while i < len(lines):
        s = _strip(lines[i])
        if not s:
            i += 1
            continue
        first_words = s.split()
        section = s
        if section in _SECTIONS or section.split("#")[0].strip() in _SECTIONS:
            break
        matched = False
        for key, attr in _HEADER_KEYS.items():
            if s.endswith(key):
                hdr[attr] = int(first_words[0])
                matched = True
                break
        if not matched:
            if s.endswith("xlo xhi"):
                box_lo[0], box_hi[0] = float(first_words[0]), float(first_words[1])
            elif s.endswith("ylo yhi"):
                box_lo[1], box_hi[1] = float(first_words[0]), float(first_words[1])
            elif s.endswith("zlo zhi"):
                box_lo[2], box_hi[2] = float(first_words[0]), float(first_words[1])
            elif s.endswith("xy xz yz"):
                raise ValueError("triclinic boxes are not supported")
            # unknown header lines ignored
        i += 1

    n = hdr["n_atoms"]
    nb = hdr["n_bonds"]
    nt = max(hdr["n_atom_types"], 1)
    nbt = max(hdr["n_bond_types"], 1)

    masses = np.ones(nt)
    x = np.zeros((n, 3))
    v = None
    types = np.zeros(n, np.int32)
    molecule = np.zeros(n, np.int32)
    image = np.zeros((n, 3), np.int32)
    bonds = np.zeros((nb, 3), np.int64)
    na = hdr["n_angles"]
    angles = np.zeros((na, 4), np.int64)

    def to_array(rows, expected, cols):
        """Rows -> (expected, cols) float array, id-placed.

        Uses the native C++ parser (reference read_data.cpp's role) for
        large sections when available; numpy fallback otherwise.
        """
        if len(rows) != expected:
            raise ValueError(f"section has {len(rows)} rows, expected {expected}")
        if expected >= 20000:
            from ..native import load_fastio
            from ..native.build import parse_rows

            lib = load_fastio()
            if lib is not None:
                return parse_rows(lib, "\n".join(rows), expected, cols)
        split = [r.split() for r in rows]
        width = max(len(s) for s in split)
        arr = np.zeros((expected, cols), np.float64)
        raw = np.asarray(
            [s + ["0"] * (width - len(s)) for s in split], dtype=np.float64
        )
        take = min(width, cols)
        # id-placed like the native parser
        ids = raw[:, 0].astype(np.int64) - 1
        arr[ids, :take] = raw[:, :take]
        return arr

    def parse_section(name: str, start: int) -> int:
        j = start
        rows = []
        while j < len(lines):
            s = _strip(lines[j])
            if not s:
                if rows:
                    break
                j += 1
                continue
            if s in _SECTIONS:
                break
            rows.append(s)
            j += 1
        if name == "Masses":
            for r in rows:
                p = r.split()
                masses[int(p[0]) - 1] = float(p[1])
        elif name == "Atoms":
            # to_array id-places rows, so arr[i] is atom id i+1
            arr = to_array(rows, n, 9)
            molecule[:] = arr[:, 1].astype(np.int32) - 1
            types[:] = arr[:, 2].astype(np.int32) - 1
            x[:] = arr[:, 3:6]
            image[:] = arr[:, 6:9].astype(np.int32)
        elif name == "Velocities":
            nonlocal v
            arr = to_array(rows, n, 4)
            v = arr[:, 1:4].copy()
        elif name == "Bonds":
            arr = to_array(rows, nb, 4).astype(np.int64)
            bonds[:] = arr[:, 1:4] - 1
        elif name == "Angles":
            arr = to_array(rows, na, 5).astype(np.int64)
            angles[:] = arr[:, 1:5] - 1
        # other sections silently skipped
        return j

    while i < len(lines):
        s = _strip(lines[i])
        if not s:
            i += 1
            continue
        if s in _SECTIONS:
            i = parse_section(s, i + 1)
        else:
            i += 1

    return DataFile(
        n_atoms=n,
        n_bonds=nb,
        n_atom_types=nt,
        n_bond_types=nbt,
        box_lo=tuple(box_lo),
        box_hi=tuple(box_hi),
        masses=masses,
        x=x,
        v=v,
        types=types,
        molecule=molecule,
        image=image,
        bonds=bonds,
        n_angles=na,
        n_angle_types=hdr["n_angle_types"],
        angles=angles if na else None,
    )


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


def write_data(path: str, data: DataFile, title: str = "lammps_le_torch data file"):
    n = data.n_atoms
    with open(path, "w") as fh:
        fh.write(f"{title}\n\n")
        fh.write(f"{n} atoms\n{data.n_bonds} bonds\n")
        fh.write(f"{data.n_angles} angles\n0 dihedrals\n0 impropers\n\n")
        fh.write(f"{data.n_atom_types} atom types\n{data.n_bond_types} bond types\n")
        fh.write(f"{data.n_angle_types} angle types\n"
                 "0 dihedral types\n0 improper types\n\n")
        for ax, name in zip(range(3), ("x", "y", "z")):
            fh.write(f"{data.box_lo[ax]:.10g} {data.box_hi[ax]:.10g} "
                     f"{name}lo {name}hi\n")
        fh.write("\nMasses\n\n")
        for t in range(data.n_atom_types):
            fh.write(f"{t + 1} {data.masses[t]:.10g}\n")
        fh.write("\nAtoms\n\n")
        for i in range(n):
            fh.write(
                f"{i + 1} {data.molecule[i] + 1} {data.types[i] + 1} "
                f"{data.x[i, 0]:.10g} {data.x[i, 1]:.10g} {data.x[i, 2]:.10g} "
                f"{data.image[i, 0]} {data.image[i, 1]} {data.image[i, 2]}\n"
            )
        if data.v is not None:
            fh.write("\nVelocities\n\n")
            for i in range(n):
                fh.write(f"{i + 1} {data.v[i, 0]:.10g} {data.v[i, 1]:.10g} "
                         f"{data.v[i, 2]:.10g}\n")
        if data.n_bonds:
            fh.write("\nBonds\n\n")
            for b in range(data.n_bonds):
                bt, bi, bj = data.bonds[b]
                fh.write(f"{b + 1} {bt + 1} {bi + 1} {bj + 1}\n")
        if data.n_angles and data.angles is not None:
            fh.write("\nAngles\n\n")
            for a in range(data.n_angles):
                at, ai, aj, ak = data.angles[a]
                fh.write(f"{a + 1} {at + 1} {ai + 1} {aj + 1} {ak + 1}\n")
