"""Static simulation description: box, topology, force-field parameters.

A copy of ``lammps_le_tpu/system.py`` with the same classes, fields,
defaults and grid choice, so that the port imports nothing of the JAX
package.  :class:`System` is everything static for a run (box geometry,
chain topology, per-type force-field tables, neighbor-grid geometry);
:class:`lammps_le_torch.state.State` holds the dynamic tensors.

The polymer backbone is stored as implicit chain order: bead ``i`` bonds to
``next[i]`` (or -1 at a chain end).  This is the 1-D analog of the
reference's per-atom bond tables (reference: src/atom.h:92-94) and lets bond
forces be computed with shifts instead of gathers/scatters.  Dynamic
(extruder) bonds live in a fixed-shape table on the State.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .units import Units, get_units

# Bond style codes (per bond type).
BOND_NONE = 0
BOND_FENE = 1
BOND_HARMONIC = 2

_BOND_STYLE_CODES = {"fene": BOND_FENE, "harmonic": BOND_HARMONIC}


@dataclasses.dataclass(frozen=True)
class NeighborConfig:
    """Static geometry of the cell grid and verlet list.

    The reference rebuilds neighbor lists when any atom moved more than half
    the skin (reference: src/neighbor.cpp:1933-1962).  Data-dependent rebuild
    cadence does not fit a single compiled ``lax.scan``; instead we rebuild on
    a fixed interval ``rebuild_every`` and carry an overflow/stale flag in the
    State that records whether the half-skin criterion was ever violated, so
    runs can assert safety after the fact.
    """

    skin: float = 0.4
    cell_size: float = 1.52        # >= max cutoff + skin
    nx: int = 1
    ny: int = 1
    nz: int = 1
    cell_cap: int = 8              # max beads per cell
    max_neighbors: int = 32        # verlet list width (full list, both i<j and i>j)
    rebuild_every: int = 1
    use_cells: bool = True         # False => O(N^2) bruteforce (small systems)
    # 'grid' = dense cell-grid stencil (TPU-native, no big gathers);
    # 'verlet' = compacted (N, K) list (CPU/testing reference path)
    mode: str = "grid"


@dataclasses.dataclass(frozen=True)
class PairLJCut:
    """``pair_style lj/cut`` tables (reference: src/pair_lj_cut.cpp:68-141).

    Arrays indexed by 0-based atom type: epsilon/sigma/cutoff are (T, T).
    ``shift`` mirrors ``pair_modify shift yes``.
    """

    epsilon: np.ndarray
    sigma: np.ndarray
    cutoff: np.ndarray
    shift: bool = False

    @property
    def max_cutoff(self) -> float:
        return float(np.max(self.cutoff))


@dataclasses.dataclass(frozen=True)
class BondParams:
    """Per-bond-type coefficients.

    ``style`` is one of the BOND_* codes.  Coefficient layout:
      fene:      k, r0, epsilon, sigma   (reference: src/MOLECULE/bond_fene.cpp)
      harmonic:  k, r0                   (reference: src/MOLECULE/bond_harmonic.cpp)
    Stored in a dense (n_bond_types, 4) array.
    """

    style: np.ndarray   # (n_bond_types,) int
    coeffs: np.ndarray  # (n_bond_types, 4) float


ANGLE_HARMONIC = 1
ANGLE_COSINE = 2


@dataclasses.dataclass(frozen=True)
class AngleParams:
    """Per-angle-type coefficients.

    ``style`` is one of the ANGLE_* codes.  Coefficient layout:
      harmonic: k, theta0 (RADIANS — the deck converts from degrees,
                reference: src/MOLECULE/angle_harmonic.cpp coeff())
      cosine:   k         (E = k (1 + cos theta),
                reference: src/MOLECULE/angle_cosine.cpp)
    """

    style: np.ndarray   # (n_angle_types,) int
    coeffs: np.ndarray  # (n_angle_types, 2) float


@dataclasses.dataclass(frozen=True)
class System:
    """Immutable description of one simulation problem."""

    n: int                                # beads
    n_types: int
    box_lo: Tuple[float, float, float]
    box_hi: Tuple[float, float, float]
    units: Units

    # Chain topology (numpy; converted to device constants by kernels).
    next_bead: np.ndarray                 # (N,) int32, -1 at chain end
    prev_bead: np.ndarray                 # (N,) int32, -1 at chain start
    molecule: np.ndarray                  # (N,) int32
    backbone_type: np.ndarray             # (N,) int32 bond type of bond (i, next[i]); -1 if none
    masses: np.ndarray                    # (n_types,) float

    pair: Optional[PairLJCut] = None
    bonds: Optional[BondParams] = None
    # chain bending: explicit Angles validated to be consecutive triplets
    # (i-1, i, i+1) and stored as the angle type at the CENTER bead
    # (-1 = none) — the shift-friendly encoding of the reference's
    # anglelist (src/MOLECULE/atom_vec_angle.cpp).  General engine only.
    angles: Optional[AngleParams] = None
    angle_center_type: Optional[np.ndarray] = None  # (N,) int32, -1 none

    # special_bonds lj coefficients for 1-2/1-3/1-4 (reference:
    # src/force.cpp:748-800; ``special_bonds fene`` = 0,1,1).
    special_lj: Tuple[float, float, float] = (0.0, 1.0, 1.0)

    neighbor: NeighborConfig = NeighborConfig()

    # Extruder table capacity (padded slots in State.ex_left/ex_right).
    max_extruders: int = 0

    dtype: str = "float32"

    @property
    def box_size(self) -> Tuple[float, float, float]:
        return tuple(h - l for l, h in zip(self.box_lo, self.box_hi))

    def with_neighbor(self, **kw) -> "System":
        return dataclasses.replace(
            self, neighbor=dataclasses.replace(self.neighbor, **kw)
        )

    def replace(self, **kw) -> "System":
        return dataclasses.replace(self, **kw)


def bond_style_code(name: str) -> int:
    try:
        return _BOND_STYLE_CODES[name]
    except KeyError:
        raise ValueError(f"unsupported bond style {name!r}") from None


def make_neighbor_config(
    box_size: Tuple[float, float, float],
    max_cutoff: float,
    skin: float = 0.4,
    cell_cap: int = 8,
    max_neighbors: int = 32,
    rebuild_every: int = 1,
    mode: str = "grid",
    min_cell: float = 0.0,
) -> NeighborConfig:
    """Choose a static cell grid for the box.

    The cell edge is at least ``cutoff + skin`` so a 27-cell stencil covers
    all pairs that can come within the cutoff before the next rebuild
    (standard half-skin argument, reference: src/nbin_standard.cpp:53).
    ``min_cell`` additionally floors the edge — the fast path evaluates
    backbone FENE bonds inside the same stencil, so cells must cover the
    longest bond the FENE clamp admits (r0*sqrt(0.9), bond_fene.cpp:87-92);
    a shorter cell silently loses an overstretched bond's restoring force
    and snaps the chain.
    Falls back to brute force when the box is too small for a 3x3x3 grid.
    """
    want = max(max_cutoff + skin, min_cell)
    dims = [max(int(np.floor(s / want)), 1) for s in box_size]
    use_cells = all(d >= 3 for d in dims)
    if not use_cells:
        dims = [1, 1, 1]
    cell_size = max(s / d for s, d in zip(box_size, dims))
    return NeighborConfig(
        skin=skin,
        cell_size=cell_size,
        nx=dims[0],
        ny=dims[1],
        nz=dims[2],
        cell_cap=cell_cap,
        max_neighbors=max_neighbors,
        rebuild_every=rebuild_every,
        use_cells=use_cells,
        mode=mode,
    )


def chain_topology(chain_lengths, bond_type: int = 1):
    """Build next/prev/molecule arrays for linear chains laid out contiguously.

    Equivalent topology to the generator tools/chain.f in the reference
    (FENE bead-spring chains with consecutive bead ids per molecule).
    """
    n = int(np.sum(chain_lengths))
    next_bead = np.full(n, -1, np.int32)
    prev_bead = np.full(n, -1, np.int32)
    molecule = np.zeros(n, np.int32)
    backbone_type = np.full(n, -1, np.int32)
    off = 0
    for mol, length in enumerate(chain_lengths):
        idx = np.arange(off, off + length)
        molecule[idx] = mol
        next_bead[idx[:-1]] = idx[1:]
        prev_bead[idx[1:]] = idx[:-1]
        backbone_type[idx[:-1]] = bond_type - 1  # 0-based bond type
        off += length
    return next_bead, prev_bead, molecule, backbone_type


def build_system(
    *,
    n: int,
    n_types: int,
    box_lo,
    box_hi,
    next_bead,
    prev_bead,
    molecule,
    backbone_type,
    masses,
    pair: Optional[PairLJCut] = None,
    bonds: Optional[BondParams] = None,
    angles: Optional[AngleParams] = None,
    angle_center_type=None,
    special_lj=(0.0, 1.0, 1.0),
    units: str = "lj",
    skin: float = 0.4,
    cell_cap: Optional[int] = None,
    max_neighbors: int = 32,
    rebuild_every: int = 1,
    max_extruders: int = 0,
    dtype: str = "float32",
    neighbor_mode: str = "grid",
) -> System:
    box_lo = tuple(float(v) for v in box_lo)
    box_hi = tuple(float(v) for v in box_hi)
    box_size = tuple(h - l for l, h in zip(box_lo, box_hi))
    max_cut = pair.max_cutoff if pair is not None else 1.0
    if cell_cap is None:
        # ~4x the mean occupancy of a (cutoff+skin) cell, floor of 8 —
        # overflow is flagged, never silent
        vol = (max_cut + skin) ** 3
        density = n / (box_size[0] * box_size[1] * box_size[2])
        cell_cap = max(8, int(np.ceil(4.0 * density * vol)))
    if neighbor_mode == "grid" and (special_lj[1] != 1.0 or special_lj[2] != 1.0):
        # grid path applies only 1-2 special weights; fall back otherwise
        neighbor_mode = "verlet"
    min_cell = 0.0
    if bonds is not None:
        st = np.asarray(bonds.style)
        co = np.asarray(bonds.coeffs)
        fene_r0 = co[st == BOND_FENE, 1]
        if fene_r0.size:
            # cover bonds up to the FENE clamp length r0*sqrt(0.9) plus 2%
            min_cell = 1.02 * np.sqrt(0.9) * float(np.max(fene_r0))
    ncfg = make_neighbor_config(
        box_size,
        max_cut,
        skin=skin,
        cell_cap=cell_cap,
        max_neighbors=max_neighbors,
        rebuild_every=rebuild_every,
        mode=neighbor_mode,
        min_cell=min_cell,
    )
    return System(
        n=int(n),
        n_types=int(n_types),
        box_lo=box_lo,
        box_hi=box_hi,
        units=get_units(units),
        next_bead=np.asarray(next_bead, np.int32),
        prev_bead=np.asarray(prev_bead, np.int32),
        molecule=np.asarray(molecule, np.int32),
        backbone_type=np.asarray(backbone_type, np.int32),
        masses=np.asarray(masses, np.float64),
        pair=pair,
        bonds=bonds,
        angles=angles,
        angle_center_type=(None if angle_center_type is None
                           else np.asarray(angle_center_type, np.int32)),
        special_lj=tuple(float(v) for v in special_lj),
        neighbor=ncfg,
        max_extruders=int(max_extruders),
        dtype=dtype,
    )
